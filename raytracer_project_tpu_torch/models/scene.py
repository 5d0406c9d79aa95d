"""Scene container + builder (twin of raytracer_project_tpu/models/scene.py).

A Scene is a NamedTuple of SoA tables; `SceneBuilder.build` assembles them
in numpy and converts every leaf to a CPU tensor once, and `Scene.to`
moves the whole scene to a device. The BVH and participating media are
not part of this slice (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

from ..core.tree import to_device, unflatten
from .geometry import BoxTable, GeometryBuilder, SphereTable, TriangleTable
from .materials import MaterialLibrary, MaterialTable
from .textures import TextureBank, TextureBankBuilder


class Scene(NamedTuple):
    """Frozen scene: primitive, material and texture tables plus the
    closest-hit coefficient tables (ops.intersect.MMTables)."""

    spheres: SphereTable
    triangles: TriangleTable
    materials: MaterialTable
    textures: TextureBank
    mm: object = None
    boxes: BoxTable | None = None

    @property
    def primitive_count(self) -> int:
        n = self.spheres.count + self.triangles.count
        if self.boxes is not None:
            n += self.boxes.count
        return n

    def to(self, device):
        return to_device(self, device)


class SceneBuilder:
    """Host-side scene assembly mirroring scene_management.hpp workflows.

        b = SceneBuilder()
        red = b.materials.lambertian("red", (0.8, 0.1, 0.1))
        b.geometry.add_sphere((0, 1, 0), 1.0, red)
        scene = b.build()
    """

    def __init__(self):
        self.geometry = GeometryBuilder()
        self.materials = MaterialLibrary()
        self.textures = TextureBankBuilder()

    def add_fog_sphere(self, *args, **kwargs):
        raise NotImplementedError(
            "fog (constant media) is not ported yet: ROADMAP queue 1, "
            "fused features (AOVs, spec passes, fog)")

    add_fog_box = add_fog_sphere

    def build(self, with_bvh: bool = False) -> Scene:
        """Pack every table in numpy, then convert the scene to CPU tensors."""
        if with_bvh:
            raise NotImplementedError(
                "the BVH is not ported yet: ROADMAP queue 1, BVH")
        from ..ops.intersect import build_mm_tables

        spheres, triangles, boxes = self.geometry.pack()
        scene = Scene(
            spheres=spheres,
            triangles=triangles,
            boxes=boxes,
            materials=self.materials.pack(),
            textures=self.textures.pack(),
            mm=build_mm_tables(spheres, triangles, boxes),
        )
        return scene.to("cpu")


def scene_from_numpy(d: dict) -> Scene:
    """Scene from a flat {dotted field path: numpy array} dict, e.g.
    {"spheres.center": ..., "mm.tri_coeff": ...}. Tables whose fields are
    absent (boxes, mm) stay None."""
    from ..ops.intersect import MMTables

    def sub(cls, name):
        keys = {k[len(name) + 1:]: v for k, v in d.items()
                if k.startswith(name + ".")}
        return unflatten(cls, keys) if keys else None

    return Scene(
        spheres=sub(SphereTable, "spheres"),
        triangles=sub(TriangleTable, "triangles"),
        materials=sub(MaterialTable, "materials"),
        textures=sub(TextureBank, "textures"),
        mm=sub(MMTables, "mm"),
        boxes=sub(BoxTable, "boxes"),
    )
