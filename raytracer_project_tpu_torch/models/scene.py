"""Scene container + builder (twin of raytracer_project_tpu/models/scene.py).

A Scene is a NamedTuple of SoA tables; `SceneBuilder.build` assembles them
in numpy and converts every leaf to a CPU tensor once, and `Scene.to`
moves the whole scene to a device. Fog volumes (ops/volumes.py) and the
BVH (ops/bvh.py FlatBVH) are tables of their own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.tree import to_device, unflatten
from .geometry import BoxTable, GeometryBuilder, SphereTable, TriangleTable
from .materials import MaterialLibrary, MaterialTable
from .textures import TextureBank, TextureBankBuilder


class Scene(NamedTuple):
    """Frozen scene: primitive, material and texture tables, the
    closest-hit coefficient tables (ops.intersect.MMTables), the fog
    volumes (ops.volumes.VolumeTable, None without media) and the BVH
    (ops.bvh.FlatBVH, None when built without one)."""

    spheres: SphereTable
    triangles: TriangleTable
    materials: MaterialTable
    textures: TextureBank
    mm: object = None
    boxes: BoxTable | None = None
    volumes: object = None
    bvh: object = None

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
        self._volumes: list[dict] = []

    def add_fog_sphere(self, center, radius, density, color,
                       texture_id: int = -1, name: str | None = None) -> None:
        """Spherical constant-density medium (constant_medium.hpp ctor,
        scene_management.hpp:228-234); its isotropic phase material joins
        the material library."""
        mat = self.materials.isotropic(
            name or f"__fog_{len(self._volumes)}__", tuple(color), texture_id)
        self._volumes.append(dict(kind=0, center=tuple(center),
                                  radius=float(radius),
                                  box_min=(0, 0, 0), box_max=(0, 0, 0),
                                  density=float(density), mat=mat))

    def add_fog_box(self, box_min, box_max, density, color,
                    texture_id: int = -1, name: str | None = None) -> None:
        """Axis-aligned-box constant-density medium."""
        mat = self.materials.isotropic(
            name or f"__fog_{len(self._volumes)}__", tuple(color), texture_id)
        self._volumes.append(dict(kind=1, center=(0, 0, 0), radius=0.0,
                                  box_min=tuple(box_min),
                                  box_max=tuple(box_max),
                                  density=float(density), mat=mat))

    def _pack_volumes(self):
        if not self._volumes:
            return None
        from ..ops.volumes import VolumeTable

        vs = self._volumes
        mats = np.asarray([v["mat"] for v in vs], np.int32)
        tex_ids = np.asarray(self.materials.pack().texture_id)[mats]
        textured = mats[tex_ids >= 0]
        return VolumeTable(
            kind=np.asarray([v["kind"] for v in vs], np.int32),
            center=np.asarray([v["center"] for v in vs], np.float32),
            radius=np.asarray([v["radius"] for v in vs], np.float32),
            box_min=np.asarray([v["box_min"] for v in vs], np.float32),
            box_max=np.asarray([v["box_max"] for v in vs], np.float32),
            neg_inv_density=np.asarray([-1.0 / v["density"] for v in vs],
                                       np.float32),
            mat=mats,
            textured=textured if textured.size else None,
        )

    def build(self, with_bvh: bool = True) -> Scene:
        """Pack every table in numpy, build the BVH over them (with_bvh),
        then convert the scene to CPU tensors."""
        from ..ops.intersect import build_mm_tables

        spheres, triangles, boxes = self.geometry.pack()
        scene = Scene(
            spheres=spheres,
            triangles=triangles,
            boxes=boxes,
            materials=self.materials.pack(),
            textures=self.textures.pack(),
            mm=build_mm_tables(spheres, triangles, boxes),
            volumes=self._pack_volumes(),
        )
        if with_bvh:
            from ..ops import bvh as bvh_mod

            scene = scene._replace(bvh=bvh_mod.build_bvh(scene))
        return scene.to("cpu")


def scene_from_numpy(d: dict) -> Scene:
    """Scene from a flat {dotted field path: numpy array} dict, e.g.
    {"spheres.center": ..., "mm.tri_coeff": ..., "bvh.escape": ...}, such
    as the reference package's scene tables. Tables whose fields are absent
    (boxes, mm, volumes, bvh) stay None."""
    from ..ops.bvh import flat_bvh_from_numpy
    from ..ops.intersect import MMTables
    from ..ops.volumes import VolumeTable

    def fields(name):
        return {k[len(name) + 1:]: v for k, v in d.items()
                if k.startswith(name + ".")}

    def sub(cls, name):
        keys = fields(name)
        return unflatten(cls, keys) if keys else None

    bvh = fields("bvh")

    return Scene(
        spheres=sub(SphereTable, "spheres"),
        triangles=sub(TriangleTable, "triangles"),
        materials=sub(MaterialTable, "materials"),
        textures=sub(TextureBank, "textures"),
        mm=sub(MMTables, "mm"),
        boxes=sub(BoxTable, "boxes"),
        volumes=sub(VolumeTable, "volumes"),
        bvh=flat_bvh_from_numpy(bvh) if bvh else None,
    )
