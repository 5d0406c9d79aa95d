"""Frozen copy of raytracer_project_tpu_torch/models/scene.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .tree import to_device

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
        from .volumes import VolumeTable

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

    def build(self) -> Scene:
        """Pack every table in numpy, then convert the scene to CPU tensors
        (the reference needs no BVH: it scans every primitive)."""
        from .intersect import build_mm_tables

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
        return scene.to("cpu")

