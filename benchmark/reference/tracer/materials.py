"""Frozen copy of raytracer_project_tpu_torch/models/materials.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

import dataclasses

from typing import NamedTuple

import numpy as np

import torch

from .tree import to_device


LAMBERTIAN = 0   # material.hpp:58


METAL = 1        # material.hpp:111


DIELECTRIC = 2   # material.hpp:166


EMISSIVE = 3     # material.hpp:245 (diffuse_light)


ISOTROPIC = 4    # constant_medium.hpp:9-22


NUM_MATERIAL_TYPES = 5


NO_TEXTURE = -1


class MaterialTable(NamedTuple):
    """Packed material parameters, one row per material.

      mtype         i32[M]   type tag
      albedo        f32[M,3] solid albedo / emitted radiance
      param         f32[M]   metal fuzz (<= 1) or dielectric index
      texture_id    i32[M]   TextureBank index, NO_TEXTURE for solid
      bump_id       i32[M]   bump-map texture index, NO_TEXTURE for none
      bump_strength f32[M]   bump gradient scale (material.hpp:48-49)
    """

    mtype: torch.Tensor
    albedo: torch.Tensor
    param: torch.Tensor
    texture_id: torch.Tensor
    bump_id: torch.Tensor
    bump_strength: torch.Tensor

    @property
    def count(self) -> int:
        return self.mtype.shape[0]

    def to(self, device):
        return to_device(self, device)


@dataclasses.dataclass
class MaterialSpec:
    """Host-side material description before packing."""

    mtype: int
    albedo: tuple = (0.0, 0.0, 0.0)
    param: float = 0.0
    texture_id: int = NO_TEXTURE
    bump_id: int = NO_TEXTURE
    bump_strength: float = 1.0


class MaterialLibrary:
    """Name -> material registry (material_library.hpp:10-65).

    Re-registering a name overwrites the row and keeps its id, as the
    reference's map does (scene_management.hpp:60,65)."""

    def __init__(self):
        self._specs: list[MaterialSpec] = []
        self._by_name: dict[str, int] = {}

    def add(self, name: str, spec: MaterialSpec) -> int:
        if name in self._by_name:
            mid = self._by_name[name]
            self._specs[mid] = spec
            return mid
        mid = len(self._specs)
        self._specs.append(spec)
        self._by_name[name] = mid
        return mid

    def add_anonymous(self, spec: MaterialSpec) -> int:
        mid = len(self._specs)
        self._specs.append(spec)
        return mid

    def get(self, name: str) -> int:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def lambertian(self, name, albedo=(1.0, 1.0, 1.0), texture_id=NO_TEXTURE,
                   bump_id=NO_TEXTURE, bump_strength=1.0) -> int:
        return self.add(name, MaterialSpec(LAMBERTIAN, tuple(albedo), 0.0,
                                           texture_id, bump_id, bump_strength))

    def metal(self, name, albedo=(1.0, 1.0, 1.0), fuzz=0.0, texture_id=NO_TEXTURE,
              bump_id=NO_TEXTURE, bump_strength=1.0) -> int:
        return self.add(name, MaterialSpec(METAL, tuple(albedo), min(fuzz, 1.0),
                                           texture_id, bump_id, bump_strength))

    def dielectric(self, name, ior=1.5, albedo=(1.0, 1.0, 1.0),
                   bump_id=NO_TEXTURE, bump_strength=1.0) -> int:
        return self.add(name, MaterialSpec(DIELECTRIC, tuple(albedo), ior,
                                           NO_TEXTURE, bump_id, bump_strength))

    def diffuse_light(self, name, emit=(1.0, 1.0, 1.0)) -> int:
        return self.add(name, MaterialSpec(EMISSIVE, tuple(emit), 0.0))

    def isotropic(self, name, albedo=(1.0, 1.0, 1.0), texture_id=NO_TEXTURE) -> int:
        return self.add(name, MaterialSpec(ISOTROPIC, tuple(albedo), 0.0, texture_id))

    # Name-substring filters (material_library.hpp:42-64).

    def get_emissive_names(self) -> list[str]:
        return [n for n in self._by_name
                if "neon" in n.lower() or "emissive" in n.lower()]

    def get_regular_names(self) -> list[str]:
        emissive = set(self.get_emissive_names())
        return [n for n in self._by_name if n not in emissive]

    def pack(self) -> MaterialTable:
        """numpy-backed table; SceneBuilder.build converts it to tensors."""
        specs = self._specs or [MaterialSpec(LAMBERTIAN, (1.0, 0.0, 1.0))]
        return MaterialTable(
            mtype=np.asarray([s.mtype for s in specs], np.int32),
            albedo=np.asarray([s.albedo for s in specs], np.float32),
            param=np.asarray([s.param for s in specs], np.float32),
            texture_id=np.asarray([s.texture_id for s in specs], np.int32),
            bump_id=np.asarray([s.bump_id for s in specs], np.int32),
            bump_strength=np.asarray([s.bump_strength for s in specs], np.float32),
        )

