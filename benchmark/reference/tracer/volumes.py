"""Frozen copy of raytracer_project_tpu_torch/ops/volumes.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .tree import to_device



VOL_SPHERE = 0


VOL_BOX = 1


class VolumeTable(NamedTuple):
    """V fog volumes.

    kind            i32[V]   VOL_SPHERE / VOL_BOX
    center          f32[V,3] sphere center (box: unused)
    radius          f32[V]   sphere radius
    box_min/box_max f32[V,3] AABB boundary (sphere: unused)
    neg_inv_density f32[V]   -1/density (constant_medium.hpp:29)
    mat             i32[V]   ISOTROPIC material row (phase function + albedo)
    textured        None, or i32 ids of the phase materials that carry a
                    texture (the fused pool takes solid-albedo fog only)
    """

    kind: torch.Tensor
    center: torch.Tensor
    radius: torch.Tensor
    box_min: torch.Tensor
    box_max: torch.Tensor
    neg_inv_density: torch.Tensor
    mat: torch.Tensor
    textured: object = None

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    def to(self, device):
        return to_device(self, device)

