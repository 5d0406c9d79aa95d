"""Frozen copy of raytracer_project_tpu_torch/models/environment.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

import os

from typing import NamedTuple

import numpy as np

import torch

from . import soa, vecmath

from .constants import PI

from .tree import to_device


PHYSICAL_SUN = 0


HDR_MAP = 1


SOLID_COLOR = 2


class Environment(NamedTuple):
    """Environment parameters (f32 tensors). hdr_image is an equirect
    [H, W, 3] linear-radiance map, a 1x1 black placeholder when unused."""

    background_color: torch.Tensor  # [3]
    intensity: torch.Tensor         # []
    hdr_image: torch.Tensor         # [H, W, 3]
    hdri_rotation: torch.Tensor     # [] yaw, radians
    hdri_tilt: torch.Tensor         # [] pitch, radians
    hdri_roll: torch.Tensor         # [] roll, radians
    sun_direction: torch.Tensor     # [3]
    sun_color: torch.Tensor         # [3]
    sun_intensity: torch.Tensor     # []
    sun_size: torch.Tensor          # [] UI scale 0.1..10 (camera.hpp:914)

    def to(self, device):
        return to_device(self, device)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def make_environment(
    *,
    background_color=(0.5, 0.7, 1.0),
    intensity=1.0,
    hdr_image=None,
    hdri_rotation=0.0,
    hdri_tilt=0.0,
    hdri_roll=0.0,
    sun_direction=(0.5, 0.8, 0.3),
    sun_color=(1.0, 0.95, 0.9),
    sun_intensity=5.0,
    sun_size=1.0,
) -> Environment:
    if hdr_image is None:
        hdr_image = np.zeros((1, 1, 3), np.float32)  # black fallback
    return Environment(
        background_color=_f32(background_color),
        intensity=_f32(intensity),
        hdr_image=_f32(hdr_image),
        hdri_rotation=_f32(hdri_rotation),
        hdri_tilt=_f32(hdri_tilt),
        hdri_roll=_f32(hdri_roll),
        sun_direction=_f32(sun_direction),
        sun_color=_f32(sun_color),
        sun_intensity=_f32(sun_intensity),
        sun_size=_f32(sun_size),
    )

