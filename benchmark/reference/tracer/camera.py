"""Frozen copy of raytracer_project_tpu_torch/models/camera.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import torch

from . import rng, soa, vecmath

from .constants import degrees_to_radians

from .tree import to_device


class Camera(NamedTuple):
    """Derived camera frame: f32 [3] tensors."""

    center: torch.Tensor
    pixel00: torch.Tensor
    pixel_delta_u: torch.Tensor
    pixel_delta_v: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    defocus_disk_u: torch.Tensor
    defocus_disk_v: torch.Tensor

    def to(self, device):
        return to_device(self, device)


def make_camera(
    *,
    image_width: int,
    image_height: int,
    vfov: float = 30.0,
    lookfrom=(0.0, 0.0, 0.0),
    lookat=(0.0, 0.0, -1.0),
    vup=(0.0, 1.0, 0.0),
    defocus_angle: float = 0.0,
    focus_dist: float = 10.0,
) -> Camera:
    """Build the derived camera frame (camera.hpp:358-402 semantics)."""
    image_width = max(1, int(image_width))
    image_height = max(1, int(image_height))
    aspect = image_width / image_height

    lookfrom = np.asarray(lookfrom, np.float32)
    lookat = np.asarray(lookat, np.float32)
    vup = np.asarray(vup, np.float32)

    h = np.tan(degrees_to_radians(vfov) / 2.0)
    viewport_height = 2.0 * h * focus_dist
    viewport_width = viewport_height * aspect

    def _unit(x):
        n = np.linalg.norm(x)
        return x / n if n > 1e-12 else np.zeros_like(x)

    w = _unit(lookfrom - lookat)
    u = _unit(np.cross(vup, w))
    v = np.cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = viewport_height * -v
    pixel_delta_u = viewport_u / image_width
    pixel_delta_v = viewport_v / image_height

    viewport_upper_left = lookfrom - focus_dist * w - viewport_u / 2 - viewport_v / 2
    pixel00 = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    defocus_radius = focus_dist * np.tan(degrees_to_radians(max(defocus_angle, 0.0) / 2.0))
    if defocus_angle <= 0.0:
        defocus_radius = 0.0

    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    return Camera(
        center=f32(lookfrom),
        pixel00=f32(pixel00),
        pixel_delta_u=f32(pixel_delta_u),
        pixel_delta_v=f32(pixel_delta_v),
        u=f32(u),
        v=f32(v),
        w=f32(w),
        defocus_disk_u=f32(u * defocus_radius),
        defocus_disk_v=f32(v * defocus_radius),
    )


def pixel_rowcol_f32(pixel_ids: torch.Tensor, width: int):
    """(col, row) as f32 of row-major pixel ids < 2^24: an f32 estimate
    plus one exact integer correction, as the kernels compute it."""
    pf = pixel_ids.to(torch.float32)
    jj = torch.floor((pf + 0.5) * (1.0 / width))
    ii = pf - jj * width
    jj = torch.where(ii < 0.0, jj - 1.0, torch.where(ii >= width, jj + 1.0, jj))
    ii = pf - jj * width
    return ii, jj


def generate_rays_soa(cam: Camera, lr: rng.LaneRng, pixel_ids: torch.Tensor,
                      width: int):
    """One jittered thin-lens ray per lane: ((ox,oy,oz), (dx,dy,dz)).
    Directions are not normalized, matching the reference."""
    (jx, jy), (r0, r1) = rng.draw_camera(lr)
    ii, jj = pixel_rowcol_f32(pixel_ids, width)
    px = ii + jx
    py = jj + jy
    du, dv, p00 = cam.pixel_delta_u, cam.pixel_delta_v, cam.pixel00
    u_, v_, c_ = cam.defocus_disk_u, cam.defocus_disk_v, cam.center
    o = tuple(c_[k] + r0 * u_[k] + r1 * v_[k] for k in range(3))
    d = tuple(p00[k] + px * du[k] + py * dv[k] - o[k] for k in range(3))
    return o, d

