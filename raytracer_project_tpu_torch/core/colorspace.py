"""Colour-space transforms (twin of raytracer_project_tpu/core/colorspace.py):
ACES fit, gamma, NaN scrubbing (common.hpp:48-91). Differentiable torch ops
on tensors of any shape, typically [..., 3] linear RGB."""

from __future__ import annotations

import torch

GAMMA = 2.2


def scrub_non_finite(x, replace: float = 0.0):
    """NaN and inf -> `replace` (common.hpp:50-55)."""
    return torch.where(torch.isfinite(x), x, replace)


def apply_aces(x):
    """Narkowicz ACES filmic fit with the NaN killer (common.hpp:48-67)."""
    v = torch.clamp(scrub_non_finite(x), min=0.0)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return (v * (a * v + b)) / (v * (c * v + d) + e)


def linear_to_gamma(x):
    """Linear -> gamma 2.2, negatives to 0 (common.hpp:70-84)."""
    return torch.where(x > 0.0, torch.pow(torch.clamp(x, min=1e-12), 1.0 / GAMMA),
                       0.0)


def gamma_to_linear(x):
    return torch.where(x > 0.0, torch.pow(torch.clamp(x, min=1e-12), GAMMA), 0.0)


def to_srgb_u8(img):
    """Linear image -> uint8 gamma-encoded pixels for PNG export: clamp to
    [0, 1], gamma 2.2, scale by 255.999 (camera.hpp:771-777)."""
    g = linear_to_gamma(torch.clamp(scrub_non_finite(img), 0.0, 1.0))
    return torch.clamp(g * 255.999, 0.0, 255.0).to(torch.uint8)
