"""Batched 3-vector math on trailing-dim-3 tensors (twin of
raytracer_project_tpu/core/vecmath.py, forward-only subset).

`atan2_poly` and `acos_poly` are the polynomial arcs the fused kernels use
in place of atan2/acos; the CUDA kernels (csrc/common.cuh) carry the same
coefficients and operation order. `fma` copies the fused multiply-adds of
the reference's compiled arithmetic where paths are sensitive to them.
"""

from __future__ import annotations

import torch

from .constants import PI

# Guard used by the reference's unit_vector (vec3.hpp:165-171).
_UNIT_EPS = 1e-8


def fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add: the product is exact
    in f64 and the sum is rounded to f64 and then to f32, which differs
    from a true f32 fma only when that double rounding meets a tie."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def safe_sqrt(x):
    """sqrt(x) where x > 0, else 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def length(v):
    return safe_sqrt((v * v).sum(-1, keepdim=True))


def normalize(v):
    """Safe unit vector: 0 for (near-)zero input (vec3.hpp:165-171)."""
    len_ = length(v)
    return torch.where(len_ < _UNIT_EPS, 0.0,
                       v / torch.clamp(len_, min=_UNIT_EPS))


def smoothstep(edge0, edge1, x):
    """Hermite smoothstep (common.hpp:87-91)."""
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def atan2_poly(y, x):
    """Polynomial arctan2 (add/mul/select only): minimax odd degree-11 on
    [0, 1] plus octant reduction, max error ~1e-5 rad."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / torch.clamp(hi, min=1e-30)
    z2 = z * z
    a = z * (0.99997726 + z2 * (-0.33262347 + z2 * (0.19354346
        + z2 * (-0.11643287 + z2 * (0.05265332 + z2 * -0.01172120)))))
    a = torch.where(ay > ax, 0.5 * PI - a, a)
    a = torch.where(x < 0.0, PI - a, a)
    return torch.where(y < 0.0, -a, a)


def acos_poly(x):
    """Polynomial arccos via atan2_poly(sqrt(1-x^2), x), clamped to [-1, 1]."""
    xc = torch.clamp(x, -1.0, 1.0)
    s = torch.sqrt(torch.clamp(1.0 - xc * xc, min=0.0))
    return atan2_poly(s, xc)
