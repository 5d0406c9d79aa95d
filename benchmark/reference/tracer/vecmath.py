"""Frozen copy of raytracer_project_tpu_torch/core/vecmath.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

import torch

from .constants import PI


_UNIT_EPS = 1e-8


def fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add: the product is exact
    in f64 and the sum is rounded to f64 and then to f32, which differs
    from a true f32 fma only when that double rounding meets a tie.
    Python numbers enter as f32 constants."""
    def f64(x):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x, dtype=torch.float32)
        return x.to(torch.float64)
    return (f64(a) * f64(b) + f64(c)).to(torch.float32)


def sqrt(x):
    """Correctly rounded f32 square root, as XLA and CUDA's sqrtf compute
    it. torch's CPU sqrt is not (it misses by an ulp on some inputs); the
    square root of the f64 value rounded to f32 is, since f64 carries more
    than twice f32's precision."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def safe_sqrt(x):
    """sqrt(x) where x > 0, else 0."""
    pos = x > 0.0
    return torch.where(pos, sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_arccos(x):
    """arccos with the argument clamped to [-1, 1]."""
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def dot(u, v, keepdim: bool = False):
    """Dot product over the trailing axis (vec3.hpp:154-156), rounded as
    the reference's compiled 3-term sum: fma(u2, v2, fma(u1, v1, u0 v0))."""
    u, v = torch.broadcast_tensors(u, v)
    out = fma(u[..., 2], v[..., 2],
              fma(u[..., 1], v[..., 1], u[..., 0] * v[..., 0]))
    return out[..., None] if keepdim else out


def cross(u, v):
    """Cross product over the trailing axis (vec3.hpp:158-162)."""
    return torch.linalg.cross(u, v, dim=-1)


def length_squared(v, keepdim: bool = False):
    return dot(v, v, keepdim)


def length(v, keepdim: bool = False):
    return safe_sqrt(length_squared(v, keepdim))


def normalize(v):
    """Safe unit vector: 0 for (near-)zero input (vec3.hpp:165-171)."""
    len_ = length(v, keepdim=True)
    return torch.where(len_ < _UNIT_EPS, 0.0,
                       v / torch.clamp(len_, min=_UNIT_EPS))


def near_zero(v):
    """True where every component is below 1e-8 in magnitude."""
    return (torch.abs(v) < 1e-8).all(-1)


def reflect(v, n):
    """Mirror reflection about n (vec3.hpp:204-206)."""
    return v - 2.0 * dot(v, n, keepdim=True) * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of unit uv about n (vec3.hpp:209-214);
    etai_over_etat is [...]. Total internal reflection returns the
    tangential part only (callers take the reflected ray there)."""
    eta = etai_over_etat[..., None]
    cos_theta = torch.clamp(dot(-uv, n, keepdim=True), max=1.0)
    r_out_perp = eta * (uv + cos_theta * n)
    k = 1.0 - length_squared(r_out_perp, keepdim=True)
    return r_out_perp - safe_sqrt(k) * n


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
    s = sqrt(torch.clamp(1.0 - xc * xc, min=0.0))
    return atan2_poly(s, xc)


def luminance(c):
    """Rec.709 luminance of [..., 3] colours (vec3.hpp:106-108)."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722

