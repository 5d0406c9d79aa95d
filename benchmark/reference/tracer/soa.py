"""Frozen copy of raytracer_project_tpu_torch/core/soa.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

import torch

from .vecmath import sqrt


def add(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2]


def sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def mul(a, b):
    """Componentwise (Hadamard) product."""
    return a[0] * b[0], a[1] * b[1], a[2] * b[2]


def scale(a, s):
    return a[0] * s, a[1] * s, a[2] * s


def neg(a):
    return -a[0], -a[1], -a[2]


def axpy(s, a, b):
    """s * a + b."""
    return s * a[0] + b[0], s * a[1] + b[1], s * a[2] + b[2]


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length_squared(a):
    return dot(a, a)


def length(a):
    return sqrt(length_squared(a))


_UNIT_EPS = 1e-12


def normalize(a):
    """Safe unit vector: 0 for (near-)zero input (vec3.hpp:165-171)."""
    l2 = length_squared(a)
    eps2 = _UNIT_EPS * _UNIT_EPS
    inv = torch.where(l2 < eps2, 0.0,
                      1.0 / sqrt(torch.clamp(l2, min=eps2)))
    return scale(a, inv)


def near_zero(a, eps=1e-8):
    return (torch.abs(a[0]) < eps) & (torch.abs(a[1]) < eps) & (torch.abs(a[2]) < eps)


def reflect(v, n):
    """v - 2 (v.n) n (vec3.hpp:204-206)."""
    d = 2.0 * dot(v, n)
    return v[0] - d * n[0], v[1] - d * n[1], v[2] - d * n[2]


def refract(uv, n, etai_over_etat):
    """Snell refraction of unit uv about n (vec3.hpp:209-213)."""
    cos_theta = torch.clamp(dot(neg(uv), n), max=1.0)
    perp = scale(add(uv, scale(n, cos_theta)), etai_over_etat)
    par_len = -sqrt(torch.abs(1.0 - length_squared(perp)))
    return add(perp, scale(n, par_len))


def where(m, a, b):
    """Componentwise select by a mask [N]."""
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]))

