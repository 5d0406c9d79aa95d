"""Homogeneous participating media: constant-density fog volumes (twin of
raytracer_project_tpu/ops/volumes.py).

The reference's `constant_medium` (constant_medium.hpp:24-87): find the
ray's [entry, exit] span inside the boundary, clamp it against the closest
surface hit, draw an exponential free-flight distance -log(u)/density, and
scatter isotropically if the flight ends inside the span. Volumes live in
their own table (sphere or axis-aligned box boundaries) and are sampled
after the surface closest hit with the lane RNG; the phase function is an
ISOTROPIC material row, so shading needs no special case.

This module serves the chunked integrator ([N, 3] rays, with the
fused multiply-adds of the reference's compiled arithmetic in the dots and
the hit point). The fused pool samples the same law inside K3
(ops/fused_step.py, csrc/shade_advance.cu) from the volume rows of
`fused_step.build_tables`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng, vecmath
from ..core.constants import T_MAX, T_MIN
from ..core.tree import to_device
from .intersect import Hit, HitRecord

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


def _boundary_span(vol: VolumeTable, v: int, o, d):
    """Unclamped [entry, exit] of every ray o, d f32[N, 3] with volume v's
    boundary over t in (-inf, inf) (constant_medium.hpp:42-47). Returns
    (entry [N], exit [N], hit [N])."""
    # Sphere span.
    oc = vol.center[v] - o
    a = vecmath.length_squared(d)
    h = vecmath.dot(d, oc)
    c = vecmath.length_squared(oc) - vol.radius[v] * vol.radius[v]
    disc = h * h - a * c
    sq = vecmath.sqrt(torch.clamp(disc, min=0.0))
    s_entry = (h - sq) / a
    s_exit = (h + sq) / a
    s_hit = (disc > 0.0) & (vol.radius[v] > 0.0)

    # Box slab span.
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20,
                              torch.where(d < 0, -1e-20, 1e-20), d)
    t0 = (vol.box_min[v] - o) * inv_d
    t1 = (vol.box_max[v] - o) * inv_d
    b_entry = torch.minimum(t0, t1).amax(-1)
    b_exit = torch.maximum(t0, t1).amin(-1)

    is_sphere = vol.kind[v] == VOL_SPHERE
    return (torch.where(is_sphere, s_entry, b_entry),
            torch.where(is_sphere, s_exit, b_exit),
            torch.where(is_sphere, s_hit, b_entry < b_exit))


def sample_interaction(volumes: VolumeTable, o, d, tmin, surface: Hit,
                       lr: rng.LaneRng):
    """Stochastic volume-scatter test of every ray against every volume.

    Returns (t [N], mat i64[N], is_volume bool[N]): where is_volume, a
    scatter event at t, before any surface hit, in material `mat`;
    elsewhere t is the surface hit's (T_MAX on a miss) and mat 0. Volume v
    draws from the lane's STREAM_VOLUME with salt v + 1."""
    n = o.shape[0]
    best_t = torch.where(surface.hit, surface.t, T_MAX)
    best_mat = torch.zeros((n,), dtype=torch.int64, device=o.device)
    is_volume = torch.zeros((n,), dtype=torch.bool, device=o.device)
    ray_len = vecmath.length(d)
    for v in range(volumes.count):
        entry, exit_, bhit = _boundary_span(volumes, v, o, d)
        e = torch.clamp(entry, min=tmin)
        x = torch.minimum(exit_, best_t)
        valid = bhit & (e < x)
        u = rng.draw_uniform(lr, rng.STREAM_VOLUME, salt=v + 1)
        flight = volumes.neg_inv_density[v] * torch.log(torch.clamp(u, min=1e-38))
        scatters = valid & (flight <= (x - e) * ray_len)
        t_v = e + flight / torch.clamp(ray_len, min=1e-20)
        take = scatters & (t_v < best_t)
        best_t = torch.where(take, t_v, best_t)
        best_mat = torch.where(take, volumes.mat[v].long(), best_mat)
        is_volume = is_volume | take
    return best_t, best_mat, is_volume


def apply_to_record(volumes: VolumeTable | None, o, d, surface: Hit,
                    rec: HitRecord, lr: rng.LaneRng) -> HitRecord:
    """The surface record with the volume interactions laid over it: at a
    volume scatter the hit point moves to the scatter point, the normal is
    the reference's arbitrary (1, 0, 0) with front_face True
    (constant_medium.hpp:72-73), and the material is the volume's."""
    if volumes is None or volumes.count == 0:
        return rec
    t, mat, is_vol = sample_interaction(volumes, o, d, T_MIN, surface, lr)
    vb = is_vol[:, None]
    p = vecmath.fma(t[:, None], d, o)
    arbitrary_n = rec.normal.new_tensor([1.0, 0.0, 0.0]).expand_as(rec.normal)
    return HitRecord(
        t=torch.where(is_vol, t, rec.t),
        p=torch.where(vb, p, rec.p),
        normal=torch.where(vb, arbitrary_n, rec.normal),
        tangent=torch.where(vb, 0.0, rec.tangent),
        bitangent=torch.where(vb, 0.0, rec.bitangent),
        front_face=rec.front_face | is_vol,
        u=torch.where(is_vol, 0.0, rec.u),
        v=torch.where(is_vol, 0.0, rec.v),
        mat=torch.where(is_vol, mat, rec.mat),
        hit=rec.hit | is_vol,
    )
