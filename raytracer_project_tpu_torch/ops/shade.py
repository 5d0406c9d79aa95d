"""Branchless material evaluation of the chunked integrator and the
unfused pool (twin of raytracer_project_tpu/ops/shade.py): `scatter` and
`get_albedo` on [N, 3] vectors, `scatter_soa` and `get_albedo_soa` on
(x, y, z) tuples of [N].

Every material family is evaluated for every lane with one shared
unit-sphere draw and one uniform, and the lane's family is selected by its
type tag (material.hpp:24, 74-108, 129-151, 192-224, 255-258). The fused
pool shades inside its kernel instead (ops/fused_step.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng, soa, vecmath
from ..core.constants import RAY_EPSILON
from ..models import materials as mat_mod
from ..models import textures as tex_mod
from .intersect import HitRecord, HitRecordSoa

# Finite-difference step of the bump heightfield (material.hpp:40-41).
_BUMP_DELTA = 1.0 / 1024.0


def _mat_fetch(scene, mat_ids):
    """Material columns of each lane: (mtype i64[N], albedo f32[N, 3],
    param f32[N], texture_id i64[N], bump_id i64[N], bump_strength
    f32[N])."""
    m = scene.materials
    i = mat_ids.long()
    return (m.mtype[i].long(), m.albedo[i], m.param[i], m.texture_id[i].long(),
            m.bump_id[i].long(), m.bump_strength[i])


class Scatter(NamedTuple):
    """One shading event ([N] lanes)."""

    origin: torch.Tensor       # f32[N, 3] next ray origin (epsilon offset)
    direction: torch.Tensor    # f32[N, 3]
    attenuation: torch.Tensor  # f32[N, 3]
    emitted: torch.Tensor      # f32[N, 3]
    scattered: torch.Tensor    # bool[N]; False: the path ends here


def bumped_normal(scene, rec: HitRecord, bump_id, strength):
    """Tangent-space heightfield bump (material.hpp:35-54):
    N' = normalize(N - f_u T - f_v B) where the lane has a bump map."""
    du, dv = tex_mod.sample_bump_deltas(scene.textures, bump_id, rec.u, rec.v,
                                        _BUMP_DELTA)
    f_u = du * strength
    f_v = dv * strength
    n = rec.normal - f_u[:, None] * rec.tangent - f_v[:, None] * rec.bitangent
    return torch.where((bump_id >= 0)[:, None], vecmath.normalize(n),
                       rec.normal)


def get_albedo(scene, rec: HitRecord):
    """AOV albedo (material.hpp:29, 99-102, 154-156, 226-229, 266-275):
    the texture color; white for dielectrics; emission clamped to 1 for
    lights; black for the isotropic phase material."""
    mtype, solid, _, texture_id, _, _ = _mat_fetch(scene, rec.mat)
    tex = tex_mod.sample(scene.textures, texture_id, rec.u, rec.v, rec.p, solid)
    albedo = torch.where((mtype == mat_mod.DIELECTRIC)[:, None], 1.0, tex)
    albedo = torch.where((mtype == mat_mod.EMISSIVE)[:, None],
                         torch.clamp(tex, max=1.0), albedo)
    return torch.where((mtype == mat_mod.ISOTROPIC)[:, None], 0.0, albedo)


def scatter(scene, rec: HitRecord, in_dir, lr: rng.LaneRng) -> Scatter:
    """One shading event for every lane. in_dir f32[N, 3] need not be
    unit; the draws come from lr's scatter stream."""
    mtype, solid, param, texture_id, bump_id, bump_strength = _mat_fetch(
        scene, rec.mat)
    tex_color = tex_mod.sample(scene.textures, texture_id, rec.u, rec.v,
                               rec.p, solid)
    sphere_draw, choice_u = rng.draw_unit_vector_and_uniform(
        lr, rng.STREAM_SCATTER)
    working_n = bumped_normal(scene, rec, bump_id, bump_strength)
    unit_in = vecmath.normalize(in_dir)
    eps_origin = vecmath.fma(rec.normal, RAY_EPSILON, rec.p)

    # Lambertian (material.hpp:74-96).
    lam_dir = working_n + sphere_draw
    lam_dir = torch.where(vecmath.near_zero(lam_dir)[:, None], working_n,
                          lam_dir)

    # Metal (material.hpp:129-151).
    reflected = vecmath.reflect(unit_in, working_n)
    metal_dir = vecmath.normalize(reflected + param[:, None] * sphere_draw)
    metal_ok = vecmath.dot(metal_dir, rec.normal) > 0.0

    # Dielectric (material.hpp:192-224; Schlick, :237-241). The powers are
    # the products the reference compiles x**2 and x**5 into.
    ri = torch.where(rec.front_face, 1.0 / torch.clamp(param, min=1e-6), param)
    cos_theta = torch.clamp(vecmath.dot(-unit_in, working_n), max=1.0)
    sin_theta = vecmath.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ri * sin_theta > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    c1 = 1.0 - cos_theta
    c2 = c1 * c1
    reflect_prob = r0 + (1.0 - r0) * (c1 * (c2 * c2))
    do_reflect = cannot_refract | (reflect_prob > choice_u)
    refracted = vecmath.refract(unit_in, working_n, ri)
    diel_dir = torch.where(do_reflect[:, None], reflected, refracted)
    offset_out = vecmath.dot(diel_dir, rec.normal) > 0.0
    diel_origin = vecmath.fma(torch.where(offset_out[:, None], RAY_EPSILON,
                                          -RAY_EPSILON), rec.normal, rec.p)

    is_lam = (mtype == mat_mod.LAMBERTIAN)[:, None]
    is_metal = (mtype == mat_mod.METAL)[:, None]
    is_diel = (mtype == mat_mod.DIELECTRIC)[:, None]
    # The isotropic phase function scatters along the draw from the hit
    # point (constant_medium.hpp:9-22).
    direction = torch.where(is_lam, lam_dir, torch.where(
        is_metal, metal_dir, torch.where(is_diel, diel_dir, sphere_draw)))
    origin = torch.where(is_lam | is_metal, eps_origin,
                         torch.where(is_diel, diel_origin, rec.p))
    # Dielectrics attenuate by their untextured albedo (material.hpp:193).
    attenuation = torch.where(is_diel, solid, tex_color)
    scattered = ((mtype == mat_mod.LAMBERTIAN)
                 | ((mtype == mat_mod.METAL) & metal_ok)
                 | (mtype == mat_mod.DIELECTRIC)
                 | (mtype == mat_mod.ISOTROPIC))
    emitted = torch.where((mtype == mat_mod.EMISSIVE)[:, None], tex_color, 0.0)
    return Scatter(origin=origin, direction=direction, attenuation=attenuation,
                   emitted=emitted, scattered=scattered)


# --- SoA twins of the unfused pool (reference shade.py:50, 116-216) ----------

def _mat_fetch_soa(scene, mat_ids):
    """_mat_fetch with the albedo as an (r, g, b) tuple."""
    mtype, albedo, param, texture_id, bump_id, bump_strength = _mat_fetch(
        scene, mat_ids)
    return (mtype, (albedo[:, 0], albedo[:, 1], albedo[:, 2]), param,
            texture_id, bump_id, bump_strength)


def get_albedo_soa(scene, rec: HitRecordSoa):
    """get_albedo of a HitRecordSoa, as an (r, g, b) tuple."""
    mtype, solid3, _, texture_id, _, _ = _mat_fetch_soa(scene, rec.mat)
    tex3 = tex_mod.sample_soa(scene.textures, texture_id, rec.u, rec.v, rec.p,
                              solid3)
    one = torch.ones_like(tex3[0])
    zero = torch.zeros_like(one)
    albedo = soa.where(mtype == mat_mod.DIELECTRIC, (one, one, one), tex3)
    albedo = soa.where(mtype == mat_mod.EMISSIVE,
                       tuple(torch.clamp(c, max=1.0) for c in tex3), albedo)
    return soa.where(mtype == mat_mod.ISOTROPIC, (zero, zero, zero), albedo)


class ScatterSoa(NamedTuple):
    """Scatter with its vectors as (x, y, z) tuples of f32[N]."""

    origin: tuple
    direction: tuple
    attenuation: tuple
    emitted: tuple
    scattered: torch.Tensor


def scatter_soa(scene, rec: HitRecordSoa, in_dir, lr: rng.LaneRng) -> ScatterSoa:
    """`scatter` on component tuples: the same material math and draws."""
    mtype, solid3, param, texture_id, bump_id, bump_strength = _mat_fetch_soa(
        scene, rec.mat)
    tex3 = tex_mod.sample_soa(scene.textures, texture_id, rec.u, rec.v, rec.p,
                              solid3)
    sphere_draw, choice_u = rng.draw_unit_vector_and_uniform_soa(
        lr, rng.STREAM_SCATTER)
    du, dv = tex_mod.sample_bump_deltas(scene.textures, bump_id, rec.u, rec.v,
                                        _BUMP_DELTA)
    f_u = du * bump_strength
    f_v = dv * bump_strength
    n_b = tuple(rec.normal[k] - f_u * rec.tangent[k] - f_v * rec.bitangent[k]
                for k in range(3))
    working_n = soa.where(bump_id >= 0, soa.normalize(n_b), rec.normal)
    unit_in = soa.normalize(in_dir)

    # Lambertian (material.hpp:74-96).
    lam_dir = soa.add(working_n, sphere_draw)
    lam_dir = soa.where(soa.near_zero(lam_dir), working_n, lam_dir)
    # The offset origins are fused multiply-adds, as the reference's
    # compiled pool rounds them (the AoS `scatter` above does the same).
    eps_origin = tuple(vecmath.fma(rec.normal[k], RAY_EPSILON, rec.p[k])
                       for k in range(3))

    # Metal (material.hpp:129-151).
    reflected = soa.reflect(unit_in, working_n)
    metal_dir = soa.normalize(soa.axpy(param, sphere_draw, reflected))
    metal_ok = soa.dot(metal_dir, rec.normal) > 0.0

    # Dielectric (material.hpp:192-224; Schlick, :237-241).
    ri = torch.where(rec.front_face, 1.0 / torch.clamp(param, min=1e-6), param)
    cos_theta = torch.clamp(soa.dot(soa.neg(unit_in), working_n), max=1.0)
    sin_theta = vecmath.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ri * sin_theta > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    c1 = 1.0 - cos_theta
    c2 = c1 * c1
    reflect_prob = r0 + (1.0 - r0) * (c1 * (c2 * c2))
    do_reflect = cannot_refract | (reflect_prob > choice_u)
    refracted = soa.refract(unit_in, working_n, ri)
    diel_dir = soa.where(do_reflect, reflected, refracted)
    offset_out = soa.dot(diel_dir, rec.normal) > 0.0
    eps = torch.where(offset_out, RAY_EPSILON, -RAY_EPSILON)
    diel_origin = tuple(vecmath.fma(eps, rec.normal[k], rec.p[k])
                        for k in range(3))

    is_lam = mtype == mat_mod.LAMBERTIAN
    is_metal = mtype == mat_mod.METAL
    is_diel = mtype == mat_mod.DIELECTRIC
    is_iso = mtype == mat_mod.ISOTROPIC
    direction = soa.where(is_lam, lam_dir, soa.where(
        is_metal, metal_dir, soa.where(is_diel, diel_dir, sphere_draw)))
    origin = soa.where(is_lam | is_metal, eps_origin,
                       soa.where(is_diel, diel_origin, rec.p))
    attenuation = soa.where(is_diel, solid3, tex3)
    scattered = is_lam | (is_metal & metal_ok) | is_diel | is_iso
    zero = torch.zeros_like(tex3[0])
    emitted = soa.where(mtype == mat_mod.EMISSIVE, tex3, (zero, zero, zero))
    return ScatterSoa(origin=origin, direction=direction,
                      attenuation=attenuation, emitted=emitted,
                      scattered=scattered)
