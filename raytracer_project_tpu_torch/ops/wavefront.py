"""Pooled-wavefront integrator (twin of raytracer_project_tpu/ops/wavefront.py).

A pool of lanes traces one path segment per step, and a lane whose path
ended takes the next (pixel, sample) work item at once, so the work tracks
the path segments and not samples x max_depth. Two engines:

  * the fused pool (ops/fused_step.py, K1 -> K3 fused per step): identity
    full frames and identity pixel windows while the fused step covers
    the render. Renders past the 2^24 work-id cap are sample-chunked; lane
    RNG streams are (pixel, sample)-keyed, so the chunk sums equal one
    oversized call's;
  * the unfused pool below, torch ops around the closest hit
    (intersect.intersect_soa: K1 on the card): explicit pixel ids,
    textured fog and tables past the fused step's f32 row cap, or any
    render when RAYTRACER_TPU_NO_FUSED is set (the reference's switch).

Per-sample values are the same on both engines (same RNG contexts,
constants and update order); the sums differ in float addition order only.
Vectors ride the unfused loop as (x, y, z) tuples of [P] tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import torch

from ..core import rng, soa
from ..core.constants import (
    RR_P_MAX, RR_P_MIN, RR_START_BOUNCE, T_MIN, WEAK_RAY_EPS,
)
from ..models import camera as camera_mod
from ..models import environment as env_mod
from . import fused_step, intersect, shade, volumes as volumes_mod

# The unfused pool's lanes (the reference's POOL_LANES); config.pool_lanes
# overrides it.
POOL_LANES = 262_144


class _PoolState(NamedTuple):
    next_work: torch.Tensor   # i64 [] next unclaimed work id
    live: torch.Tensor        # bool[P]
    li: torch.Tensor          # i64[P] slot in the accumulators
    pix: torch.Tensor         # i64[P] global pixel id (RNG and camera)
    samp: torch.Tensor        # i64[P] absolute sample id
    bounce: torch.Tensor      # i64[P] 0 = camera segment
    is_spec: torch.Tensor     # bool[P] a split-pass path
    origin: tuple
    direction: tuple
    throughput: tuple
    radiance: tuple
    attn0: tuple              # first-hit attenuation of a spec path
    to_refl: torch.Tensor     # bool[P]
    to_refr: torch.Tensor     # bool[P]


def _spawn(cam, seed: int, config, pixel_ids, sample_offset: int,
           n_beauty: int, work_id):
    """Work id -> fresh lane (bounce 0, camera ray). Work ids [0, n_beauty)
    are beauty paths in sample-major order (w = s * n + li); the next
    n_beauty are the split-pass paths of the same samples."""
    n = pixel_ids.shape[0]
    is_spec = work_id >= n_beauty
    w = torch.where(is_spec, work_id - n_beauty, work_id)
    samp_rel = w // n
    li = w - samp_rel * n
    samp = sample_offset + samp_rel
    pix = pixel_ids[li]
    # A spec path re-traces its sample's camera ray: context (0, beauty).
    # The rays take generate_rays's fused multiply-adds, the rounding of
    # the reference's compiled spawn.
    lr0 = rng.LaneRng(seed, rng.u32(pix), rng.u32(samp), 0)
    o, d = camera_mod.generate_rays(cam, lr0, pix, config.width)
    return li, pix, samp, is_spec, o.unbind(1), d.unbind(1)


def _coherence_order(origin, direction, live):
    """Lane order grouping rays by direction octant, then by a coarse
    origin Morton cell, dead lanes last (reference _coherence_order,
    wavefront.py:140): 128 buckets of a dead-lane bit, three octant bits and
    three origin bits. The reference ranks lanes by a stable counting sort
    over them; a stable sort of the bucket key is the same permutation. Scheduling only: lane streams are (pixel, sample)-keyed."""
    half = []
    for c in origin:
        lo = c.min()
        span = torch.clamp(c.max() - lo, min=1e-6)
        half.append(((c - lo) / span > 0.5).long())
    morton = (half[0] << 2) | (half[1] << 1) | half[2]
    octant = (((direction[0] > 0).long() << 2) | ((direction[1] > 0).long() << 1)
              | (direction[2] > 0).long())
    bkey = ((~live).long() << 6) | (octant << 3) | morton
    return torch.sort(bkey, stable=True).indices


def _volumes_soa(volumes, o, d, hit, rec, lr):
    """The fog pass of the chunked integrator on a HitRecordSoa."""
    pack = lambda v: torch.stack(v, 1)
    unpack = lambda a: (a[:, 0], a[:, 1], a[:, 2])
    rec_a = intersect.HitRecord(
        t=rec.t, p=pack(rec.p), normal=pack(rec.normal),
        tangent=pack(rec.tangent), bitangent=pack(rec.bitangent),
        front_face=rec.front_face, u=rec.u, v=rec.v, mat=rec.mat, hit=rec.hit)
    out = volumes_mod.apply_to_record(volumes, pack(o), pack(d), hit, rec_a, lr)
    return intersect.HitRecordSoa(
        t=out.t, p=unpack(out.p), normal=unpack(out.normal),
        tangent=unpack(out.tangent), bitangent=unpack(out.bitangent),
        front_face=out.front_face, u=out.u, v=out.v, mat=out.mat, hit=out.hit)


def render_unfused(scene, cam, env, seed: int, config, pixel_ids,
                   sample_offset: int = 0, with_stats: bool = False, *,
                   aux: int):
    """The unfused pool (reference make_pool + render_pool's loop,
    wavefront.py:206-468, 577-589): per-pixel sums (SampleBuffers, each
    f32[n, 3]) of the n pixels pixel_ids (i64[n] global ids, on the
    scene's device) over config.samples_per_pixel samples from
    sample_offset on. config.sort_lanes re-sorts the lanes after every
    step (_coherence_order). aux: the AOV budget (absolute sample ids below
    it count). with_stats also returns {"segments", "steps"}."""
    from .integrator import SampleBuffers

    dev = scene.spheres.center.device
    cam, env = cam.to(dev), env.to(dev)
    n = pixel_ids.shape[0]
    spp = config.samples_per_pixel
    want_spec = config.use_reflection or config.use_refraction
    n_beauty = n * spp
    total_work = n_beauty * (2 if want_spec else 1)
    p = config.pool_lanes or min(total_work, POOL_LANES)
    seed = rng.seed_from_int(seed)
    tables = intersect.hit_tables(scene)
    packed = intersect._packed_all(scene)

    fields = ["beauty"]
    fields += [f for f, on in (("albedo", config.use_albedo),
                               ("normal", config.use_normal),
                               ("z_depth", config.use_z_depth)) if on]
    if want_spec:
        fields += ["reflection", "refraction"]
    # One overflow row per buffer takes the masked lanes' adds.
    acc = {f: torch.zeros((n + 1, 3), dtype=torch.float32, device=dev)
           for f in fields}

    def scatter_add(name, mask, slot, val):
        acc[name].index_add_(0, torch.where(mask, slot, n), torch.stack(
            [torch.where(mask, c, 0.0) for c in val], 1))

    w0 = torch.arange(p, dtype=torch.int64, device=dev)
    li, pix, samp, is_spec, o, d = _spawn(cam, seed, config, pixel_ids,
                                          sample_offset, n_beauty, w0)
    ones = lambda: (torch.ones(p, device=dev),) * 3
    zeros = lambda: (torch.zeros(p, device=dev),) * 3
    no = torch.zeros(p, dtype=torch.bool, device=dev)
    s = _PoolState(
        next_work=torch.tensor(min(p, total_work), device=dev),
        live=w0 < total_work, li=li, pix=pix, samp=samp,
        bounce=torch.zeros(p, dtype=torch.int64, device=dev), is_spec=is_spec,
        origin=o, direction=d, throughput=ones(), radiance=zeros(),
        attn0=ones(), to_refl=no, to_refr=no)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    steps = 0

    while bool(s.live.any()):
        at0 = s.bounce == 0
        lr = rng.LaneRng(seed, rng.u32(s.pix), rng.u32(s.samp),
                         (rng.u32(s.bounce) << 1) | rng.u32(s.is_spec.long()))
        hit = intersect.intersect_soa(scene, s.origin, s.direction, T_MIN,
                                      tables)
        rec = intersect.make_record_soa(scene, s.origin, s.direction, hit,
                                        packed)
        if scene.volumes is not None:
            rec = _volumes_soa(scene.volumes, s.origin, s.direction, hit, rec,
                               lr)
        bg = env_mod.background_color_soa(env, s.direction, config.env_mode)
        sc = shade.scatter_soa(scene, rec, s.direction, lr)

        # Radiance and path update. A spec path skips its first hit's
        # emission and attenuation (camera.hpp:494-498).
        emit_ok = ~(at0 & s.is_spec)
        miss = s.live & ~rec.hit
        radiance = tuple(r + torch.where(miss, t * b, 0.0)
                         for r, t, b in zip(s.radiance, s.throughput, bg))
        active = s.live & rec.hit
        emit_lanes = active & emit_ok
        radiance = tuple(r + torch.where(emit_lanes, t * e, 0.0)
                         for r, t, e in zip(radiance, s.throughput, sc.emitted))
        gain = active & sc.scattered & emit_ok
        throughput = soa.where(gain, soa.mul(s.throughput, sc.attenuation),
                               s.throughput)
        active = active & sc.scattered

        # Weak-ray cutoff and Russian roulette past RR_START_BOUNCE of the
        # trace (camera.hpp:967-983); depth runs out after max_depth - 1.
        late = (s.bounce - 1) > RR_START_BOUNCE
        active = active & ~(late & (soa.length(throughput) < WEAK_RAY_EPS))
        p_rr = torch.clamp(torch.maximum(throughput[0], torch.maximum(
            throughput[1], throughput[2])), RR_P_MIN, RR_P_MAX)
        u = rng.draw_uniform(lr, rng.STREAM_RR)
        active = active & ~(late & (u > p_rr))
        throughput = soa.where(late & active, soa.scale(throughput, 1.0 / p_rr),
                               throughput)
        active = active & (s.bounce + 1 < config.max_depth)

        # Spec-pass routing at the first hit (camera.hpp:492-517).
        to_refl, to_refr, attn0 = s.to_refl, s.to_refr, s.attn0
        if want_spec:
            spec0 = at0 & s.is_spec & s.live
            refl_dir = soa.reflect(soa.normalize(s.direction),
                                   soa.normalize(rec.normal))
            is_specular = soa.dot(soa.normalize(sc.direction), refl_dir) > 0.9
            entering = soa.dot(sc.direction, rec.normal) < 0.0
            spec_live = rec.hit & sc.scattered
            to_refl = torch.where(
                spec0, spec_live & is_specular & config.use_reflection, to_refl)
            to_refr = torch.where(
                spec0, spec_live & ~is_specular & entering
                & config.use_refraction, to_refr)
            attn0 = soa.where(spec0, sc.attenuation, attn0)
            active = active & ~(spec0 & ~(to_refl | to_refr))

        # AOVs of beauty camera segments within the aux budget.
        is_aux = at0 & ~s.is_spec & s.live & (s.samp < aux)
        zero = torch.zeros_like(rec.u)
        if config.use_albedo:
            scatter_add("albedo", is_aux, s.li, soa.where(
                rec.hit, shade.get_albedo_soa(scene, rec), (zero,) * 3))
        if config.use_normal:
            miss_c = (zero + 0.5, zero + 0.5, zero + 1.0)
            scatter_add("normal", is_aux, s.li, soa.where(
                rec.hit, camera_mod.view_space_normal_color_soa(cam, rec.normal),
                miss_c))
        if config.use_z_depth:
            zval = 1.0 - torch.clamp(rec.t / config.z_depth_max_dist, 0.0, 1.0)
            zval = torch.where(rec.hit, zval, 0.0)
            scatter_add("z_depth", is_aux, s.li, (zval,) * 3)

        # Finished paths -> accumulators; the firefly clamp and the first-
        # hit attenuation on the split passes (camera.hpp:499-509).
        done = s.live & ~active
        scatter_add("beauty", done & ~s.is_spec, s.li, radiance)
        if want_spec:
            luma = 0.2126 * soa.length(radiance)
            fscale = torch.where(luma > 2.0, 2.0 / torch.clamp(luma, min=1e-12),
                                 1.0)
            contrib = soa.mul(attn0, soa.scale(radiance, fscale))
            scatter_add("reflection", done & to_refl, s.li, contrib)
            scatter_add("refraction", done & to_refr, s.li, contrib)

        # Respawn: the free lane of (inclusive) rank r takes work id
        # next_work + r - 1 while that is below total_work.
        free = ~s.live | done
        new_w = s.next_work + torch.cumsum(free.long(), 0) - 1
        can_spawn = free & (new_w < total_work)
        n_free = free.sum()
        sli, spix, ssamp, sspec, so, sd = _spawn(
            cam, seed, config, pixel_ids, sample_offset, n_beauty,
            torch.clamp(new_w, 0, total_work - 1))
        sel = lambda fresh, old: torch.where(can_spawn, fresh, old)
        sel3 = lambda fresh, old: soa.where(can_spawn, fresh, old)
        segments += s.live.sum()
        steps += 1
        s = _PoolState(
            next_work=torch.clamp(s.next_work + n_free, max=total_work),
            live=(s.live & active) | can_spawn,
            li=sel(sli, s.li), pix=sel(spix, s.pix), samp=sel(ssamp, s.samp),
            bounce=torch.where(can_spawn, 0, s.bounce + 1),
            is_spec=sel(sspec, s.is_spec),
            origin=sel3(so, soa.where(active, sc.origin, s.origin)),
            direction=sel3(sd, soa.where(active, sc.direction, s.direction)),
            throughput=sel3(ones(), throughput),
            radiance=sel3(zeros(), radiance),
            attn0=sel3(ones(), attn0),
            to_refl=sel(no, to_refl), to_refr=sel(no, to_refr))
        if config.sort_lanes:
            order = _coherence_order(s.origin, s.direction, s.live)
            s = s._replace(**{
                f: tuple(c[order] for c in x) if isinstance(x, tuple)
                else x[order] for f, x in zip(s._fields[1:], s[1:])})

    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    out = SampleBuffers(*(acc[f][:n] if f in acc else zeros3
                          for f in SampleBuffers._fields))
    if with_stats:
        return out, {"segments": int(segments), "steps": steps}
    return out


def _is_identity(pixel_ids, n_pixels: int) -> bool:
    ids = torch.as_tensor(pixel_ids)
    return ids.shape == (n_pixels,) and bool(
        torch.equal(ids.cpu().long(), torch.arange(n_pixels)))


def render_pool(scene, cam, env, seed: int, config, pixel_ids=None,
                sample_offset: int = 0, with_stats: bool = False,
                pixel_offset: int = 0, n_pixels_local: int | None = None,
                aux: int | None = None):
    """Per-pixel sums (integrator.SampleBuffers) through a pool engine.

    pixel_ids None is the full frame or, with n_pixels_local, the identity
    pixel window [pixel_offset, pixel_offset + n_pixels_local), clamped to
    the frame (trailing slots re-render the last pixel; parallel/render.py
    drops them). An explicit pixel_ids (global ids, [n]) renders those
    pixels and takes the unfused pool unless it is the identity frame.
    Identity frames and windows take the fused pool while it covers the
    render (fused_step.fused_spp_chunk > 0) and RAYTRACER_TPU_NO_FUSED is
    unset; the rest take the unfused pool. Every fused sample chunk counts
    its AOV samples against the budget `aux` (absolute sample ids below it
    count; None: this call's min(aux_samples, spp)), so the chunks
    together count the samples of one call.

    with_stats also returns {"segments", "steps", "engine"}; engine is
    "fused" or "pool"."""
    if pixel_ids is not None and n_pixels_local is not None:
        raise ValueError("a pixel window takes pixel_ids=None")
    if aux is None:
        aux = min(config.aux_samples, config.samples_per_pixel)
    identity = pixel_ids is None or _is_identity(pixel_ids, config.n_pixels)
    no_fused = bool(os.environ.get("RAYTRACER_TPU_NO_FUSED"))
    chunk = fused_step.fused_spp_chunk(scene, config, env, n_pixels_local)
    if identity and not no_fused and chunk > 0:
        out, stats = _render_fused(scene, cam, env, seed, config, chunk,
                                   sample_offset, pixel_offset, n_pixels_local,
                                   aux)
        stats["engine"] = "fused"
        return (out, stats) if with_stats else out
    dev = scene.spheres.center.device
    if pixel_ids is None:
        if n_pixels_local is None:
            pixel_ids = torch.arange(config.n_pixels, device=dev)
        else:
            pixel_ids = torch.clamp(
                pixel_offset + torch.arange(n_pixels_local, device=dev),
                max=config.n_pixels - 1)
    pixel_ids = torch.as_tensor(pixel_ids).to(dev, torch.int64)
    out, stats = render_unfused(scene, cam, env, seed, config, pixel_ids,
                                sample_offset, with_stats=True, aux=aux)
    stats["engine"] = "pool"
    return (out, stats) if with_stats else out


def _render_fused(scene, cam, env, seed, config, chunk, sample_offset,
                  pixel_offset, n_pixels_local, aux):
    spp = config.samples_per_pixel
    out = None
    segments = steps = 0
    for off in range(0, spp, chunk):
        cfg_c = dataclasses.replace(config,
                                    samples_per_pixel=min(chunk, spp - off))
        res, st = fused_step.render_pool_fused(
            scene, cam, env, seed, cfg_c, aux, sample_offset + off,
            with_stats=True, pixel_offset=pixel_offset,
            n_pixels_local=n_pixels_local)
        segments += st["segments"]
        steps += st["steps"]
        out = res if out is None else type(res)(*(a + b for a, b in
                                                   zip(out, res)))
    return out, {"segments": segments, "steps": steps}
