"""Render entry point and the chunked integrator (twin of
raytracer_project_tpu/ops/integrator.py).

`render` runs on the card unless the caller asks for another device, by
one of two engines, each with all six buffers and fog:
  * wavefront=True (the default): the fused pooled wavefront
    (ops/wavefront.py -> ops/fused_step.py); fog there must have solid
    (untextured) phase materials;
  * wavefront=False: the chunked integrator below. Each
    chunk is one wavefront of (pixel, sample) lanes that follows the
    reference's per-sample structure (camera.hpp:454-527): one first hit
    shared by beauty, the AOVs and the split passes, then a bounce loop
    (camera.hpp:928-986) that intersects every lane on every bounce
    through intersect.intersect (K4 on the card) until all lanes are dead.
The differentiable mode and textured fog on the fused pool raise
NotImplementedError with the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import rng, vecmath
from ..core.constants import (
    RR_P_MAX, RR_P_MIN, RR_START_BOUNCE, T_MIN, WEAK_RAY_EPS,
    Z_DEPTH_MAX_DIST,
)
from ..models import camera as camera_mod
from ..models import environment as env_mod
from . import intersect, shade, volumes


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render knobs; defaults follow the reference (camera.hpp:26-57), so a
    beauty-only caller turns the AOVs off, as the reference's bench does."""

    width: int = 400
    height: int = 225
    samples_per_pixel: int = 30
    max_depth: int = 10
    env_mode: int = env_mod.PHYSICAL_SUN
    use_albedo: bool = True
    use_normal: bool = True
    use_z_depth: bool = True
    use_reflection: bool = False
    use_refraction: bool = False
    z_depth_max_dist: float = Z_DEPTH_MAX_DIST
    # Samples per chunk of the chunked integrator (None: as many as fit
    # in _TARGET_LANES lanes).
    samples_per_batch: int | None = None
    differentiable: bool = False
    wavefront: bool = True
    # Pool size (None = min(total work, 131072), rounded up to 4096).
    pool_lanes: int | None = None

    @property
    def aux_samples(self) -> int:
        """AOV sample budget: clamp(spp/8, 64, 1024), capped at spp where
        it is used (camera.hpp:433, 535)."""
        return min(max(self.samples_per_pixel // 8, 64), 1024)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


class SampleBuffers(NamedTuple):
    """Per-pixel sums, all f32[N, 3] (N = W*H, row-major). Buffers that the
    config turns off are zeros."""

    beauty: torch.Tensor
    albedo: torch.Tensor
    normal: torch.Tensor
    z_depth: torch.Tensor
    reflection: torch.Tensor
    refraction: torch.Tensor


def _check_supported(config: RenderConfig) -> None:
    if config.differentiable:
        raise NotImplementedError(
            "differentiable mode is not ported yet (ROADMAP queue 1: "
            "differentiable mode)")


def trace(scene, env, origin, direction, lane_rng: rng.LaneRng, *,
          tables, max_bounces: int, env_mode: int, throughput=None,
          radiance=None, active=None, spec: int = 0, stats=None):
    """Bounce loop (camera.hpp:928-986) over a wavefront: radiance f32[N, 3].

    Bounce b draws from context (b + 1, spec): the camera segment is
    bounce 0. Every lane is intersected on every bounce, dead ones
    included; the loop ends after max_bounces or once no lane is live (one
    host read per bounce). stats["segments"], when given, adds the live
    lanes of each bounce. tables: the scene's intersect.hit_tables."""
    n = origin.shape[0]
    dev = origin.device
    if throughput is None:
        throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    if radiance is None:
        radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    for bounce in range(max_bounces):
        live = int(active.sum())
        if live == 0:
            break
        if stats is not None:
            stats["segments"] += live
        lr = lane_rng.with_ctx(bounce + 1, spec)
        hit = intersect.intersect(scene, origin, direction, T_MIN, tables)
        rec = intersect.make_record(scene, origin, direction, hit)
        # A fog scatter may come before the surface hit
        # (constant_medium.hpp:39-77).
        rec = volumes.apply_to_record(scene.volumes, origin, direction, hit,
                                      rec, lr)

        # Miss: add the environment and retire the lane (camera.hpp:937-941).
        bg = env_mod.background_color(env, direction, env_mode)
        miss = active & ~rec.hit
        radiance = radiance + torch.where(miss[:, None], throughput * bg, 0.0)
        active = active & rec.hit

        # Hit: emission, then scatter (camera.hpp:944-973).
        sc = shade.scatter(scene, rec, direction, lr)
        radiance = radiance + torch.where(active[:, None],
                                          throughput * sc.emitted, 0.0)
        throughput = torch.where((active & sc.scattered)[:, None],
                                 throughput * sc.attenuation, throughput)
        active = active & sc.scattered

        # Weak-ray cutoff and Russian roulette after bounce 10
        # (camera.hpp:967-983).
        late = bounce > RR_START_BOUNCE
        if late:
            active = active & ~(vecmath.length(throughput) < WEAK_RAY_EPS)
            p = torch.clamp(throughput.amax(-1), RR_P_MIN, RR_P_MAX)
            u = rng.draw_uniform(lr, rng.STREAM_RR)
            active = active & ~(u > p)
            throughput = torch.where(active[:, None], throughput / p[:, None],
                                     throughput)
        origin = torch.where(active[:, None], sc.origin, origin)
        direction = torch.where(active[:, None], sc.direction, direction)
    return radiance


def render_sample(scene, tables, cam, env, seed: int, config: RenderConfig,
                  pixel_ids, sample_ids, stats=None) -> SampleBuffers:
    """One wavefront of (pixel, sample) lanes: every buffer's contribution
    f32[n, 3] per lane (camera.hpp:454-527). pixel_ids, sample_ids: i64[n]
    row-major pixel and absolute sample indices; seed is the u32 seed.
    Draws depend only on (seed, pixel, sample, bounce, stream). tables: the
    scene's intersect.hit_tables, built once per render by the caller."""
    n = pixel_ids.shape[0]
    dev = pixel_ids.device
    zeros = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    lr = rng.lane_rng(seed, pixel_ids, sample_ids)
    lr0 = lr.with_ctx(0, 0)   # camera segment, beauty pass

    o, d = camera_mod.generate_rays(cam, lr0, pixel_ids, config.width)
    if stats is not None:
        stats["segments"] += n
    first = intersect.intersect(scene, o, d, T_MIN, tables)
    rec = intersect.make_record(scene, o, d, first)
    rec = volumes.apply_to_record(scene.volumes, o, d, first, rec, lr0)
    hit_mask = rec.hit
    bg = env_mod.background_color(env, d, config.env_mode)
    trace_kw = dict(max_bounces=config.max_depth - 1, env_mode=config.env_mode,
                    stats=stats, tables=tables)

    # Beauty: the first hit is shared (camera.hpp:989-1004).
    sc = shade.scatter(scene, rec, d, lr0)
    beauty = trace(scene, env, sc.origin, sc.direction, lr,
                   throughput=sc.attenuation, active=hit_mask & sc.scattered,
                   **trace_kw)
    beauty = torch.where(hit_mask[:, None], sc.emitted + beauty, bg)

    # AOVs from the first hit (camera.hpp:463-487, 518-526).
    albedo = normal = z_depth = zeros
    if config.use_albedo:
        albedo = torch.where(hit_mask[:, None], shade.get_albedo(scene, rec),
                             0.0)
    if config.use_normal:
        miss_color = zeros.new_tensor([0.5, 0.5, 1.0])   # camera.hpp:523
        normal = torch.where(hit_mask[:, None],
                             camera_mod.view_space_normal_color(cam, rec.normal),
                             miss_color)
    if config.use_z_depth:
        zval = 1.0 - torch.clamp(rec.t / config.z_depth_max_dist, 0.0, 1.0)
        z_depth = torch.where(hit_mask[:, None], zval[:, None], 0.0).expand(n, 3)

    # Reflection/refraction split pass: the first hit re-scattered with
    # context (0, 1) (camera.hpp:490-517).
    reflection = refraction = zeros
    if config.use_reflection or config.use_refraction:
        sc2 = shade.scatter(scene, rec, d, lr.with_ctx(0, 1))
        spec_active = hit_mask & sc2.scattered
        color = trace(scene, env, sc2.origin, sc2.direction, lr,
                      active=spec_active, spec=1, **trace_kw)
        # Firefly clamp on 0.2126 |color|: the reference takes the vector's
        # length, not its luminance (camera.hpp:499-504).
        luma = 0.2126 * vecmath.length(color)
        scale = torch.where(luma > 2.0, 2.0 / torch.clamp(luma, min=1e-12), 1.0)
        color = color * scale[:, None]
        reflected = vecmath.reflect(vecmath.normalize(d),
                                    vecmath.normalize(rec.normal))
        is_specular = vecmath.dot(vecmath.normalize(sc2.direction),
                                  reflected) > 0.9
        contrib = sc2.attenuation * color
        if config.use_reflection:
            reflection = torch.where((spec_active & is_specular)[:, None],
                                     contrib, 0.0)
        if config.use_refraction:
            entering = vecmath.dot(sc2.direction, rec.normal) < 0.0
            refraction = torch.where(
                (spec_active & ~is_specular & entering)[:, None], contrib, 0.0)
    return SampleBuffers(beauty=beauty, albedo=albedo, normal=normal,
                         z_depth=z_depth, reflection=reflection,
                         refraction=refraction)


# Lanes per chunk: samples are batched into one wavefront of up to this
# many (pixel, sample) lanes (the reference's auto-sizing target).
_TARGET_LANES = 400_000


def _accumulate_chunked(scene, cam, env, seed: int, config: RenderConfig,
                        sample_offset: int, stats: dict) -> SampleBuffers:
    dev = scene.spheres.center.device
    n = config.n_pixels
    spp = config.samples_per_pixel
    aux = min(config.aux_samples, spp)
    batch = config.samples_per_batch or max(1, _TARGET_LANES // max(n, 1))
    batch = min(batch, spp)
    pixel_ids = torch.arange(n, dtype=torch.int64, device=dev)
    lane_pix = pixel_ids.repeat(batch)
    lane_rel = torch.arange(batch, dtype=torch.int64,
                            device=dev).repeat_interleave(n)
    u32_seed = rng.seed_from_int(seed)
    acc = [torch.zeros((n, 3), dtype=torch.float32, device=dev)
           for _ in SampleBuffers._fields]
    tables = intersect.hit_tables(scene)
    for c0 in range(0, spp, batch):
        lane_samp = sample_offset + c0 + lane_rel
        valid = lane_samp < sample_offset + spp      # tail-chunk mask
        buf = render_sample(scene, tables, cam, env, u32_seed, config,
                            lane_pix, lane_samp, stats)
        is_aux = lane_samp < aux                     # camera.hpp:433, 464
        masks = (valid, valid & is_aux, valid & is_aux, valid & is_aux,
                 valid, valid)
        for k, (x, m) in enumerate(zip(buf, masks)):
            acc[k] = acc[k] + torch.where(m[:, None], x, 0.0).reshape(
                batch, n, 3).sum(0)
        stats["steps"] += 1
    return SampleBuffers(*acc)


def accumulate_samples(scene, cam, env, seed: int, config: RenderConfig,
                       sample_offset: int = 0, with_stats: bool = False):
    """Sums (not averages) of `samples_per_pixel` samples per pixel from
    `sample_offset` on, on the scene's device, so progressive renders keep
    accumulating. with_stats also returns {"segments", "steps"}: path
    segments traced, and pool steps (fused) or chunks (chunked)."""
    _check_supported(config)
    if not config.wavefront:
        stats = {"segments": 0, "steps": 0}
        out = _accumulate_chunked(scene, cam, env, seed, config,
                                  sample_offset, stats)
        return (out, stats) if with_stats else out
    from . import wavefront

    return wavefront.render_pool(scene, cam, env, seed, config, sample_offset,
                                 with_stats=with_stats)


def finalize_buffers(acc: SampleBuffers, config: RenderConfig,
                     total_samples=None) -> dict:
    """Averages over each buffer's sample budget (camera.hpp:529-541): spp
    for beauty and the split passes, the aux budget for the AOVs. Returns a
    dict of [H, W, 3] images."""
    spp = total_samples if total_samples is not None else config.samples_per_pixel
    aux = min(config.aux_samples, spp)
    shape = (config.height, config.width, 3)
    budgets = dict(beauty=spp, albedo=aux, normal=aux, z_depth=aux,
                   reflection=spp, refraction=spp)
    return {k: (getattr(acc, k) / b).reshape(shape) for k, b in budgets.items()}


def render(scene, cam, env, seed: int, config: RenderConfig, *,
           device=None, with_stats: bool = False):
    """Full-frame render on `device`: a dict of averaged f32[H, W, 3]
    buffers (beauty, albedo, normal, z_depth, reflection, refraction).

    device=None means "cuda", and raises when no CUDA device is present;
    pass device="cpu" to run the plain PyTorch versions of the kernels.
    seed is an integer; lane streams match the reference package's render
    with PRNGKey(seed). with_stats also returns {"segments", "steps"}."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "render() runs on the card by default and no CUDA device is "
                "present; pass device='cpu' to render on the CPU")
        device = "cuda"
    device = torch.device(device)
    _check_supported(config)
    scene, cam, env = scene.to(device), cam.to(device), env.to(device)
    res = accumulate_samples(scene, cam, env, seed, config,
                             with_stats=with_stats)
    if with_stats:
        acc, stats = res
        return finalize_buffers(acc, config), stats
    return finalize_buffers(res, config)
