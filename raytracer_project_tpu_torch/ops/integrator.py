"""Render entry point and the chunked integrator (twin of
raytracer_project_tpu/ops/integrator.py).

`render` runs on the card unless the caller asks for another device, by
one of two engines, each with all six buffers and fog:
  * wavefront=True (the default): the pooled wavefront (ops/wavefront.py):
    the fused pool (ops/fused_step.py), or the unfused pool for textured
    fog, explicit pixel ids and RAYTRACER_TPU_NO_FUSED;
  * wavefront=False: the chunked integrator below. Each
    chunk is one wavefront of (pixel, sample) lanes that follows the
    reference's per-sample structure (camera.hpp:454-527): one first hit
    shared by beauty, the AOVs and the split passes, then a bounce loop
    (camera.hpp:928-986) that intersects every lane on every bounce
    through intersect.intersect (K4 on the card) until all lanes are dead.
    With differentiable=True (the engine it always takes) every search is
    intersect.intersect_detached, and the buffers carry autograd gradients
    to the scene, camera and environment tensors that require them.
`accumulate_samples` renders a pixel window or a list of pixels
(parallel/render.py shards frames that way).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core import rng, vecmath
from ..core.tree import tree_map
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
    # Pool size (None: the fused pool takes min(total work, 131072) rounded
    # up to 4096, the unfused pool min(total work, 262144)).
    pool_lanes: int | None = None
    # Re-sort the unfused pool's lanes by direction octant and origin cell
    # after every step (wavefront._coherence_order); off by default, as in
    # the reference (integrator.py:89-94). The fused pool ignores it.
    sort_lanes: bool = False

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


def _check_grad(scene, cam, env, config: RenderConfig) -> None:
    """Raise where a gradient would be cut silently: a render outside the
    differentiable mode, with grad enabled, of inputs that require grad
    (the kernels record nothing for autograd). The reference's jax.grad
    through its bounce while_loop raises the same way."""
    if config.differentiable or not torch.is_grad_enabled():
        return
    leaves = []
    tree_map(leaves.append, (scene, cam, env))
    if any(isinstance(x, torch.Tensor) and x.requires_grad for x in leaves):
        raise ValueError(
            "an input requires grad but the render is not differentiable: "
            "pass RenderConfig(differentiable=True), or render under "
            "torch.no_grad()")


def trace(scene, env, origin, direction, lane_rng: rng.LaneRng, *,
          tables, max_bounces: int, env_mode: int, throughput=None,
          radiance=None, active=None, spec: int = 0, stats=None,
          differentiable: bool = False):
    """Bounce loop (camera.hpp:928-986) over a wavefront: radiance f32[N, 3].

    Bounce b draws from context (b + 1, spec): the camera segment is
    bounce 0. Every lane is intersected on every bounce, dead ones
    included; the loop ends after max_bounces or once no lane is live (one
    host read per bounce). stats["segments"], when given, adds the live
    lanes of each bounce. tables: the scene's intersect.hit_tables.

    differentiable: intersect through intersect.intersect_detached. The
    reference runs a fixed max_bounces there (a fori_loop, since its
    while_loop has no transpose); autograd needs no such loop, and a bounce
    with no live lane changes no value and no gradient, so the early exit
    stays."""
    find = intersect.intersect_detached if differentiable else intersect.intersect
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
        hit = find(scene, origin, direction, T_MIN, tables)
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
    find = (intersect.intersect_detached if config.differentiable
            else intersect.intersect)
    first = find(scene, o, d, T_MIN, tables)
    rec = intersect.make_record(scene, o, d, first)
    rec = volumes.apply_to_record(scene.volumes, o, d, first, rec, lr0)
    hit_mask = rec.hit
    bg = env_mod.background_color(env, d, config.env_mode)
    trace_kw = dict(max_bounces=config.max_depth - 1, env_mode=config.env_mode,
                    stats=stats, tables=tables,
                    differentiable=config.differentiable)

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
                        pixel_ids, sample_offset: int, stats: dict,
                        aux: int) -> SampleBuffers:
    n = pixel_ids.shape[0]
    dev = pixel_ids.device
    spp = config.samples_per_pixel
    batch = config.samples_per_batch or max(1, _TARGET_LANES // max(n, 1))
    batch = min(batch, spp)
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
                       pixel_ids=None, sample_offset: int = 0,
                       with_stats: bool = False, pixel_offset: int = 0,
                       n_pixels_local: int | None = None,
                       aux: int | None = None):
    """Sums (not averages) of `samples_per_pixel` samples per pixel from
    `sample_offset` on, on the scene's device, so progressive renders and
    sharded renders keep accumulating (reference accumulate_samples,
    integrator.py:340-390). The camera and environment follow the scene to
    its device.

    pixel_ids None is the full frame or, with n_pixels_local, the pixel
    window [pixel_offset, pixel_offset + n_pixels_local) clamped to the
    frame (trailing slots re-render the last pixel); otherwise the global
    pixel ids [n] to render. Lane streams are (pixel, sample)-keyed, so a
    pixel's sum is the same whichever way the frame is split.

    with_stats also returns {"segments", "steps"}: path segments traced,
    and pool steps (with "engine": "fused" | "pool") or chunks (chunked);
    the fused pool adds "scatters", the segments that end in a medium.

    aux is the AOV budget: the AOVs sum the samples whose absolute id is
    below it. None means this call's min(aux_samples, samples_per_pixel),
    the reference's per-call budget. A progressive render passes the whole
    render's budget, so that every chunk counts its AOV samples
    (utils/session.py).

    differentiable=True takes the chunked engine whatever `wavefront` says
    (the pools' kernels are not differentiable, in either package), and
    the sums carry autograd gradients; without it, inputs that require
    grad raise ValueError while grad is enabled."""
    _check_grad(scene, cam, env, config)
    dev = scene.spheres.center.device
    cam, env = cam.to(dev), env.to(dev)
    if aux is None:
        aux = min(config.aux_samples, config.samples_per_pixel)
    if config.wavefront and not config.differentiable:
        from . import wavefront

        return wavefront.render_pool(
            scene, cam, env, seed, config, pixel_ids, sample_offset,
            with_stats=with_stats, pixel_offset=pixel_offset,
            n_pixels_local=n_pixels_local, aux=aux)
    if pixel_ids is not None and n_pixels_local is not None:
        raise ValueError("a pixel window takes pixel_ids=None")
    if pixel_ids is None:
        if n_pixels_local is None:
            pixel_ids = torch.arange(config.n_pixels, device=dev)
        else:
            pixel_ids = torch.clamp(
                pixel_offset + torch.arange(n_pixels_local, device=dev),
                max=config.n_pixels - 1)
    pixel_ids = torch.as_tensor(pixel_ids).to(dev, torch.int64)
    stats = {"segments": 0, "steps": 0}
    out = _accumulate_chunked(scene, cam, env, seed, config, pixel_ids,
                              sample_offset, stats, aux)
    return (out, stats) if with_stats else out


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


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: None means "cuda". A CUDA device
    raises when none is present (there is no fallback to the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the card by default and no CUDA device is "
            "present; pass device='cpu' to run on the CPU")
    return device


def render(scene, cam, env, seed: int, config: RenderConfig, *,
           device=None, with_stats: bool = False):
    """Full-frame render on `device`: a dict of averaged f32[H, W, 3]
    buffers (beauty, albedo, normal, z_depth, reflection, refraction).

    device=None means "cuda", and raises when no CUDA device is present;
    pass device="cpu" to run the plain PyTorch versions of the kernels.
    seed is an integer or an rng.Key; lane streams match the reference
    package's render with PRNGKey(seed) (with the key of that data).
    with_stats also returns accumulate_samples' stats."""
    device = resolve_device(device)
    scene, cam, env = scene.to(device), cam.to(device), env.to(device)
    res = accumulate_samples(scene, cam, env, seed, config,
                             with_stats=with_stats)
    if with_stats:
        acc, stats = res
        return finalize_buffers(acc, config), stats
    return finalize_buffers(res, config)
