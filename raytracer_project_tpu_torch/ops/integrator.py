"""Render entry point (twin of raytracer_project_tpu/ops/integrator.py,
subset).

`render` runs the fused pooled wavefront (ops/wavefront.py ->
ops/fused_step.py) on the card unless the caller asks for another device.
Beauty only in this slice: the AOVs, the reflection/refraction passes, the
chunked integrator and the differentiable mode raise NotImplementedError
with the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.constants import Z_DEPTH_MAX_DIST
from ..models import environment as env_mod


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
    differentiable: bool = False
    wavefront: bool = True
    # Pool size (None = min(total work, 131072), rounded up to 4096).
    pool_lanes: int | None = None

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


class SampleBuffers(NamedTuple):
    """Per-pixel sums, f32[N, 3] (N = W*H, row-major). Beauty only in this
    slice; the AOV and spec-pass buffers come with the code that fills
    them (ROADMAP queue 1: fused features)."""

    beauty: torch.Tensor


def _check_supported(config: RenderConfig) -> None:
    if config.use_albedo or config.use_normal or config.use_z_depth:
        raise NotImplementedError(
            "AOV buffers are not ported yet (ROADMAP queue 1: fused features "
            "-- AOVs, spec passes, fog); set use_albedo/use_normal/"
            "use_z_depth=False")
    if config.use_reflection or config.use_refraction:
        raise NotImplementedError(
            "reflection/refraction passes are not ported yet (ROADMAP queue "
            "1: fused features -- AOVs, spec passes, fog)")
    if config.differentiable:
        raise NotImplementedError(
            "differentiable mode is not ported yet (ROADMAP queue 1: "
            "differentiable mode)")
    if not config.wavefront:
        raise NotImplementedError(
            "the chunked integrator is not ported yet (ROADMAP queue 1: "
            "unfused pool and chunked integrator)")


def accumulate_samples(scene, cam, env, seed: int, config: RenderConfig,
                       sample_offset: int = 0, with_stats: bool = False):
    """Sums (not averages) of `samples_per_pixel` samples per pixel from
    `sample_offset` on, on the scene's device, so progressive renders keep
    accumulating. with_stats also returns {"segments", "steps"}."""
    from . import wavefront

    _check_supported(config)
    res = wavefront.render_pool(scene, cam, env, seed, config, sample_offset,
                                with_stats=with_stats)
    beauty, stats = res if with_stats else (res, None)
    out = SampleBuffers(beauty=beauty)
    return (out, stats) if with_stats else out


def finalize_buffers(acc: SampleBuffers, config: RenderConfig,
                     total_samples=None) -> dict:
    """Averages over the samples taken (camera.hpp:529-541): dict of
    [H, W, 3] images."""
    spp = total_samples if total_samples is not None else config.samples_per_pixel
    shape = (config.height, config.width, 3)
    return {"beauty": (acc.beauty / spp).reshape(shape)}


def render(scene, cam, env, seed: int, config: RenderConfig, *,
           device=None, with_stats: bool = False):
    """Full-frame render: {"beauty": f32[H, W, 3]} averaged, on `device`.

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
