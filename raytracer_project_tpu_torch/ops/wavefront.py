"""Pooled-wavefront dispatch (twin of raytracer_project_tpu/ops/wavefront.py,
`render_pool`'s fused route only).

The port has one pool engine, the fused step (ops/fused_step.py). Renders
whose work exceeds the fused work-id cap (2^24 lane decodes in f32) are
split into sample chunks; lane RNG streams are (pixel, sample)-keyed, so
the chunk sums equal one oversized call's. The chunked integrator
(RenderConfig(wavefront=False), ops/integrator.py) is the other engine;
the unfused pool waits for pixel windows (ROADMAP queue 1, the unfused
pool).
"""

from __future__ import annotations

import dataclasses

from . import fused_step


def render_pool(scene, cam, env, seed: int, config, sample_offset: int = 0,
                with_stats: bool = False):
    """Per-pixel sums of the full frame, integrator.SampleBuffers (see
    fused_step.render_pool_fused). Every sample chunk counts its AOV
    samples against the whole render's budget min(aux_samples, spp): a
    chunk's own spp would leave the later chunks' AOV samples uncounted."""
    spp = config.samples_per_pixel
    chunk = fused_step.fused_spp_chunk(scene, config, env)
    if chunk <= 0:
        raise NotImplementedError(
            "this render is outside the fused step (textured fog, or a "
            "texture atlas or HDR map of 2^24 texels or more); the unfused "
            "pool is in ROADMAP queue 1, the unfused pool")
    aux = min(config.aux_samples, spp)
    out = None
    segments = steps = 0
    for off in range(0, spp, chunk):
        cfg_c = dataclasses.replace(config,
                                    samples_per_pixel=min(chunk, spp - off))
        res, st = fused_step.render_pool_fused(
            scene, cam, env, seed, cfg_c, aux, sample_offset + off,
            with_stats=True)
        segments += st["segments"]
        steps += st["steps"]
        out = res if out is None else type(res)(*(a + b for a, b in
                                                   zip(out, res)))
    if with_stats:
        return out, {"segments": segments, "steps": steps}
    return out
