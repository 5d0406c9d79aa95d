"""Pixel-window rendering over several devices (twin of
raytracer_project_tpu/parallel/render.py).

A mesh is a list of torch.device. The frame's pixels, padded to a multiple
of the mesh size, split into one window per entry: window i renders on
mesh[i], with the scene, camera and environment copied there. Listing one
device several times (the same card, or the CPU) stands in for several
devices, as the reference's tests use virtual CPU devices. Lane streams
are (pixel, sample)-keyed, so a sharded render equals the one-device
render up to the order in which a pixel's samples are summed.

Shards run one after the other from the host; where the mesh holds
distinct CUDA devices, each device's shards launch on a stream of its own.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import integrator


def make_mesh(n_devices: int | None = None, device=None) -> list:
    """A mesh of n_devices entries: the card's CUDA devices (all of them by
    default), or `device` repeated n_devices times."""
    if device is not None:
        return [torch.device(device)] * (n_devices or 1)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a CPU mesh")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs[:n_devices] if n_devices is not None else devs


def _padded_pixel_ids(n_pixels: int, n_shards: int) -> np.ndarray:
    """Global pixel ids padded to a multiple of n_shards: the padding slots
    re-render pixel n_pixels - 1 and are dropped on unpad."""
    padded = -(-n_pixels // n_shards) * n_shards
    return np.minimum(np.arange(padded, dtype=np.int64), n_pixels - 1)


def _shard_context(dev, streams: dict):
    if dev.type != "cuda" or len(streams) < 2:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(dev))
    stack.enter_context(torch.cuda.stream(streams[dev]))
    return stack


def sharded_accumulate(scene, cam, env, seed: int, config, ids_padded,
                       sample_offset: int = 0, *, mesh, with_stats: bool = False,
                       aux: int | None = None):
    """integrator.accumulate_samples with the pixels split over `mesh`:
    per-pixel sums f32[len(ids_padded), 3] on mesh[0].

    ids_padded (length a multiple of the mesh size) in the clamped-identity
    pattern of _padded_pixel_ids renders each shard as an identity pixel
    window (pixel_offset = shard * n_local), the fused pool's route; any
    other id list renders each shard's slice as explicit pixel ids.
    with_stats also returns {"segments": summed over shards, "steps": the
    most of any shard}. aux: accumulate_samples' AOV budget."""
    n_shards = len(mesh)
    ids = np.asarray(torch.as_tensor(ids_padded).cpu())
    if ids.shape[0] % n_shards:
        raise ValueError(f"{ids.shape[0]} pixel ids do not split over "
                         f"{n_shards} shards")
    n_local = ids.shape[0] // n_shards
    window = bool(np.array_equal(
        ids, np.minimum(np.arange(ids.shape[0]), config.n_pixels - 1)))
    streams = {d: torch.cuda.Stream(device=d) for d in set(mesh)
               if d.type == "cuda"} if len(set(mesh)) > 1 else {}
    placed = {}
    parts, segments, steps = [], 0, 0
    for i, dev in enumerate(mesh):
        if dev not in placed:
            placed[dev] = (scene.to(dev), cam.to(dev), env.to(dev))
        sc, cm, en = placed[dev]
        with _shard_context(dev, streams):
            if window:
                kw = dict(pixel_offset=i * n_local, n_pixels_local=n_local)
                pix = None
            else:
                kw = {}
                pix = torch.as_tensor(ids[i * n_local:(i + 1) * n_local],
                                      device=dev)
            buf, st = integrator.accumulate_samples(
                sc, cm, en, seed, config, pix, sample_offset, with_stats=True,
                aux=aux, **kw)
        parts.append(buf)
        segments += st["segments"]
        steps = max(steps, st["steps"])
    for s in streams.values():
        s.synchronize()
    out = integrator.SampleBuffers(*(
        torch.cat([getattr(b, f).to(mesh[0]) for b in parts])
        for f in integrator.SampleBuffers._fields))
    if with_stats:
        return out, {"segments": segments, "steps": steps}
    return out


def render_sharded(scene, cam, env, seed: int, config, mesh) -> dict:
    """A full render with the pixels split over `mesh`: the [H, W, 3]
    buffer dict of integrator.render, on mesh[0]."""
    n = config.n_pixels
    ids = _padded_pixel_ids(n, len(mesh))
    acc = sharded_accumulate(scene, cam, env, seed, config, ids, 0, mesh=mesh)
    return integrator.finalize_buffers(
        integrator.SampleBuffers(*(x[:n] for x in acc)), config)


def analyze_sharded(image_flat, mesh):
    """post.ImageStatistics of a flat [N, 3] image whose pixels are split
    over `mesh` (N a multiple of the mesh size), from each window's
    reductions on its device (post.analyze_framebuffer_psum)."""
    from ..ops import post

    windows = [w.to(d) for w, d in zip(torch.chunk(image_flat, len(mesh)), mesh)]
    return post.analyze_framebuffer_psum(windows)
