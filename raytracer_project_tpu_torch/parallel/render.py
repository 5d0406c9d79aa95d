"""Pixel-window rendering over several devices (twin of
raytracer_project_tpu/parallel/render.py).

A mesh is a list of torch.device. The frame's pixels, padded to a multiple
of the mesh size, split into one window per entry: window i renders on
mesh[i], with the scene, camera and environment copied there. Listing one
device several times (the same card, or the CPU) stands in for several
devices, as the reference's tests use virtual CPU devices. Lane streams
are (pixel, sample)-keyed, so a sharded render equals the one-device
render up to the order in which a pixel's samples are summed.

Every window renders at once, as the reference's shard_map runs every
device of its mesh: each in a worker thread of its own. A CUDA window's
thread makes the window's card its current device and renders on a stream
of its own (the same stream for the same window of every call, so the
fused pool's captured steps, kept per stream, serve the next call too),
so windows on distinct cards run side by side, and windows on
one card overlap their waits on it (the fused pool reads its live count
every step). The threads share the interpreter, so the CUDA windows take
turns at the host (fused_step.HostTurns): one runs host code while the
others wait on their cards; only the waits overlap. CPU windows run their
ops side by side, outside the interpreter lock. The caller joins every
thread before it assembles the windows; an exception in a window is
raised in the caller, with the window's index in its notes. No window is
dropped or retried.

A window's thread writes no state of the process other than the kernels'
launch counts and, at a first launch, the table of loaded libraries (both
under locks, kernels.py). Every window reads RAYTRACER_TPU_NO_FUSED, which
must not change while a render runs.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading

import numpy as np
import torch

from ..ops import fused_step, integrator
from ..utils import spans


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


def _indexed(dev) -> torch.device:
    """dev with its index: a bare "cuda" is the caller's current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


_streams = {}
_streams_lock = threading.Lock()


def _window_stream(dev, k: int):
    """The stream of the k-th window of a call on the card dev."""
    with _streams_lock:
        stream = _streams.get((dev, k))
        if stream is None:
            stream = _streams[(dev, k)] = torch.cuda.Stream(device=dev)
        return stream


def _in_window(fn, dev, stream, turns, grad: bool):
    """fn() in a window's thread, as the span `window.render`: on a CUDA
    device, with the device current, `stream` the current stream (finished
    when fn returns) and the host taken in turns with the other CUDA windows
    (`turns`)."""
    with torch.set_grad_enabled(grad), spans.span("window.render"):
        if dev.type != "cuda":
            return fn()
        torch.cuda.set_device(dev)
        with torch.cuda.stream(stream):
            with turns.held():
                out = fn()
            stream.synchronize()
        return out


def run_windows(fns, devices) -> list:
    """fns[i]() on devices[i], every one in a thread of its own, all at once
    (see the module's docstring); their results in order, once every thread
    has ended. The first window (in order) that raised raises here, with
    "window i of n on <device>" added to its notes."""
    devices = [_indexed(d) for d in devices]
    streams, on_card = [], collections.Counter()
    for dev in devices:
        stream = None
        if dev.type == "cuda":
            stream = _window_stream(dev, on_card[dev])
            on_card[dev] += 1
            # The window starts after the caller's work on the device (the
            # scene's copy there, its inputs).
            stream.wait_stream(torch.cuda.current_stream(dev))
        streams.append(stream)
    grad, turns = torch.is_grad_enabled(), fused_step.HostTurns()
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=len(devices), thread_name_prefix="window") as pool:
        futures = [pool.submit(_in_window, fn, dev, stream, turns, grad)
                   for fn, dev, stream in zip(fns, devices, streams)]
    for i, (fut, dev) in enumerate(zip(futures, devices)):
        err = fut.exception()
        if err is not None:
            err.add_note(f"window {i} of {len(devices)} on {dev}")
            raise err
    return [fut.result() for fut in futures]


def sharded_accumulate(scene, cam, env, seed: int, config, ids_padded,
                       sample_offset: int = 0, *, mesh, windows=None,
                       with_stats: bool = False, aux: int | None = None):
    """integrator.accumulate_samples with the pixels split over `mesh`, each
    window in a thread of its own (run_windows): per-pixel sums
    f32[rows, 3] of the windows `windows` (indices into mesh, all of them
    by default), concatenated in that order on the device of the first.

    ids_padded (length a multiple of the mesh size) in the clamped-identity
    pattern of _padded_pixel_ids renders each window as an identity pixel
    window (pixel_offset = i * n_local), the fused pool's route; any
    other id list renders each window's slice as explicit pixel ids.
    with_stats also returns {"segments": summed over the windows, "steps":
    the most of any window}, and "scatters" summed where every window
    reports it (the fused pool). aux: accumulate_samples' AOV budget."""
    n_shards = len(mesh)
    ids = np.asarray(torch.as_tensor(ids_padded).cpu())
    if ids.shape[0] % n_shards:
        raise ValueError(f"{ids.shape[0]} pixel ids do not split over "
                         f"{n_shards} shards")
    windows = list(range(n_shards)) if windows is None else list(windows)
    n_local = ids.shape[0] // n_shards
    window = bool(np.array_equal(
        ids, np.minimum(np.arange(ids.shape[0]), config.n_pixels - 1)))
    devices = [_indexed(mesh[i]) for i in windows]
    placed = {}
    for dev in devices:
        if dev not in placed:
            placed[dev] = (scene.to(dev), cam.to(dev), env.to(dev))

    def render(i, dev):
        if window:
            kw = dict(pixel_offset=i * n_local, n_pixels_local=n_local)
            pix = None
        else:
            kw = {}
            pix = torch.as_tensor(ids[i * n_local:(i + 1) * n_local],
                                  device=dev)
        return integrator.accumulate_samples(
            *placed[dev], seed, config, pix, sample_offset, with_stats=True,
            aux=aux, **kw)

    results = run_windows(
        [lambda i=i, dev=dev: render(i, dev) for i, dev in zip(windows, devices)],
        devices)
    home = devices[0]
    fields = []
    for f in integrator.SampleBuffers._fields:
        parts = []
        for buf, _ in results:
            x = getattr(buf, f)
            if x.device.type == "cuda":
                # Made on the window's stream, read on the caller's.
                x.record_stream(torch.cuda.current_stream(x.device))
            parts.append(x.to(home))
        fields.append(torch.cat(parts))
    out = integrator.SampleBuffers(*fields)
    if with_stats:
        stats = {"segments": sum(st["segments"] for _, st in results),
                 "steps": max(st["steps"] for _, st in results)}
        if all("scatters" in st for _, st in results):
            stats["scatters"] = sum(st["scatters"] for _, st in results)
        return out, stats
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
