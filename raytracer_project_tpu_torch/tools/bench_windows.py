"""Four windows of one card timed in turns, with parts of the window
threads' design taken out.

    python -m raytracer_project_tpu_torch.tools.bench_windows [ROUNDS]

The showcase's main-path frame (800x450 @ 32 spp, depth 10, beauty,
PHYSICAL_SUN) split into 4 windows of cuda:0:
  threads        parallel/render.sharded_accumulate as it is: a thread, a
                 stream and host turns for each window;
  no_turns       the same with fused_step.HostTurns.held doing nothing, so
                 the threads run their host code side by side;
  serial         the four windows one after another in this thread;
  one_device     the frame in one accumulate_samples call.
Each is timed on the whole frame ("frame") and on 8 sample chunks of 4
spp, a progressive session's calls ("chunks"). Each round runs every
variant once, in an order rotated from round to round; ROUNDS rounds (5
by default) after one warm-up round. A timing is the wall between two
torch.cuda.synchronize() calls, with the cudaMalloc calls made inside it
(torch.cuda.memory_stats' num_device_alloc). Prints one JSON line per
timing, a summary (min, median, max wall per variant), the card's name
and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

VARIANTS = ("threads", "no_turns", "serial", "one_device")


def _frame():
    import torch

    from ..models import camera, environment, presets
    from ..ops import integrator

    cam = camera.make_camera(image_width=800, image_height=450, vfov=30.0,
                             lookfrom=(12.0, 2.5, 6.0),
                             lookat=(0.0, 1.0, 0.0), defocus_angle=0.0,
                             focus_dist=10.0)
    env = environment.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                       sun_intensity=6.0)
    cfg = integrator.RenderConfig(width=800, height=450, samples_per_pixel=32,
                                  max_depth=10, use_albedo=False,
                                  use_normal=False, use_z_depth=False)
    return presets.showcase_scene().to(torch.device("cuda", 0)), cam, env, cfg


@contextlib.contextmanager
def _variant(name: str):
    """The design with the part that `name` takes out."""
    from ..ops import fused_step

    held = fused_step.HostTurns.held
    if name == "no_turns":
        fused_step.HostTurns.held = lambda turns: contextlib.nullcontext()
    try:
        yield
    finally:
        fused_step.HostTurns.held = held


def _render(name: str, frame, chunks: int) -> None:
    """The frame in `chunks` sample chunks, the variant's way."""
    import torch

    from ..ops import integrator
    from ..parallel import render as prender

    scene, cam, env, cfg = frame
    spp = cfg.samples_per_pixel // chunks
    part = dataclasses.replace(cfg, samples_per_pixel=spp)
    ids = prender._padded_pixel_ids(cfg.n_pixels, 4)
    n_local = ids.shape[0] // 4
    for c in range(chunks):
        if name == "one_device":
            integrator.accumulate_samples(scene, cam, env, 0, part, None,
                                          c * spp, with_stats=True)
        elif name == "serial":
            for i in range(4):
                integrator.accumulate_samples(
                    scene, cam, env, 0, part, None, c * spp, with_stats=True,
                    pixel_offset=i * n_local, n_pixels_local=n_local)
        else:
            with _variant(name):
                prender.sharded_accumulate(
                    scene, cam, env, 0, part, ids, c * spp,
                    mesh=[torch.device("cuda", 0)] * 4, with_stats=True)


def _timed(name: str, frame, chunks: int) -> dict:
    import torch

    allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _render(name, frame, chunks)
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0,
            "mallocs": torch.cuda.memory_stats().get("num_device_alloc", 0)
            - allocs}


def main(rounds: int = 5) -> dict:
    import torch

    from .. import kernels

    if not torch.cuda.is_available():
        raise RuntimeError("bench_windows needs a CUDA device")
    kernels.build_all()
    frame = _frame()
    walls: dict = {}
    for r in range(rounds + 1):
        k = r % len(VARIANTS)
        for name in VARIANTS[k:] + VARIANTS[:k]:
            for case, chunks in (("frame", 1), ("chunks", 8)):
                res = _timed(name, frame, chunks)
                if r == 0:
                    continue   # the warm-up round
                res.update(case=case, variant=name, round=r)
                print(json.dumps(res), flush=True)
                walls.setdefault(case, {}).setdefault(name, []).append(
                    res["wall_s"])
    summary = {case: {name: {"min_s": min(w), "median_s": sorted(w)[len(w) // 2],
                             "max_s": max(w)} for name, w in by.items()}
               for case, by in walls.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"summary": summary, "card": smi}), flush=True)
    return summary


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
