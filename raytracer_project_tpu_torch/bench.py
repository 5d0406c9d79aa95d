"""Benchmark entry point of the port (the counterpart of the repository's
bench.py): renders a scene and prints one JSON line with bench.py's keys.

    python -m raytracer_project_tpu_torch.bench

The headline `value` is measured path segments per second: segments traced
(the pool's exact counter, or the chunked integrator's live lanes) over the
wall seconds of the best of two seeded renders after one warm-up render.
`detail.rays_per_s_upper_bound` is the reference UI's
width*height*spp*max_depth / wall estimator (main.cpp:101-113);
`vs_baseline` is value / 1e9 (BASELINE.md's north star).

Before anything is timed, the smoke gate (`python -m
raytracer_project_tpu_torch.utils.smoke --device <the bench's device>`;
SMOKE_FAST=1 runs its first stage only) runs in a subprocess under a
timeout, as the reference's bench runs its smoke module: a hung kernel
cannot be interrupted in-process. If it fails or times out, the bench
prints a JSON line with an `error` key and exits 1; it does not retry on
another engine.

Knobs (environment): BENCH_WIDTH, BENCH_HEIGHT, BENCH_SPP, BENCH_DEPTH
(800, 450, 32, 10); BENCH_SCENE=funnel (the BVH stress world,
bvh_stress_scene(n_spheres=8192, mesh_detail=2), ~25k primitives; default
the showcase); BENCH_NO_WAVEFRONT (the chunked integrator instead of the
fused pool); BENCH_SKIP_SMOKE (no gate); BENCH_SMOKE_TIMEOUT (the gate's
seconds, 420); BENCH_SKIP_1080P, BENCH_1080P_SPP (the 1920x1080
sample-chunked datapoint, 32 spp); BENCH_DEVICE (default cuda; cpu runs the
kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

NORTH_STAR_RAYS_PER_S = 1.0e9
SHOWCASE_CAM = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0),
                    lookat=(0.0, 1.0, 0.0), defocus_angle=0.0, focus_dist=10.0)
FUNNEL_CAM = dict(vfov=35.0, lookfrom=(5.0, 6.0, 6.0), lookat=(5.0, 4.0, -12.0))
SUN = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)


def _device() -> torch.device:
    return torch.device(os.environ.get("BENCH_DEVICE", "cuda"))


def _device_names(dev: torch.device) -> list[str]:
    if dev.type == "cuda":
        return [f"{dev} {torch.cuda.get_device_name(dev)}"]
    return [str(dev)]


def run_gate() -> str | None:
    """Run the smoke gate on the bench's device in a subprocess under
    BENCH_SMOKE_TIMEOUT seconds. The reason it failed, or None."""
    timeout = int(os.environ.get("BENCH_SMOKE_TIMEOUT", 420))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "raytracer_project_tpu_torch.utils.smoke",
             "--device", str(_device())],
            cwd=Path(__file__).resolve().parent.parent,
            capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return f"gate timed out after {timeout} s"
    if proc.returncode != 0:
        return (f"gate failed (exit {proc.returncode}): "
                f"{(proc.stderr or proc.stdout)[-1500:]}")
    return None


def _scene_and_camera(width: int, height: int):
    from .models import camera, presets

    if os.environ.get("BENCH_SCENE") == "funnel":
        scene = presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2)
        cam_kw = FUNNEL_CAM
    else:
        scene = presets.showcase_scene(with_bvh=True, with_meshes=True)
        cam_kw = SHOWCASE_CAM
    return scene, camera.make_camera(image_width=width, image_height=height,
                                     **cam_kw)


def _timed(scene, cam, env, seed: int, cfg, dev):
    """(wall seconds, stats) of one render, its image read back."""
    from .ops import integrator

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out, stats = integrator.render(scene, cam, env, seed, cfg, device=dev,
                                   with_stats=True)
    out["beauty"].cpu()
    return time.perf_counter() - t0, stats


def main() -> int:
    from .models import camera, environment
    from .ops import intersect, integrator

    engine = "chunked" if os.environ.get("BENCH_NO_WAVEFRONT") else "fused"
    if not os.environ.get("BENCH_SKIP_SMOKE"):
        why = run_gate()
        if why is not None:
            print(json.dumps({
                "metric": "rays_per_second_showcase", "value": 0.0,
                "unit": "rays/s", "vs_baseline": 0.0,
                "error": f"gate failed on the {engine} bench: {why}"[:2000]}),
                flush=True)
            return 1

    dev = _device()
    width = int(os.environ.get("BENCH_WIDTH", 800))
    height = int(os.environ.get("BENCH_HEIGHT", 450))
    spp = int(os.environ.get("BENCH_SPP", 32))
    max_depth = int(os.environ.get("BENCH_DEPTH", 10))
    scene, cam = _scene_and_camera(width, height)
    cfg = integrator.RenderConfig(
        width=width, height=height, samples_per_pixel=spp, max_depth=max_depth,
        env_mode=environment.PHYSICAL_SUN, use_albedo=False, use_normal=False,
        use_z_depth=False, wavefront=engine == "fused")
    env = environment.make_environment(**SUN)

    _timed(scene, cam, env, 0, cfg, dev)   # warm-up
    dt, stats = min((_timed(scene, cam, env, rep, cfg, dev) for rep in (1, 2)),
                    key=lambda r: r[0])
    upper_bound = width * height * spp * max_depth / dt
    segments = float(stats["segments"])
    measured = segments / dt

    hd = None
    if not os.environ.get("BENCH_SKIP_1080P"):
        hd_spp = int(os.environ.get("BENCH_1080P_SPP", 32))
        hd_cfg = dataclasses.replace(cfg, width=1920, height=1080,
                                     samples_per_pixel=hd_spp)
        hd_cam = camera.make_camera(image_width=1920, image_height=1080,
                                    **SHOWCASE_CAM)
        _timed(scene, hd_cam, env, 0, hd_cfg, dev)   # warm-up
        hd_dt, st_hd = _timed(scene, hd_cam, env, 3, hd_cfg, dev)
        hd = {
            "width": 1920, "height": 1080, "spp": hd_spp, "wall_s": hd_dt,
            "rays_per_s_measured": st_hd["segments"] / hd_dt,
            "segments_traced": float(st_hd["segments"]),
            "projected_wall_s_at_1024spp": hd_dt * 1024 / hd_spp,
        }

    print(json.dumps({
        "metric": "rays_per_second_showcase",
        "value": measured,
        "unit": "rays/s",
        "vs_baseline": measured / NORTH_STAR_RAYS_PER_S,
        "detail": {
            "width": width, "height": height, "spp": spp,
            "max_depth": max_depth, "wall_s": dt,
            "primitives": int(scene.primitive_count),
            "devices": _device_names(dev),
            "intersector": intersect.intersect_dispatch(scene, dev),
            "engine": engine,
            "rays_per_s_upper_bound": upper_bound,
            "rays_per_s_measured": measured,
            "segments_traced": segments,
            "pool_steps": int(stats["steps"]),
            "north_star_1080p": hd,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
