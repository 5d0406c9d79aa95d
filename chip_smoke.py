#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (raytracer_project_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints flushed lines; any failure raises and exits non-zero):
  1. build     compile the CUDA kernels (csrc/*.cu, nvcc in parallel) and
               print the card's name and power limit;
  2. kernels   hold each kernel against its plain PyTorch version on the
               card at its path's shapes (K1, K2, K3 and K3 fused: 131,072
               lanes of showcase camera rays and one bounce of their
               scattered rays; K4: 360,000 lanes, the 800x450 camera rays
               and one scatter of them), the closest hits also against the
               exact brute-force oracle, K4 against K1, and K1 and K4 bit
               for bit against the dense 16-term scan of the first port
               (every lane with finite features; the others counted), both
               designs timed; K3 fused timed beside its yardstick (K2, the
               unfused K3 and the index_add_ they fed) with its recounted
               byte bound; the index_add_ it retired timed with its idle
               lanes on the dummy slot, dropped, and spread; the pool's
               start in one launch (start_kernel) against the plain torch
               fill, bit for bit, at the main path's 131,072 lanes and the
               preview's 90,000, timed with its byte bound;
  3. smoke     render the 64x36 @ 2 spp showcase (seed 0) through the
               smoke module's render_fused_fast and hold it to the smoke
               gate's two goldens (the device golden at mean |d| <= 1e-5,
               then the reference's CPU golden under the cross-backend
               budgets); the spread between three renders with the pool
               above and at or below the pixel count, and between three
               renders of the smoke frame; then `python -m
               raytracer_project_tpu_torch.utils.smoke` in a subprocess
               (exit 0, a device-golden diff for each of its five images,
               each stage's seconds) and with SMOKE_FAST=1;
  4. full      the fused main path: 800x450 @ 32 spp after one warm-up,
               with the launch counts read around it (K1 and K3 fused;
               K2 and the unfused K3 never), then 1920x1080 @ 8 spp (two
               sample chunks), and a profile: no index_add_, launches per
               step;
  5. chunked smoke  the chunked integrator (wavefront=False): 64x36 @ 8 spp
               depth 6 against the reference's CPU golden, and 32x18 @ 4 spp
               with all six buffers against the port's own CPU render;
  6. chunked full   the chunked path at full size: 800x450 @ 32 spp, depth
               10, the AOVs and both split passes on, with K4's launches
               read around it, and a profile of a 4 spp render;
  7. k3 features   K3's variant with fog, every AOV and both split passes
               against its plain version at 131,072 lanes (the fog
               showcase's camera rays with every other lane a spec lane,
               and one step of them), and K3 fused's, each timed with its
               byte bound, K3 fused beside its yardstick; the 18-channel
               index_add_ measured as in phase 2;
  8. features smoke  the fog showcase at 64x36 @ 4 spp with every AOV and
               both passes (the smoke module's render_fused_features)
               against its three device goldens and the reference's three
               `smoke_features_*` CPU goldens, and its spread over three
               renders;
  9. features full   the fused path with every feature at full size:
               800x450 @ 32 spp, depth 10, showcase_scene(use_fog=True),
               all six buffers, with the launch counts read around it, a
               profile, and the albedo AOV against a first-hit chunked
               render of the same frame;
 10. probes    the twins of the reference's kernel probes (tools/): P1,
               K1's own compact-row scan in four ablations on 262,144
               rays, beside its dense yardstick (the first port's probe;
               the SASS and registers of each variant logged beside K1's
               and checked for the work it keeps; full and nocull against
               K1 bit for bit), then K1's time split by P1 on the main
               path's bounce rays, the dense scan's beside it; P2 and P4,
               the one-hot row fetch in six layouts (in place and with the
               table staged in shared memory); P3, the decode stages d0-d2
               and d3 (= K2) on K1's hits of the showcase camera rays. Each
               variant runs through its entry with the counts read around
               it, is held against its plain version on the card, and is
               timed with its bound; P2-P4 and d0-d2 also equal their
               yardsticks (the first port's kernels) bit for bit and are
               timed beside them, with what sets their times (registers,
               stack frames, the fetch's ms per output, the stages on lanes
               sorted by primitive type, staging against lane count); last
               an empty kernel timed the same way, the launch floor under
               P2-P4, with each row's share of its bound with and without
               it;
 11. scenes smoke  the goldens past the showcase (Shirley, the foggy
               Cornell box, the HDRI scene) through integrator.render on
               both engines against the reference's CPU goldens;
 12. bvh traverse  the BVH traversal against the brute-force oracle on
               the card (bvh_stress_scene(9000), 512 funnel camera rays);
 13. funnel kernels  K1 and K4 on the funnel's (25,091 primitives) bounce
               rays against their plain versions, timed, with their bounds,
               and K1's time split by P1 on those rays;
     bvh kernel  the fused pool's closest hit over the BVH (bvh_hit.cu)
               on the funnel's 131,072 bounce lanes against K1's tile scan
               (t bit for bit on same-primitive hits, the counts logged)
               and against its plain traversal, on the showcase with the
               threshold lowered, on 0 and 1 lanes; timed beside K1;
 14. baseline configs  the fused pool at the published sizes: Shirley
               400x225 @ 16 spp, Cornell 512x512 @ 64 spp, the HDRI scene
               at 1920x1080 @ 8 spp, and the funnel at 800x450 @ 32 spp,
               each warmed up, timed and profiled;
 15. bench     `python -m raytracer_project_tpu_torch.bench` for the
               showcase and the funnel, each printing its JSON line;
 16. bench_bvh the traversal against K4 on 262,144 rays per case, and the
               BVH kernel against K1's tile scan on the same rays;
 17. pool smoke  the unfused pool (RAYTRACER_TPU_NO_FUSED=1): the 128x72 @
               4 spp showcase (the smoke module's render_pool) against its
               device golden and the reference's smoke_pool_128x72.npz,
               its spread over three renders, and the fog showcase with textured fog at 64x36 @ 4 spp (the
               route integrator.render takes for it) against the CPU;
 18. pool full the unfused pool at 800x450 @ 32 spp, beauty, depth 10, on
               the showcase and the funnel, sort_lanes off and on: wall,
               segments/s, steps, K1's launches and its ms per launch (CUDA
               events around each launch), a device-only profile;
 19. windows   K3 fused with pixel_offset != 0 against its plain version
               at 131,072 lanes, timed beside its yardstick; 4 windows of cuda:0 (render_sharded /
               sharded_accumulate, a thread each) on the fused pool over an
               801x451 frame, timed, and explicit pixel ids on the unfused
               pool and the chunked path, each against the one-window render;
     multicard the frame over several devices at once, at the main path's
               size (800x450 @ 32 spp, beauty, depth 10, 4 windows): (a) 4
               windows of cuda:0, a thread and a stream each, against the
               same windows rendered one after another and the one-device
               render (equal segments, rtol/atol 3e-4), walls in turns and
               the threads' overlap (the windows' walls summed over the
               whole wall); (b) a one-rank NCCL group through
               render_distributed, and its statistics reduced on the card;
               (d) where there are two cards or more, a mesh of every
               card, a spawned NCCL rank per card and, with four or more,
               ranks of two cards each (else one line saying that it did
               not run);
 20. sort rays K4 on the 360,000 bounce lanes with sort_rays off and on:
               equal hits, K4 timed on unsorted and sorted rays, the sort;
 21. two process  two spawned ranks on a gloo group (named: NCCL refuses
               two ranks on one card) render their windows of the 256x144 @
               8 spp showcase on cuda:0, against one process;
 22. post      the post chain (bloom, sharpening) card against CPU, window
               statistics against the image's, a PNG written under build/
               and read back;
 23. diff      the differentiable mode: D1 the chunked smoke's frame with
               differentiable=True (K4 on detached rays) against the CPU
               golden and the plain render; D2 the reference's tiny
               gradient scene, autograd card against CPU, and its five
               finite-difference checks on the card; D3 the differentiable
               cell (showcase, 400x225 @ 4 spp, depth 8, low sun) forward
               and backward timed, peak memory, K4's launches and ms, a
               profile; D4 20 Adam steps of fit from a perturbed albedo and
               a sun turned by ~10 degrees;
 24. denoise   Q1 the reference's denoise-quality gate (Shirley and Cornell
               at 96x54, 8 against 384 spp, the fused pool's AOVs) at its
               thresholds; Q2 both denoisers card against CPU; T1 a
               training run (tools/train_denoiser.py, 6 pairs, 200 steps):
               the loss falls, the weights written load back through
               load_params with the same output; Q3 both timed on the
               1920x1080 @ 8 spp showcase buffers, with peak memory and
               the U-Net's operation bound;
     tools     prof_fused_step at bench shapes, and the parity gallery's 16
               PNGs written under build/chip_smoke/parity and read back;
 25. frontend  the progressive session, the CLI and the interactive loop
               (outputs under build/frontend/): F1 `render` through
               cli.main, 800x450 @ 32 spp in chunks of 4 with four passes,
               the counts read around it, the beauty PNG and the AOV means
               against a one-shot integrator.render, then session and
               one-shot walls in turns; F2 a 16 spp checkpoint finished by
               `render --resume` against the uninterrupted sums; F3 a mesh
               of cuda:0 listed 4 times (a thread a window) against one
               device; F4
               `interactive` at 400x225 fed a command script (post edit,
               passes, stats, wire, camera edit, sun, saveall), K4's
               launches read around it; F5 --check-numerics and the NaN
               trap; F6 info and --profile;
then one JSON line of per-kernel numbers (K1 and K4 with the funnel's
numbers as funnel_*, K1's in the unfused pool as pool_*; K3 as K3 fused,
its unfused variant as unfused_*, K2 + K3 + index_add_ as yardstick_ms,
the accumulator measurement and the run-to-run spread; K2's launches
from P3's d3 run, none on the main path; K3 fused's window variant as
window_*, K4's sort_rays numbers and its diff_launches and diff_ms on the
differentiable path; session_launches of K1 and K3 fused on F1's session
frame and K4's wire_launches in F4; K1's split by P1 on both bounce sets
as split; P1's dense yardstick as P1_dense.*; P2-P4's and d0-d2's
yardstick_ms, P2-P4's in_place_ms and staged_ms, the 8,192-lane times as
*_8192, the shares of the bound, and under P2 "causes" the readings of
both builds; the launch floor with P2-P4),
the nvidia-smi line, and the device JSON line last.
Takes no arguments and always runs every phase.
Exits non-zero without a CUDA device, and outside a checkout of the repo.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
P_MAIN = 131_072
P_CHUNKED = 800 * 450
CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
              defocus_angle=0.0, focus_dist=10.0)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)
HDR_KW = dict(hdri_rotation=0.5, hdri_tilt=0.2, hdri_roll=0.1, intensity=0.8)
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# About 0.1 s of device sleep ahead of each timed round (at ~2 GHz).
SLEEP_CYCLES = 200_000_000
# The differentiable cell (phase diff, D3 and D4): width, height, spp. Its
# sun stands low behind the camera: the sky's colours depend on the sun's
# height only between about -7.2 and +2.3 degrees of elevation
# (camera.hpp:871-925; its azimuth shows only in the disc, which stays out
# of the frame). D4's fit starts with the sun FIT_SUN_DROP degrees lower,
# inside that band. The shader normalises the direction; stored at length
# DIFF_SUN_LENGTH, an Adam step of 2e-2 per component turns it by at most
# ~0.6 degrees, so 20 steps can cover the drop without Adam's momentum
# carrying the sun past +2.3 degrees, above which the image no longer
# depends on it.
DIFF_SIZE = (400, 225, 4)
DIFF_SUN_ELEVATION, DIFF_SUN_AZIMUTH, DIFF_SUN_LENGTH = 1.16, 26.57, 2.0
FIT_SUN_DROP = 8.0
# D4's material: an interior albedo (0.1, 0.4, 0.9), ~1,100 camera hits.
FIT_MATERIAL = "light_blue_diffuse"
FIT_STEPS = 20
# Phase denoise: Q1's frame and sample counts (the reference's
# tests/test_denoise_quality.py), Q3's frame and spp.
Q1_SIZE, Q1_SPP = (96, 54), (8, 384)
Q3_SIZE = (1920, 1080, 8)
# Phase denoise, T1: the short training run's pairs and steps.
T1_PAIRS, T1_STEPS = 6, 200
# f32 operations of one K1 epilogue with its compare against the running
# best, counted from csrc/closest_hit.cu (sphere_epi, tri_epi, box_epi).
EPILOGUE_OPS = (15, 12, 35)
# Bounce-ray hits closer than this to their origin are near-origin hits
# (hit_agree): the largest near-origin t on which K4 and its plain version
# disagreed on the funnel's overlapping spheres was 0.0063.
NEAR_ORIGIN = 0.02
# Kernels each path launches (the counters of _counters()): on the fused
# pool the start kernel, K1 and K3 fused (shade_advance: its beauty
# variant, shade_advance_features the others).
FUSED_KERNELS = ("start_kernel", "closest_hit", "shade_advance")
FEATURES_KERNELS = ("start_kernel", "closest_hit", "shade_advance_features")
CHUNKED_KERNELS = ("closest_hit_feats",)
# K2 and the unfused K3: K3 fused's yardstick (and P3's d3), and the
# yardsticks of P2/P4 and P3: never launched on a render path.
YARDSTICKS = ("decode", "shade_advance_unfused",
              "shade_advance_unfused_features", "onehot_fetch_scalar",
              "decode_stage_scalar")
# The device kernels of the fused pool's closest hit: K1's tile scan below
# BVH_MIN_PRIMS primitives, the BVH walk from there on (`_k1_kernel`).
K1_KERNELS = ("tile_scan_kernel", "bvh_hit_kernel")
# The unfused pool: K1 and none of K3 fused.
UNFUSED_CHECK = ("closest_hit", "shade_advance", "shade_advance_features")
_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(name: str, fn, n: int = 20, rounds: int = 5) -> float:
    """Card ms per call: `n` calls back to back between one pair of CUDA
    events, divided by `n`; the median over `rounds`, after a warm-up.
    A device sleep ahead of the start event lets the host queue all `n`
    calls before the first one starts, so the wrapper's host cost does not
    show in the time; a round whose queueing outlasted the sleep is logged
    as host-bound."""
    import torch

    fn()
    torch.cuda.synchronize()
    times, host_bound = [], 0
    for _ in range(rounds):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        host_bound += queued_ms > ev[0].elapsed_time(ev[1])
        times.append(ev[1].elapsed_time(ev[2]) / n)
    times.sort()
    ms = times[len(times) // 2]
    log(f"  time {name}: {ms:.5f} ms/call ({n} calls x {rounds} rounds"
        f"{f', {host_bound} host-bound' if host_bound else ''})")
    return ms


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --- phase 2 helpers ---------------------------------------------------------

def hit_agree(name, t_a, idx_a, typ_a, t_b, idx_b, typ_b, left=None,
              tangent=None):
    """Closest-hit agreement under the reference's budgets
    (utils/smoke.py:351-359): hit flips <= 1%, winner flips <= 2.5%,
    same-winner t at most 3% of rays over 5e-3 relative, none over 5e-2.

    left = (idx, type, hit) of the primitive each ray starts on (bounce
    rays only): on bounce rays a same-winner lane is a near-origin hit when
    it hits that primitive again (a self-hit from an origin RAY_EPSILON off
    its surface) or hits within NEAR_ORIGIN of its origin (the funnel's
    spheres overlap, so a bounce ray can start inside or just outside a
    neighbour). There the root nearest the origin is a difference of
    nearly equal terms, and the f32 rounding of each formulation decides
    it, the exact oracle's included, and whether it passes tmin. Such
    lanes count in the 3% budget but are not held to the 5e-2 cap; their
    number over it is logged. tangent (a lane mask, `near_tangent`) adds
    the sphere and triangle hits so nearly tangential that f32 cannot
    resolve their t to the cap.
    Returns the max |dt| over the same-winner hits held to the cap."""
    import torch

    n = t_a.shape[0]
    ha, hb = t_a < 1e30, t_b < 1e30
    flips = int((ha != hb).sum())
    both = ha & hb
    same = both & (idx_a == idx_b) & (typ_a == typ_b)
    winner = int((both & ~same).sum())
    rel = ((t_a - t_b).abs() / t_b.abs().clamp(min=1e-3))[same]
    self_hit = torch.zeros_like(same)
    if left is not None:
        self_hit = ((left[2] & (idx_a == left[0]) & (typ_a == left[1]))
                    | (torch.minimum(t_a, t_b) < NEAR_ORIGIN))
    if tangent is not None:
        self_hit = self_hit | tangent
    near = self_hit[same]
    held = same & ~self_hit
    frac = float((rel > 5e-3).float().mean()) if rel.numel() else 0.0
    mx = float(rel[~near].max()) if bool(held.any()) else 0.0
    abs_err = float((t_a - t_b).abs()[held].max()) if bool(held.any()) else 0.0
    selfhit = ""
    if left is not None:
        dt_self = float((t_a - t_b).abs()[same & self_hit].max()) if bool(
            (same & self_hit).any()) else 0.0
        selfhit = (f"; near-origin or grazing hits {int(near.sum())}, of "
                   f"them over 5e-2 "
                   f"{int((near & (rel > 5e-2)).sum())}, "
                   f"max |dt| {dt_self:.3g}")
    log(f"  {name}: hits {int(both.sum())}/{n}, hit flips {flips}, winner "
        f"flips {winner}, frac(rel>5e-3) {frac:.5f}, max rel {mx:.3g}, "
        f"max |dt| {abs_err:.3g}{selfhit}")
    lanes = torch.nonzero(same).flatten()
    for exempt, count in ((False, 4), (True, 2)):
        pick = torch.where((near == exempt) & (rel > 5e-2), rel, -1.0)
        order = torch.argsort(pick, descending=True)[:count]
        for i, k in zip(lanes[order[pick[order] > 0]].tolist(),
                        order[pick[order] > 0].tolist()):
            log(f"    lane {i}: type {int(typ_a[i])} idx {int(idx_a[i])} "
                f"t {float(t_a[i]):.6g} vs {float(t_b[i]):.6g}"
                f"{' (near origin or grazing)' if exempt else ''}")
    check(flips <= max(2, n // 100), f"{name}: {flips} hit flips")
    check(winner <= max(2, n // 40), f"{name}: {winner} winner flips")
    check(frac <= 0.03 and mx <= 5e-2, f"{name}: same-winner t drift")
    return abs_err


def near_tangent(scene, o, d, t, idx, typ):
    """Lanes whose hit (t, idx, typ) is met so nearly tangentially that f32
    cannot resolve t to 5e-2, by an error estimate in exact (f64)
    arithmetic of 8 ulps of the largest term each formulation sums:
    - a sphere: c = |o|^2 - 2 o.C + |C|^2 - r^2 is off by that much of
      |o|^2 + |C|^2 + r^2, and a root moves by dc / (2 sqrt(disc));
    - a triangle: t = (o - v0).n / (-d.n) with n = e1 x e2, whose
      numerator is off by that much of |n| (|o| + |v0|) and whose
      denominator by that much of |d| |n|, over |d.n|."""
    import torch

    from raytracer_project_tpu_torch.models.geometry import (
        PRIM_SPHERE, PRIM_TRIANGLE)

    f64 = torch.float64
    ulps = 8 * 2.0 ** -23
    o64, d64, t64 = o.to(f64), d.to(f64), t.to(f64).abs()
    norm = lambda x: torch.sqrt((x * x).sum(-1))
    sph, tri = typ == PRIM_SPHERE, typ == PRIM_TRIANGLE
    row = torch.where(sph, idx, 0).long()
    c = scene.spheres.center[row].to(f64)
    r = scene.spheres.radius[row].to(f64)
    oc = c - o64
    a = (d64 * d64).sum(-1)
    h = (d64 * oc).sum(-1)
    disc = h * h - a * ((oc * oc).sum(-1) - r * r)
    mag = (o64 * o64).sum(-1) + (c * c).sum(-1) + r * r
    dt_sph = ulps * mag / (2.0 * torch.sqrt(disc.clamp(min=1e-300)))
    row = torch.where(tri, idx, 0).long()
    v0 = scene.triangles.v0[row].to(f64)
    n = torch.linalg.cross(scene.triangles.e1[row].to(f64),
                           scene.triangles.e2[row].to(f64), dim=-1)
    det = (d64 * n).sum(-1).abs().clamp(min=1e-300)
    dt_tri = ulps * norm(n) * (norm(o64) + norm(v0) + t64 * norm(d64)) / det
    dt = torch.where(sph, dt_sph, torch.where(tri, dt_tri, 0.0))
    return (t < 1e30) & (dt > 5e-2 * t64)


def rows_agree(name, out, ref, int_rows):
    """Integer-valued rows exactly equal, float rows within 1e-5 abs +
    1e-5 rel. Returns the max abs error over the float rows."""
    import torch

    err = 0.0
    for k in range(out.shape[0]):
        a, b = out[k], ref[k]
        if k in int_rows:
            bad = int((a != b).sum())
            check(bad == 0, f"{name}: row {k}: {bad} lanes differ")
        else:
            ok = torch.isclose(a, b, rtol=1e-5, atol=1e-5)
            check(bool(ok.all()), f"{name}: row {k}: {int((~ok).sum())} lanes "
                  f"off, max |d| {float((a - b).abs().max()):.3g}")
            err = max(err, float((a - b).abs().max()))
    return err


def _reachable_work(od, t_hit, bounds, counts, width, work, cull=True) -> int:
    """Sum over the rays od f32[6, P] of work(table, first, rows) for each
    `width`-primitive tile whose AABB (bounds) the ray reaches no later
    than its closest hit t_hit: the tiles no cull can skip (every tile
    without `cull`)."""
    import torch

    o, d = od[:3], od[3:]
    inv_d = 1.0 / torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
    total = 0
    for i, (bnd, n) in enumerate(zip(bounds, counts)):
        for c, c0 in enumerate(range(0, n, width)):
            w = work(i, c0, min(width, n - c0))
            if not cull:
                total += od.shape[1] * w
                continue
            lo, hi = bnd[c, :3, None], bnd[c, 3:, None]
            t0, t1 = (lo - o) * inv_d, (hi - o) * inv_d
            tn = torch.minimum(t0, t1).amax(0)
            tf = torch.maximum(t0, t1).amin(0)
            reach = (tn <= tf) & (tf > 0) & (tn <= t_hit)
            total += int(reach.sum()) * w
    return total


def k1_operations(od, t_hit, tab, dots=True, epilogues=True, cull=True,
                  width=512) -> int:
    """f32 operations that the closest hit of the rays od f32[6, P] needs on
    the dense tables tab = (coeffs, `width`-wide AABBs, counts): for each
    ray, each `width`-primitive tile it reaches no later than its closest
    hit, and in each such tile 2 per nonzero coefficient (one FMA of the
    dot) plus one epilogue per primitive. The K1 and K4 bounds, and P1's,
    count it at the tables' finest AABBs (`fine_tables`, width MM_FINE =
    128); P1's dense yardstick, whose kernel culls 512-wide chunks, at
    512; P1's ablations count only the dots or only the epilogues."""
    import torch

    coeffs, bounds, counts = tab
    return _reachable_work(
        od, t_hit, bounds, counts, width,
        lambda i, c0, w: (2 * int(torch.count_nonzero(coeffs[i][:, :, c0:c0 + w]))
                          * dots + EPILOGUE_OPS[i] * w * epilogues), cull)


def fine_tables(scene, scan):
    """(the dense coefficient tables, their MM_FINE-wide AABBs, counts): the
    finest tiles a cull could skip, on which `k1_operations` counts the K1
    and K4 bounds."""
    mm = scene.mm
    return (scan.coeffs, (mm.sphere_bounds, mm.tri_bounds, mm.box_bounds),
            scan.counts)


def k1_structural_operations(od, t_hit, scan) -> int:
    """f32 operations the compact-row scan does on the rays beyond what a
    cull can skip: for each tile of scan.bounds a ray reaches no later than
    its closest hit, 2 per structural slot and one epilogue per primitive
    (`k1_operations` counts the nonzero coefficients instead)."""
    from raytracer_project_tpu_torch.ops import closest_hit as k1

    slots = [sum(map(len, s)) for s in k1.SLOTS]     # 9, 19, 21
    return _reachable_work(
        od, t_hit, scan.bounds, scan.counts, k1.SCAN_TILE,
        lambda i, c0, w: (2 * slots[i] + EPILOGUE_OPS[i]) * w)


def p1_operations(od, t_full, tab, variant: str, width: int) -> int:
    """f32 operations of P1 `variant` on the rays od with every ray culled
    on its own over the `width`-primitive tiles of tab = (the dense
    coefficient tables, their `width`-wide AABBs, counts): full as K1 (its
    closest hit t_full); nocull every tile; nodots the epilogues of every
    tile a ray reaches (its best t stays T_MAX); cheapepi the dots of the
    tiles a ray reaches before its own running minimum of raw group-0
    dots, tile by tile in scan order. The compact-scan probe counts at the
    128-wide tiles it culls on (`fine_tables`, K1's yardstick), the dense
    yardstick at its 512-wide chunks."""
    import torch

    from raytracer_project_tpu_torch.ops import intersect

    if variant != "cheapepi":
        return k1_operations(od, t_full if variant == "full" else
                             torch.full_like(t_full, 1e30), tab,
                             dots=variant != "nodots", cull=variant != "nocull",
                             width=width)
    feats = intersect.ray_features((od[0], od[1], od[2]), (od[3], od[4], od[5]))
    o, d = od[:3], od[3:]
    inv_d = 1.0 / torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
    best = torch.full_like(t_full, 1e30)
    total = 0
    for coeff, bnd, n in zip(*tab):
        for c, c0 in enumerate(range(0, n, width)):
            block = coeff[:, :, c0:min(c0 + width, n)]
            lo, hi = bnd[c, :3, None], bnd[c, 3:, None]
            t0, t1 = (lo - o) * inv_d, (hi - o) * inv_d
            tn = torch.minimum(t0, t1).amax(0)
            tf = torch.maximum(t0, t1).amin(0)
            reach = (tn <= tf) & (tf > 0) & (tn < best) & bool(lo[0] <= hi[0])
            total += int(reach.sum()) * 2 * int(torch.count_nonzero(block))
            cmin = (feats @ block[:, 0]).amin(1)
            best = torch.where(reach, torch.minimum(best, cmin), best)
    return total


def equal_on_finite(name, new, ref, feats) -> int:
    """new and ref, (t, idx, type) each, equal bit for bit on every lane
    whose features 0-12 (feats f32[>=13, N]) are finite; returns the count
    of the other lanes, which are left out (a dense chain turns an inf
    feature into NaN through inf * 0, the compact chain does not)."""
    import torch

    finite = torch.isfinite(feats[:13]).all(0)
    bad = torch.zeros_like(finite)
    for a, b in zip(new, ref):
        if a.dtype.is_floating_point:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad |= finite & (a != b)
    n_bad, n_other = int(bad.sum()), int((~finite).sum())
    log(f"  {name}: {n_bad} of {finite.numel()} lanes differ; {n_other} "
        f"lanes with non-finite features left out")
    for i in torch.nonzero(bad).flatten()[:4].tolist():
        log(f"    lane {i}: t {float(new[0][i]):.9g} vs {float(ref[0][i]):.9g}, "
            f"idx {int(new[1][i])} vs {int(ref[1][i])}, type {int(new[2][i])} "
            f"vs {int(ref[2][i])}")
    check(n_bad == 0, f"{name}: {n_bad} lanes differ")
    return n_other


def bound_ms(nbytes: int, flops: int = 0):
    """(the least ms for `nbytes` moved and `flops` f32 operations on the
    H100, which of the two bounds it)."""
    by, fl = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(by, fl) * 1e3, "operations" if fl > by else "bytes"


def _step_adds(tables, hits, state, aparams, bparams, sp):
    """(the unfused plain step's contrib and tgt on these inputs, the
    number of accumulator adds K3 fused issues there: one per channel of
    each lane whose target in that channel is a pixel)."""
    from raytracer_project_tpu_torch.ops import fused_step as fs

    sf, si, nw, seg = state
    rec = fs.decode_plain(tables, sf[:6], *hits, aparams)
    out = fs.shade_advance_plain(tables, rec, sf, si, nw, seg, bparams, sp)
    contrib, tgt = out[2], out[3]
    adds = sum(int((tgt[t] < sp.n_pixels).sum())
               for _, t in fs.acc_channels(sp))
    return contrib, tgt, adds


def k3_fused_bytes(tables, hits, state, aparams, sp, adds: int) -> int:
    """Bytes K3 fused must move, each input byte counted once: the state
    rows in and out, K1's t, idx and type, the table rows these hits read
    (packed primitive rows, material and texture-metadata tables, texel,
    bump-delta and HDR rows, volume rows), and 4 B per accumulator add."""
    import torch

    from raytracer_project_tpu_torch.ops import fused_step as fs

    sf, si = state[0], state[1]
    p = sf.shape[1]
    t, idx, typ = hits
    n_s, n_t, _ = tables.scan.counts
    base = torch.where(typ == 1, n_s, torch.where(typ == 2, n_s + n_t, 0))
    rows = torch.clamp(idx + base, 0, tables.rectab.shape[0] - 1)
    rec = fs.decode_plain(tables, sf[:6], *hits, aparams)
    uniq = lambda x: int(torch.unique(x).numel())
    texel = uniq(torch.clamp(rec[fs._RO_TEXROW], min=0.0))
    bump = uniq(torch.clamp(rec[fs._RO_BUMPROW], min=0.0))
    env = uniq(rec[fs._RO_ENVROW]) if tables.env_hw is not None else 0
    table_bytes = 4 * (28 * uniq(rows) + tables.mattab.numel()
                       + tables.texmeta.numel() + 4 * texel + 2 * bump
                       + 4 * env + 16 * sp.n_volumes + 40 + 8)
    nf, ni = fs.state_rows(sp)
    return p * (4 * 2 * (nf + ni) + 12) + table_bytes + 4 * adds


def _old_step(tables, hits, state, aparams, bparams, sp, acc):
    """K3 fused's yardstick, the main path's step after K1 before K3
    fused: K2, the unfused K3, and one index_add_ of every channel with
    the idle lanes on the dummy slot."""
    import torch

    from raytracer_project_tpu_torch.ops import fused_step as fs

    sf, si, nw, seg = state
    chans = fs.acc_channels(sp)
    dev = sf.device
    tgt_rows = torch.tensor([t for _, t in chans], device=dev)
    src_rows = torch.tensor([c for c, _ in chans], device=dev)
    offsets = (torch.arange(len(chans), dtype=torch.int64, device=dev)
               * (sp.n_pixels + 1))[:, None]

    def step():
        rec = fs.decode(tables, sf[:6], *hits, aparams)
        out = fs.shade_advance(tables, rec, sf, si, nw, seg, bparams, sp)
        idx = out[3].index_select(0, tgt_rows).to(torch.int64) + offsets
        acc.index_add_(0, idx.reshape(-1),
                       out[2].index_select(0, src_rows).reshape(-1))
    return step


def fused_against_plain(name, tables, hits, state, aparams, bparams, sp,
                        acc_tol: float, flip_budget: int = 0) -> float:
    """K3 fused against shade_accumulate_plain on the same inputs: state
    rows (integers exact, floats within rtol/atol 1e-5) on all but at most
    `flip_budget` lanes, the accumulator within rtol/atol `acc_tol` on
    every pixel no differing lane finishes into, the dummy slots untouched,
    segments and the step count exact (next_work and the live count too
    when no lane differs). Returns the largest |d| held."""
    import torch

    from raytracer_project_tpu_torch.ops import fused_step as fs

    sf, si, nw, seg = state
    dev, n = sf.device, sp.n_pixels
    outs, accs = [], []
    for fn in (fs.shade_accumulate, fs.shade_accumulate_plain):
        acc = fs.new_accumulator(sp, dev)
        steps = torch.zeros(1, dtype=torch.int64, device=dev)
        outs.append(fn(tables, hits, sf, si, nw, seg, steps, aparams,
                       bparams, sp, acc))
        accs.append(acc.view(len(fs.acc_channels(sp)), n + 1))
    torch.cuda.synchronize()
    (out, ref), err = outs, 0.0
    bad = torch.zeros(sf.shape[1], dtype=torch.bool, device=dev)
    for a, b in zip(out[:2], ref[:2]):
        if a.dtype.is_floating_point:
            close = torch.isclose(a, b, rtol=1e-5, atol=1e-5).all(0)
            bad |= ~close
            if bool(close.any()):
                err = max(err, float((a - b).abs()[:, close].max()))
        else:
            bad |= (a != b).any(0)
    n_bad = int(bad.sum())
    check(n_bad <= flip_budget, f"{name}: {n_bad} lanes differ (budget "
          f"{flip_budget})")
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[si[3][bad].long() - sp.pixel_offset] = False
    a, b = accs[0][:, :n][:, keep], accs[1][:, :n][:, keep]
    acc_err = float((a - b).abs().max())
    check(bool(torch.allclose(a, b, rtol=acc_tol, atol=acc_tol)),
          f"{name}: accumulator off by {acc_err:.3g} (tolerance {acc_tol:g})")
    check(not bool(accs[0][:, n].any()), f"{name}: a dummy slot was added to")
    check(int(out[3]) == int(ref[3]), f"{name}: segment count")
    check(int(out[5]) == int(ref[5]) == 1, f"{name}: step count")
    if n_bad == 0:
        check(int(out[2]) == int(ref[2]) and int(out[4]) == int(ref[4]),
              f"{name}: next_work or live count")
    log(f"  {name}: state within 1e-5 on all but {n_bad} lanes, "
        f"accumulator within {acc_tol:g} (max |d| {acc_err:.3g}, sum "
        f"{float(accs[0].sum()):.6g} vs {float(accs[1].sum()):.6g}); "
        f"next_work {int(out[2])} live {int(out[4])}")
    return max(err, acc_err)


def accumulator_block(label, contrib, tgt, sp) -> dict:
    """The accumulator before K3 fused, measured at its shapes: one
    index_add_ of every channel of the unfused step's (contrib, tgt) as the
    main path ran it (the idle lanes on one dummy address per channel), the
    same adds with the dummy lanes dropped, and with the dummy lanes spread
    over distinct slots (lane i at slot i mod n). ms per call (time_ms)."""
    import torch

    from raytracer_project_tpu_torch.ops import fused_step as fs

    dev, n = tgt.device, sp.n_pixels
    chans = fs.acc_channels(sp)
    idx = tgt[[t for _, t in chans]].to(torch.int64)
    vals = contrib[[c for c, _ in chans]].contiguous()
    offsets = (torch.arange(len(chans), dtype=torch.int64, device=dev)
               * (n + 1))[:, None]
    real = idx < n
    lanes = torch.arange(idx.shape[1], device=dev) % n
    flat = {"dummy": ((idx + offsets).reshape(-1), vals.reshape(-1)),
            "dropped": ((idx + offsets)[real], vals[real]),
            "spread": ((torch.where(real, idx, lanes) + offsets).reshape(-1),
                       vals.reshape(-1))}
    acc = fs.new_accumulator(sp, dev)
    out = {"channels": len(chans), "lanes": int(idx.shape[1]),
           "adds_to_pixels": int(real.sum())}
    for kind, (i, v) in flat.items():
        out[f"{kind}_ms"] = time_ms(f"index_add_ {label} {kind}",
                                    lambda i=i, v=v: acc.index_add_(0, i, v))
    log(f"  accumulator {label}: {out['channels']} channels x "
        f"{out['lanes']} lanes, {out['adds_to_pixels']} adds to pixels: "
        f"dummy {out['dummy_ms']:.4f} ms, dropped {out['dropped_ms']:.4f} "
        f"ms, spread {out['spread_ms']:.4f} ms")
    return out


def phase_kernels(results: dict):
    """K1, K2, K3 and K3 fused against their plain versions, K3 fused
    timed beside K2 + K3 + index_add_, and the index_add_ measured;
    returns the ray sets (the pool's camera rays and one bounce of them,
    f32[6, 131072] each)."""
    import numpy as np
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.ops import intersect
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa

    dev = torch.device("cuda")
    scene = presets.showcase_scene().to(dev)
    cam = tcam.make_camera(image_width=800, image_height=450, **CAM_KW)
    env = tenv.make_environment(**ENV_KW)
    tables = fs.build_tables(scene, env, tenv.PHYSICAL_SUN)
    dense = pa.scene_tables(scene)    # (coeffs, 512-wide AABBs, counts)
    aparams = fs._aparams(env, dev)
    bparams = fs._bparams(cam, env, dev)
    n = 800 * 450
    sp = fs.StepParams(seed=rng.seed_from_int(0), sample_offset=0, n_pixels=n,
                       width=800, total_work=n * 32, max_depth=10,
                       env_mode=tenv.PHYSICAL_SUN)

    # Camera rays of the first pool fill, then one step of the plain path.
    w = torch.arange(P_MAIN, device=dev)
    li = (w % n).to(torch.int32)
    samp = (w // n).to(torch.int32)
    o, d = tcam.generate_rays_soa(cam.to(dev), rng.LaneRng(
        sp.seed, rng.u32(li), rng.u32(samp), 0), li, 800)
    ones = torch.ones(P_MAIN, device=dev)
    state_f = torch.stack([*o, *d, ones, ones, ones, 0 * ones, 0 * ones,
                           0 * ones]).contiguous()
    state_i = torch.stack([torch.ones_like(li), torch.zeros_like(li), samp,
                           li]).contiguous()
    next_work = torch.tensor([P_MAIN], dtype=torch.int32, device=dev)
    segments = torch.zeros(1, dtype=torch.int64, device=dev)
    rec0 = fs.decode_plain(tables, state_f[:6], *k1.closest_hit_plain(
        state_f[:6], 1e-3, tables.scan.coeffs, tables.scan.counts), aparams)
    step1 = fs.shade_advance_plain(tables, rec0, state_f, state_i, next_work,
                                   segments, bparams, sp)
    ray_sets = {"camera": state_f[:6].contiguous(),
                "bounce": step1[0][:6].contiguous()}
    log(f"kernels: {P_MAIN} lanes; bounce set live lanes "
        f"{int((step1[1][0] > 0).sum())}")

    # K1 against its plain version, the exact oracle and the dense scan.
    k1_err = 0.0
    hits = {}
    for name, od in ray_sets.items():
        tk, ik, yk = k1.closest_hit(od, 1e-3, tables.scan)
        tp, ip, yp = k1.closest_hit_plain(od, 1e-3, tables.scan.coeffs,
                                          tables.scan.counts)
        torch.cuda.synchronize()
        k1_err = max(k1_err, hit_agree(f"K1 vs plain ({name})", tk, ik, yk,
                                       tp, ip, yp))
        ob = intersect.intersect_brute(scene, od[:3].T.contiguous(),
                                       od[3:].T.contiguous(), 1e-3)
        hit_agree(f"K1 vs brute oracle ({name})", tk, ik, yk, ob.t,
                  ob.prim_idx, ob.prim_type)
        feats = intersect.ray_features((od[0], od[1], od[2]),
                                       (od[3], od[4], od[5])).T
        equal_on_finite(f"K1 vs dense ({name})", (tk, ik, yk),
                        k1.closest_hit_dense(od, 1e-3, *dense), feats)
        hits[name] = (tk, ik, yk)

    # K2: identical hit inputs; sun-sky main path and the HDR row too.
    int_rows = (fs._RO_HIT, fs._RO_FRONT, fs._RO_MTYPE, fs._RO_GU, fs._RO_GV,
                fs._RO_HASB, fs._RO_TEXROW, fs._RO_BUMPROW, fs._RO_ENVROW)
    hdr = np.linspace(0, 2, 64 * 128 * 3, dtype=np.float32).reshape(64, 128, 3)
    env_hdr = tenv.make_environment(**dict(ENV_KW, **HDR_KW, hdr_image=hdr))
    tables_hdr = fs.build_tables(scene, env_hdr.to(dev), tenv.HDR_MAP)
    aparams_hdr = fs._aparams(env_hdr, dev)
    k2_err = 0.0
    recs = {}
    for name, od in ray_sets.items():
        for tab, ap, tag in ((tables, aparams, "sun"),
                             (tables_hdr, aparams_hdr, "hdr")):
            out = fs.decode(tab, od, *hits[name], ap)
            ref = fs.decode_plain(tab, od, *hits[name], ap)
            torch.cuda.synchronize()
            k2_err = max(k2_err, rows_agree(f"K2 ({name}, {tag})", out, ref,
                                            int_rows))
            if tag == "sun":
                recs[name] = out
        log(f"  K2 ({name}): integer rows exact, float rows within 1e-5")

    # K3: identical inputs on the bounce state; all environment modes.
    k3_err = 0.0
    rec1 = recs["bounce"]
    state = (step1[0].contiguous(), step1[1].contiguous(), step1[4], step1[5])
    for mode, tab, envm in ((tenv.PHYSICAL_SUN, tables, env),
                            (tenv.SOLID_COLOR, tables, env),
                            (tenv.HDR_MAP, tables_hdr, env_hdr)):
        spm = sp._replace(env_mode=mode)
        bp = fs._bparams(cam, envm, dev)
        rec = rec1
        if mode == tenv.HDR_MAP:
            rec = fs.decode(tables_hdr, ray_sets["bounce"], *hits["bounce"],
                            aparams_hdr)
        out = fs.shade_advance(tab, rec, *state, bp, spm)
        ref = fs.shade_advance_plain(tab, rec, *state, bp, spm)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(out, ref)):
            if a.dtype.is_floating_point:
                k3_err = max(k3_err, rows_agree(f"K3 mode {mode} output {k}",
                                                a, b, ()))
            else:
                bad = int((a != b).sum())
                check(bad == 0, f"K3 mode {mode}: output {k}: {bad} differ")
        log(f"  K3 (mode {mode}): i32 state, targets and counters exact, "
            f"floats within 1e-5; next_work {int(out[4])} live "
            f"{int(out[6])}")

    # K3 fused on the same inputs, K1's hits instead of K2's rows. The
    # 131,072 lanes hold distinct pixels of 360,000, so each address gets
    # at most one add: the accumulator within 1e-5.
    k3f_err = 0.0
    for mode, tab, envm, ap in ((tenv.PHYSICAL_SUN, tables, env, aparams),
                                (tenv.SOLID_COLOR, tables, env, aparams),
                                (tenv.HDR_MAP, tables_hdr, env_hdr,
                                 aparams_hdr)):
        k3f_err = max(k3f_err, fused_against_plain(
            f"K3 fused mode {mode}", tab, hits["bounce"], state, ap,
            fs._bparams(cam, envm, dev), sp._replace(env_mode=mode), 1e-5))

    # Times at P = 131,072 on the bounce lanes: the new scan and the dense
    # one in turns (new, dense, dense, new).
    od = ray_sets["bounce"]
    k1_new = lambda: k1.closest_hit(od, 1e-3, tables.scan)
    k1_dense = lambda: k1.closest_hit_dense(od, 1e-3, *dense)
    t_k1, t_k1d = time_ms("K1", k1_new), time_ms("K1 dense", k1_dense)
    t_k1d = (t_k1d + time_ms("K1 dense", k1_dense)) / 2
    t_k1 = (t_k1 + time_ms("K1", k1_new)) / 2
    t_k1p = time_ms("K1 plain", lambda: k1.closest_hit_plain(
        od, 1e-3, tables.scan.coeffs, tables.scan.counts), n=5, rounds=3)
    hb = hits["bounce"]
    t_k2 = time_ms("K2", lambda: fs.decode(tables, od, *hb, aparams))
    t_k2p = time_ms("K2 plain", lambda: fs.decode_plain(tables, od, *hb,
                                                        aparams), rounds=3)
    t_k3 = time_ms("K3", lambda: fs.shade_advance(tables, rec1, *state,
                                                  bparams, sp))
    t_k3p = time_ms("K3 plain", lambda: fs.shade_advance_plain(
        tables, rec1, *state, bparams, sp), rounds=3)
    # K3 fused beside its yardstick (K2, K3 and the index_add_ it
    # replaces) on the same inputs and build, in turns; acc and steps
    # grow in place over the timed calls.
    acc = fs.new_accumulator(sp, dev)
    steps = torch.zeros(1, dtype=torch.int64, device=dev)
    fused = lambda: fs.shade_accumulate(tables, hb, *state, steps, aparams,
                                        bparams, sp, acc)
    old = _old_step(tables, hb, state, aparams, bparams, sp,
                    fs.new_accumulator(sp, dev))
    t_k3f, t_old = time_ms("K3 fused", fused), time_ms("K2 + K3 + index_add_",
                                                       old)
    t_old = (t_old + time_ms("K2 + K3 + index_add_", old)) / 2
    t_k3f = (t_k3f + time_ms("K3 fused", fused)) / 2
    t_k3fp = time_ms("K3 fused plain", lambda: fs.shade_accumulate_plain(
        tables, hb, *state, steps, aparams, bparams, sp, acc), rounds=3)
    contrib, tgt, adds = _step_adds(tables, hb, state, aparams, bparams, sp)
    k3f_bytes = k3_fused_bytes(tables, hb, state, aparams, sp, adds)
    accumulator = accumulator_block("beauty", contrib, tgt, sp)

    # Bounds from this run's inputs (see PERF.md for the reckoning).
    k1_flops = k1_operations(od, hb[0], fine_tables(scene, tables.scan),
                             width=intersect.MM_FINE)
    log(f"  K1 operations: {k1_flops / P_MAIN:.0f} per ray on the bounce set "
        f"(the bound: nonzero coefficients, 128-wide AABBs); structural (what "
        f"the new scan does): "
        f"{k1_structural_operations(od, hb[0], tables.scan) / P_MAIN:.0f}; "
        f"over 512-wide chunks (the dense scan's cull): "
        f"{k1_operations(od, hb[0], dense) / P_MAIN:.0f}")
    k1_bytes = P_MAIN * (6 * 4 + 3 * 4) + sum(
        4 * (c.numel() + b.numel()) for c, b in zip(tables.scan.rows,
                                                    tables.scan.bounds))
    k2_bytes = P_MAIN * (6 * 4 + 3 * 4 + 24 * 4)
    k3_bytes = P_MAIN * (24 * 4 + 16 * 4 + (4 + 2) * 4 + 16 * 4 + 4 * 4)
    bound = lambda by, fl=0: max(by / PEAK_BYTES_PER_S, fl / PEAK_F32_FLOPS) * 1e3
    k1_bound, k1_by = bound_ms(k1_bytes, k1_flops)
    pkg = "raytracer_project_tpu_torch"
    results.update({
        "closest_hit": dict(
            name="closest_hit", route="cuda", source=f"{pkg}/csrc/closest_hit.cu",
            replaces="raytracer_project_tpu/ops/pallas_intersect.py:272",
            max_abs_err=k1_err, ms=t_k1, plain_ms=t_k1p,
            bound_ms=k1_bound, bound_by=k1_by, library_ms=None,
            dense_ms=t_k1d),
        "decode": dict(
            name="decode", route="cuda", source=f"{pkg}/csrc/decode.cu",
            replaces="raytracer_project_tpu/ops/fused_step.py:326",
            max_abs_err=k2_err, ms=t_k2, plain_ms=t_k2p,
            bound_ms=bound(k2_bytes), bound_by="bytes", library_ms=None),
        "shade_advance": dict(
            name="shade_advance", route="cuda",
            source=f"{pkg}/csrc/shade_advance.cu",
            replaces="raytracer_project_tpu/ops/fused_step.py:669",
            also_replaces=["raytracer_project_tpu/ops/fused_step.py:326",
                           "raytracer_project_tpu/ops/fused_step.py:1398"],
            variant="fused", max_abs_err=k3f_err, ms=t_k3f, plain_ms=t_k3fp,
            bound_ms=bound(k3f_bytes), bound_by="bytes", library_ms=None,
            bytes_per_lane=k3f_bytes / P_MAIN, adds=adds,
            yardstick_ms=t_old, unfused_ms=t_k3, unfused_plain_ms=t_k3p,
            unfused_bound_ms=bound(k3_bytes), unfused_max_abs_err=k3_err,
            accumulator=accumulator),
    })
    for r in results.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms/launch, plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  K3 fused: {t_k3f:.4f} ms/launch against K2 + K3 + index_add_ "
        f"{t_old:.4f} ms (K2 {t_k2:.4f}, K3 {t_k3:.4f}); bound "
        f"{bound(k3f_bytes):.4f} ms ({k3f_bytes / P_MAIN:.1f} B/lane, {adds} "
        f"adds); the unfused K3's bound {bound(k3_bytes):.4f} ms, K2's "
        f"{bound(k2_bytes):.4f}")
    log(f"  closest_hit dense: {t_k1d:.4f} ms/launch "
        f"({t_k1d / t_k1:.2f}x the new scan)")
    return ray_sets


def phase_start(results: dict) -> None:
    """The pool's start in one launch (start_kernel, fused_step's
    initial_state) against the plain torch fill on the same card tensors,
    bit for bit: at the main path's pool (800x450 @ 32 spp, 131,072 lanes)
    and the preview's (400x225 @ 1 spp, 90,000 lanes, not a multiple of
    the 256-lane block). Both timed, with the byte bound of the state rows
    and counters the kernel writes; its launches are read on the main path
    (phase_full)."""
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.ops import fused_step as fs

    dev = torch.device("cuda")
    env = tenv.make_environment(**ENV_KW)
    out = {}
    for label, (w, h, spp) in (("main", (800, 450, 32)),
                               ("preview", (400, 225, 1))):
        cam = tcam.make_camera(image_width=w, image_height=h,
                               **CAM_KW).to(dev)
        n = w * h
        p = fs.pool_size(_cfg(w, h, spp), n * spp)
        sp = fs.StepParams(
            seed=rng.seed_from_int(1), sample_offset=0, n_pixels=n, width=w,
            total_work=n * spp, max_depth=10, env_mode=tenv.PHYSICAL_SUN,
            n_beauty=n * spp)
        bparams = fs._bparams(cam, env, dev)
        got = fs.initial_state(cam, bparams, sp, p)
        want = fs.initial_state_plain(cam, sp, p, dev)
        check(all(a.shape == b.shape and a.dtype == b.dtype
                  for a, b in zip(got, want)),
              f"start_kernel {label}: shapes or dtypes differ")
        bad = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                  if a.dtype == torch.float32 else int((a != b).sum())
                  for a, b in zip(got, want))
        check(bad == 0, f"start_kernel {label}: {bad} values differ in bits")
        err = float((got[0] - want[0]).abs().max())
        nbytes = sum(t.numel() * t.element_size() for t in got)
        ms = time_ms(f"start_kernel {label}",
                     lambda: fs.initial_state(cam, bparams, sp, p))
        plain_ms = time_ms(f"start_kernel {label} plain",
                           lambda: fs.initial_state_plain(cam, sp, p, dev))
        bound, by = bound_ms(nbytes)
        out[label] = dict(lanes=p, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by, bytes=nbytes)
        log(f"  start_kernel {label}: {p} lanes bit for bit against the "
            f"plain fill; {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({nbytes} B written)")
    main, preview = out["main"], out["preview"]
    results["start_kernel"] = dict(
        name="start_kernel", route="cuda",
        source="raytracer_project_tpu_torch/csrc/shade_advance.cu",
        replaces="raytracer_project_tpu/ops/fused_step.py:1283",
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by")},
        library_ms=None, lanes=main["lanes"], bytes=main["bytes"],
        **{f"preview_{k}": v for k, v in preview.items()})


def phase_k4(results: dict) -> None:
    """K4 on the chunked path's shapes: the 360,000 camera rays of the
    800x450 showcase and one scatter of them, made on the card by the
    chunked path's own functions."""
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import intersect, shade
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa

    dev = torch.device("cuda")
    scene = presets.showcase_scene().to(dev)
    cam = tcam.make_camera(image_width=800, image_height=450, **CAM_KW).to(dev)
    tables = intersect.hit_tables(scene)
    dense = pa.scene_tables(scene)
    pix = torch.arange(P_CHUNKED, device=dev)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 800)
    first = intersect.intersect(scene, o, d, 1e-3, tables)
    rec = intersect.make_record(scene, o, d, first)
    sc = shade.scatter(scene, rec, d, lr)
    ray_sets = {"camera": (o, d), "bounce": (sc.origin, sc.direction)}
    log(f"K4: {P_CHUNKED} lanes; bounce set from {int(rec.hit.sum())} hits")
    err = 0.0
    for name, (ro, rd) in ray_sets.items():
        left = None
        if name == "bounce":
            left = (first.prim_idx, first.prim_type, first.hit)
        feats = intersect.ray_feature_rows(ro, rd).contiguous()
        tk, ik, yk = k1.closest_hit_feats(feats, 1e-3, tables)
        tp, ip, yp = k1.closest_hit_feats_plain(feats, 1e-3, tables.coeffs,
                                                tables.counts)
        torch.cuda.synchronize()
        err = max(err, hit_agree(f"K4 vs plain ({name})", tk, ik, yk,
                                 tp, ip, yp, left))
        equal_on_finite(f"K4 vs dense ({name})", (tk, ik, yk),
                        k1.closest_hit_feats_dense(feats, 1e-3, *dense), feats)
        od = torch.cat([ro.T, rd.T]).contiguous()
        hit_agree(f"K4 vs K1 ({name})", tk, ik, yk,
                  *k1.closest_hit(od, 1e-3, tables), left)
        ob = intersect.intersect_brute(scene, ro.contiguous(), rd.contiguous(),
                                       1e-3)
        hit_agree(f"K4 vs brute oracle ({name})", tk, ik, yk, ob.t,
                  ob.prim_idx, ob.prim_type, left)
    # Times and the bound on the bounce set (the last one above): the new
    # scan and the dense one in turns.
    k4_new = lambda: k1.closest_hit_feats(feats, 1e-3, tables)
    k4_dense = lambda: k1.closest_hit_feats_dense(feats, 1e-3, *dense)
    t_k4, t_k4d = time_ms("K4", k4_new), time_ms("K4 dense", k4_dense)
    t_k4d = (t_k4d + time_ms("K4 dense", k4_dense)) / 2
    t_k4 = (t_k4 + time_ms("K4", k4_new)) / 2
    t_k4p = time_ms("K4 plain", lambda: k1.closest_hit_feats_plain(
        feats, 1e-3, tables.coeffs, tables.counts), n=3, rounds=3)
    flops = k1_operations(od, tk, fine_tables(scene, tables),
                          width=intersect.MM_FINE)
    log(f"  K4 operations: {flops / P_CHUNKED:.0f} per ray on the bounce set "
        f"(the bound: nonzero coefficients, 128-wide AABBs); structural (what "
        f"the new scan does): "
        f"{k1_structural_operations(od, tk, tables) / P_CHUNKED:.0f}; over "
        f"512-wide chunks (the dense scan's cull): "
        f"{k1_operations(od, tk, dense) / P_CHUNKED:.0f}")
    nbytes = P_CHUNKED * (16 * 4 + 3 * 4) + sum(
        4 * (c.numel() + b.numel()) for c, b in zip(tables.rows,
                                                    tables.bounds))
    bound, bound_by = bound_ms(nbytes, flops)
    results["closest_hit_feats"] = dict(
        name="closest_hit_feats", route="cuda",
        source="raytracer_project_tpu_torch/csrc/closest_hit.cu",
        replaces="raytracer_project_tpu/ops/pallas_intersect.py:228",
        max_abs_err=err, ms=t_k4, plain_ms=t_k4p, bound_ms=bound,
        bound_by=bound_by, library_ms=None, dense_ms=t_k4d)
    log(f"  closest_hit_feats: {t_k4:.4f} ms/launch, plain {t_k4p:.4f} ms, "
        f"bound {bound:.4f} ms ({bound_by}); dense {t_k4d:.4f} ms "
        f"({t_k4d / t_k4:.2f}x)")


# --- phases 3 and 4 -----------------------------------------------------------

def _counters():
    """Kernel name -> (wrapper, attribute holding its launch count)."""
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa
    from raytracer_project_tpu_torch.tools import probe_decode as pd
    from raytracer_project_tpu_torch.tools import probe_onehot as po

    return {"start_kernel": (fs.initial_state, "launches"),
            "closest_hit": (k1.closest_hit, "launches"),
            "bvh_closest_hit": (k1.closest_hit, "bvh_launches"),
            "decode": (fs.decode, "launches"),
            "shade_advance": (fs.shade_accumulate, "launches"),
            "shade_advance_features": (fs.shade_accumulate,
                                       "features_launches"),
            "shade_advance_unfused": (fs.shade_advance, "launches"),
            "shade_advance_unfused_features": (fs.shade_advance,
                                               "features_launches"),
            "closest_hit_feats": (k1.closest_hit_feats, "launches"),
            "ablate": (pa.ablate, "launches"),
            "ablate_dense": (pa.ablate_dense, "launches"),
            "onehot_fetch": (po.onehot_fetch, "launches"),
            "onehot_fetch_scalar": (po.onehot_fetch_scalar, "launches"),
            "decode_stage": (pd.decode_stage, "launches"),
            "decode_stage_scalar": (pd.decode_stage_scalar, "launches")}


def _reset_counters():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _launches(names) -> dict:
    """The counts of `names`; raises if K2 or the unfused K3 ran since the
    counts were last set to 0 (no render path launches them). "closest_hit"
    is csrc/closest_hit.cu's tile scan alone: its wrapper's count less the
    BVH kernel's ("bvh_closest_hit"), which the wrapper counts too."""
    counters = _counters()
    off = {k: getattr(*counters[k]) for k in YARDSTICKS}
    check(not any(off.values()), f"a yardstick ran on a render path: {off}")
    out = {k: getattr(*counters[k]) for k in names}
    if "closest_hit" in out:
        out["closest_hit"] -= getattr(*counters["bvh_closest_hit"])
    return out


class _PlainCallCounter:
    """Counts calls of the plain versions, and of the dense closest-hit
    scan, while the render runs."""

    def __enter__(self):
        from raytracer_project_tpu_torch.ops import closest_hit as k1
        from raytracer_project_tpu_torch.ops import fused_step as fs

        self.calls = 0
        self.saved = [(k1, "closest_hit_plain"), (fs, "decode_plain"),
                      (fs, "shade_advance_plain"),
                      (fs, "shade_accumulate_plain"),
                      (k1, "closest_hit_feats_plain"),
                      (k1, "closest_hit_dense"), (k1, "closest_hit_feats_dense")]
        self.orig = [getattr(m, a) for m, a in self.saved]
        for (m, a), f in zip(self.saved, self.orig):
            setattr(m, a, self._wrap(f))
        return self

    def _wrap(self, f):
        def counted(*args, **kw):
            self.calls += 1
            return f(*args, **kw)
        return counted

    def __exit__(self, *exc):
        for (m, a), f in zip(self.saved, self.orig):
            setattr(m, a, f)


class _NonFiniteLanes:
    """Counts, while the chunked render runs, the lanes K4 is handed whose
    features 0-12 are not finite (the only lanes where the compact-row scan
    and the dense one may differ: dead lanes of `trace` go through K4)."""

    def __enter__(self):
        import torch

        from raytracer_project_tpu_torch.ops import intersect

        self.lanes = self.total = 0
        self.orig = intersect.ray_feature_rows

        def counted(o, d):
            f = self.orig(o, d)
            self.lanes += int((~torch.isfinite(f[:13]).all(0)).sum())
            self.total += f.shape[1]
            return f

        intersect.ray_feature_rows = counted
        return self

    def __exit__(self, *exc):
        from raytracer_project_tpu_torch.ops import intersect

        intersect.ray_feature_rows = self.orig


def _showcase(width, height, **scene_kw):
    import torch

    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets

    dev = torch.device("cuda")
    return (presets.showcase_scene(**scene_kw).to(dev),
            tcam.make_camera(image_width=width, image_height=height, **CAM_KW),
            tenv.make_environment(**ENV_KW))


def _cfg(width, height, spp):
    from raytracer_project_tpu_torch.ops import integrator

    return integrator.RenderConfig(
        width=width, height=height, samples_per_pixel=spp, max_depth=10,
        use_albedo=False, use_normal=False, use_z_depth=False)


def _smoke_gate_check(images) -> None:
    """Each smoke image [(golden_name, label, max_frac, img)] under the
    smoke gate's two-golden policy on this card (utils/smoke.py
    _check_image): the committed device golden at mean |d| <= 1e-5, then
    the CPU golden under the cross-backend budgets."""
    from raytracer_project_tpu_torch.utils import smoke

    info = smoke.device_info("cuda")
    for name, label, max_frac, img in images:
        err = smoke._check_image(img, name, label, max_frac=max_frac,
                                 device=info)
        check(err is None, f"{label}: {err}")


def _smoke_spread(render, first, results: dict) -> None:
    """Two more renders of a smoke stage (`render`, one of the smoke
    module's render_* functions) beside its first images `first`: the
    largest mean and max |d| between the three runs of each image, which
    must stay within make_device_goldens' interlock (mean <= 1e-6)."""
    from raytracer_project_tpu_torch.tools import make_device_goldens as mdg

    runs = [first] + [render("cuda") for _ in range(2)]
    spread = results["shade_advance"]["run_to_run"]
    for k, (name, _, _, _) in enumerate(first):
        mean, mx = mdg.spread([r[k][3] for r in runs])
        spread[name] = {"runs": 3, "mean_abs_diff": mean, "max_abs_diff": mx}
        log(f"  {name}: three runs, largest mean |d| between runs {mean:.3g}, "
            f"max |d| {mx:.3g}")
        check(mean <= mdg.SPREAD_MEAN, f"{name}: runs differ by {mean:.3g}")


def phase_smoke(results: dict) -> None:
    import dataclasses

    import torch

    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.utils import smoke

    _reset_counters()
    with _PlainCallCounter() as plain:
        images = smoke.render_fused_fast("cuda")
    launches = _launches(FUSED_KERNELS)
    log(f"smoke: 64x36@2spp launches {launches}, plain calls {plain.calls}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    _smoke_gate_check(images)

    # The spread between runs, which K3 fused's adds in no fixed order
    # may open: the smoke frame three times with the pool above its pixel
    # count (4,096 lanes, 2,304 pixels), and 128x72 three times with the
    # pool at or below it (8,192 lanes, 9,216 pixels).
    spread = {}
    for (w, h), pool in (((64, 36), None), ((128, 72), 8192)):
        inputs = _showcase(w, h)
        cfg = dataclasses.replace(_cfg(w, h, 2), pool_lanes=pool)
        imgs = [integrator.render(*inputs, 0, cfg)["beauty"] for _ in range(3)]
        d = max(float((a - imgs[0]).abs().max()) for a in imgs[1:])
        dm = max(float((a - imgs[0]).abs().mean()) for a in imgs[1:])
        same = all(torch.equal(a, imgs[0]) for a in imgs[1:])
        spread[f"{w}x{h}"] = {"pool_lanes": pool or 4096,
                              "pixels": w * h, "max_abs_diff": d,
                              "mean_abs_diff": dm, "bit_identical": same}
        log(f"smoke: {w}x{h}@2spp pool {pool or 4096} lanes, three runs: "
            f"bit-identical {same}, max |d| between runs {d:.3g}, mean {dm:.3g}")
        check(d <= 3e-4, f"smoke {w}x{h}: runs differ by {d:.3g}")
    results["shade_advance"]["run_to_run"] = spread
    _smoke_spread(smoke.render_fused_fast, images, results)


def phase_smoke_module(results: dict) -> None:
    """`python -m raytracer_project_tpu_torch.utils.smoke` in a subprocess
    under a timeout, as the bench runs it: exit 0 after all five stages,
    a device-golden diff line for each of the five device goldens, and
    the seconds of each stage; then SMOKE_FAST=1 runs fused-fast alone."""
    import re

    cmd = [sys.executable, "-m", "raytracer_project_tpu_torch.utils.smoke"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"  | {line}")
    check(proc.returncode == 0,
          f"smoke module exit {proc.returncode}: {proc.stderr[-2000:]}")
    diffs = [ln for ln in proc.stdout.splitlines() if "device-golden diff" in ln]
    check(len(diffs) == 5, f"smoke module: {len(diffs)} device-golden diffs")
    marks = {}
    for ln in proc.stdout.splitlines():
        m = re.match(r"SMOKE \[\s*([\d.]+)s\] stage (\S+): (start|PASS)", ln)
        if m:
            marks.setdefault(m.group(2), {})[m.group(3)] = float(m.group(1))
    stages = {k: v["PASS"] - v["start"] for k, v in marks.items()}
    log(f"smoke module: rc 0 in {wall:.1f} s (process wall); stage seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    check(len(stages) == 5, f"smoke module: stages {list(stages)}")
    fast = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, SMOKE_FAST="1"))
    check(fast.returncode == 0 and "stages=['fused-fast']" in fast.stdout,
          f"SMOKE_FAST=1: exit {fast.returncode}: {fast.stdout[-500:]}")
    log("smoke module: SMOKE_FAST=1 ran fused-fast alone, exit 0")
    results["shade_advance"]["smoke_stage_s"] = stages


def _render_timed(width, height, spp, seed):
    import numpy as np
    import torch

    from raytracer_project_tpu_torch.ops import integrator

    scene, cam, env = _showcase(width, height)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = integrator.render(scene, cam, env, seed,
                                   _cfg(width, height, spp), with_stats=True)
    img = out["beauty"].cpu().numpy()
    wall = time.perf_counter() - t0
    check(bool(np.isfinite(img).all()) and img.max() > 0,
          f"{width}x{height}@{spp}: image not finite or black")
    log(f"full: {width}x{height}@{spp}spp wall {wall:.3f} s, segments "
        f"{stats['segments']}, steps {stats['steps']}, segments/s "
        f"{stats['segments'] / wall:.4g}, mean {img.mean():.4f}")
    return wall, stats


def phase_full(results: dict) -> None:
    _render_timed(800, 450, 2, 0)  # warm-up: same kernels and lane count
    _reset_counters()
    _render_timed(800, 450, 32, 1)
    launches = _launches(FUSED_KERNELS)
    log(f"full: main-path launches {launches} (K2 and the unfused K3: 0)")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    for name, n in launches.items():
        results[name]["launches"] = n
    results["decode"]["main_path_launches"] = 0
    _render_timed(1920, 1080, 8, 2)
    _profile("800x450@32spp fused", _showcase(800, 450), _cfg(800, 450, 32),
             fused=True)


def _profile(label: str, inputs, cfg, host: bool = True,
             fused: bool = False) -> dict | None:
    """Device time by kernel and the device's idle share over one render
    (seed 1) of `cfg`: `_profile_fn` of the render, and with `fused` (a
    render on the fused pool) `_fused_trace` of it."""
    from raytracer_project_tpu_torch.ops import integrator

    scene, cam, env = inputs
    prof = _profile_fn(label, lambda: integrator.render(
        scene, cam, env, 1, cfg)["beauty"].cpu(), host)
    return _fused_trace(label, prof, scene.primitive_count) if fused else prof


def _k1_kernel(prims: int) -> str:
    """The device kernel of the fused pool's closest hit for a scene of
    `prims` primitives: the BVH walk from BVH_MIN_PRIMS on, else K1's tile
    scan."""
    from raytracer_project_tpu_torch.ops import intersect

    return K1_KERNELS[int(prims >= intersect.BVH_MIN_PRIMS)]


def _fused_trace(label: str, prof: dict | None, prims: int) -> dict | None:
    """Checks that a profile of the fused pool of a scene of `prims`
    primitives holds no index_add_ (no device kernel of it, no
    aten::index_add_ among the host ops traced), and that its closest hit
    ran as `_k1_kernel(prims)` alone, and logs the device launches per pool
    step: the closest hit, K3 fused and its respawn over the closest hit's
    launches (the steps launched, the pool's drain steps included), beside
    the other kernels of the render."""
    if prof is None:
        return None
    scatters = [k for k in list(prof["kernels"]) + list(prof["host_ops"])
                if "index_add" in k or "indexFunc" in k]
    check(not scatters, f"{label}: index_add_ on the fused pool: {scatters}")
    step, other = {}, 0
    for k, (_, c) in prof["kernels"].items():
        tag = next((t for t in K1_KERNELS + ("shade_kernel", "respawn_kernel")
                    if t in k), None)
        if tag:
            step[tag] = step.get(tag, 0) + c
        elif not k.startswith(("Memcpy", "Memset")):
            other += c
    want = _k1_kernel(prims)
    n = step.get(want, 0)
    check(n > 0, f"{label}: no {want} launch in the trace ({prims} "
          f"primitives)")
    other_k1 = {t: step[t] for t in K1_KERNELS if t != want and t in step}
    check(not other_k1, f"{label}: {other_k1} in the trace of a scene of "
          f"{prims} primitives, which takes {want}")
    prof["launches_per_step"] = sum(step.values()) / n
    log(f"  {label}: no index_add_ in the trace; "
        f"{prof['launches_per_step']:.2f} device launches per pool step "
        f"({step}), and {other} other kernels (tables, initial fill, "
        f"read-back)")
    return prof


def _profile_fn(label: str, fn, host: bool = True) -> dict | None:
    """Device time by kernel and the device's idle share over one call of
    `fn` (which ends in a host read), from a torch.profiler trace: logged,
    and returned as {"wall_ms", "busy_ms", "kernels": {name: (ms, count)}}
    (None when the trace holds no device time). host=False traces the
    device only (a render of ~10^5 small kernels otherwise takes a minute
    to trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    # Kernel executions only (device-side events); host ops are left out,
    # since they carry the device time of the kernels they launch.
    spans, by_name, host_ops = [], {}, set()
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            host_ops.add(ev.name)
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        tot, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + (end - start), cnt + 1)
    if not spans:
        log(f"profile {label}: the trace holds no device time (not measured)")
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for st, en in spans[1:]:
        if st > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy = (busy + cur_e - cur_s) / 1e3
    log(f"profile {label}: wall {wall * 1e3:.1f} ms under the profiler, "
        f"device busy {busy:.1f} ms, idle share "
        f"{max(0.0, 1.0 - busy / (wall * 1e3)):.3f}, {len(spans)} kernels")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"  {tot / 1e3:9.3f} ms  {cnt:5d}x  {tot / 1e3 / cnt:8.4f} ms each  "
            f"{name[:80]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy, "host_ops": host_ops,
            "kernels": {k: (t / 1e3, c) for k, (t, c) in by_name.items()}}


# --- phases 5 and 6: the chunked integrator ----------------------------------

def _chunked_cfg(width, height, spp, max_depth=10, aovs=True):
    from raytracer_project_tpu_torch.ops import integrator

    return integrator.RenderConfig(
        width=width, height=height, samples_per_pixel=spp, max_depth=max_depth,
        use_albedo=aovs, use_normal=aovs, use_z_depth=aovs,
        use_reflection=aovs, use_refraction=aovs, wavefront=False)


def _image_agree(name, img, ref) -> None:
    """The cross-backend budgets: mean |d| <= 0.06, <= 20% of pixels with a
    channel over 0.05."""
    import numpy as np

    d = np.abs(img - ref)
    mean, frac = float(d.mean()), float((d.max(axis=-1) > 0.05).mean())
    log(f"  {name}: mean|d| {mean:.5f} frac(>0.05) {frac:.4f} "
        f"(budgets 0.06 / 0.20)")
    check(bool(np.isfinite(img).all()), f"{name}: not finite")
    check(mean <= 0.06 and frac <= 0.20, f"{name}: disagrees")


def phase_chunked_smoke() -> None:
    import numpy as np
    import torch

    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import integrator

    dev = torch.device("cuda")
    scene = presets.showcase_scene(grid=6).to(dev)
    cam = tcam.make_camera(image_width=64, image_height=36, **CAM_KW)
    env = tenv.make_environment(**ENV_KW)
    _reset_counters()
    with _PlainCallCounter() as plain, _NonFiniteLanes() as odd:
        cfg = _chunked_cfg(64, 36, 8, max_depth=6, aovs=False)
        out = integrator.render(scene, cam, env, 0, cfg)
        img = out["beauty"].cpu().numpy()
    launches = _launches(CHUNKED_KERNELS)
    log(f"chunked smoke: 64x36@8spp depth 6 launches {launches}, plain calls "
        f"{plain.calls}; K4 lanes with non-finite features {odd.lanes} of "
        f"{odd.total}")
    check(all(v > 0 for v in launches.values()), "K4 was not launched")
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "showcase.npz"))["beauty"]
    check(img.max() > 0, "chunked smoke image black")
    _image_agree("64x36@8spp vs CPU golden showcase.npz", img, golden)

    scene = presets.showcase_scene()
    cam = tcam.make_camera(image_width=32, image_height=18, **CAM_KW)
    cfg = _chunked_cfg(32, 18, 4)
    with _PlainCallCounter() as plain, _NonFiniteLanes() as odd:
        card = integrator.render(scene.to(dev), cam, env, 4, cfg)
        card = {k: v.cpu().numpy() for k, v in card.items()}
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    t0 = time.perf_counter()
    cpu = integrator.render(scene, cam, env, 4, cfg, device="cpu")
    log(f"chunked smoke: 32x18@4spp, six buffers; CPU render "
        f"{time.perf_counter() - t0:.1f} s; K4 lanes with non-finite "
        f"features {odd.lanes} of {odd.total}")
    for name, ref in cpu.items():
        _image_agree(f"32x18@4spp {name} card vs CPU", card[name], ref.numpy())


def phase_chunked_full(results: dict) -> None:
    import numpy as np
    import torch

    from raytracer_project_tpu_torch.ops import integrator

    inputs = _showcase(800, 450)
    integrator.render(*inputs, 0, _chunked_cfg(800, 450, 1))   # warm-up
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = integrator.render(*inputs, 1, _chunked_cfg(800, 450, 32),
                                   with_stats=True)
    imgs = {k: v.cpu().numpy() for k, v in out.items()}
    wall = time.perf_counter() - t0
    launches = _launches(CHUNKED_KERNELS)
    log(f"chunked full: 800x450@32spp depth 10, six buffers, "
        f"wall {wall:.3f} s, "
        f"chunks {stats['steps']}, segments {stats['segments']}, segments/s "
        f"{stats['segments'] / wall:.4g}, launches {launches}")
    check(all(v > 0 for v in launches.values()), "K4 was not launched")
    for name, n in launches.items():
        results[name]["launches"] = n
    for name, img in imgs.items():
        check(bool(np.isfinite(img).all()), f"chunked full {name} not finite")
        log(f"  {name}: mean {img.mean():.4f} max {img.max():.4f}")
    check(imgs["beauty"].max() > 0 and imgs["normal"].min() >= 0.0,
          "chunked full image bad")
    _profile("800x450@4spp chunked", inputs, _chunked_cfg(800, 450, 4))


# --- phases 7-9: the fused pool with every feature ---------------------------

def phase_k3_features(results: dict) -> None:
    """K3's variant with fog, the three AOVs and both split passes, against
    its plain version at the main path's 131,072 lanes: the fog showcase's
    camera rays of the 800x450 @ 32 spp render with every other lane a spec
    lane (so bounce-0 routing and AOVs act), and the state one plain step
    later (bounce 1, with routing flags and first-hit attenuations set)."""
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.core.constants import T_MIN
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs

    dev = torch.device("cuda")
    scene, cam, env = _showcase(800, 450, use_fog=True)
    tables = fs.build_tables(scene, env, tenv.PHYSICAL_SUN)
    aparams = fs._aparams(env, dev)
    bparams = fs._bparams(cam, env, dev)
    n = 800 * 450
    n_beauty = n * 23
    sp = fs.StepParams(
        seed=rng.seed_from_int(0), sample_offset=0, n_pixels=n, width=800,
        total_work=2 * n_beauty, max_depth=10, env_mode=tenv.PHYSICAL_SUN,
        aux=32, z_max=50.0, aovs=fs.AOVS, use_reflection=True,
        use_refraction=True, n_beauty=n_beauty,
        n_volumes=scene.volumes.count)
    w = torch.arange(P_MAIN, device=dev)
    li = (w // 2 % n).to(torch.int32)
    samp = (w // 2 // n).to(torch.int32)
    spec = (w % 2).to(torch.int32)
    o, d = tcam.generate_rays_soa(cam.to(dev), rng.LaneRng(
        sp.seed, rng.u32(li), rng.u32(samp), 0), li, 800)
    ones = torch.ones(P_MAIN, device=dev)
    state_f = torch.stack([*o, *d, ones, ones, ones, 0 * ones, 0 * ones,
                           0 * ones, ones, ones, ones]).contiguous()
    state_i = torch.stack([torch.ones_like(li), torch.zeros_like(li), samp, li,
                           spec, 0 * spec, 0 * spec]).contiguous()
    next_work = torch.tensor([P_MAIN], dtype=torch.int32, device=dev)
    segments = torch.zeros(1, dtype=torch.int64, device=dev)
    states = {"camera": (state_f, state_i)}
    rec0 = fs.trace_decode(tables, state_f[:6].contiguous(), aparams)
    step1 = fs.shade_advance_plain(tables, rec0, state_f, state_i, next_work,
                                   segments, bparams, sp)
    states["bounce"] = (step1[0].contiguous(), step1[1].contiguous())
    err, flips = 0.0, 0
    for name, (sf, si) in states.items():
        rec = fs.trace_decode(tables, sf[:6].contiguous(), aparams)
        args = (rec, sf, si, next_work, segments, bparams, sp)
        out = fs.shade_advance(tables, *args)
        ref = fs.shade_advance_plain(tables, *args)
        torch.cuda.synchronize()
        bad = torch.zeros(P_MAIN, dtype=torch.bool, device=dev)
        for a, b in zip(out[:4], ref[:4]):
            if a.dtype.is_floating_point:
                close = torch.isclose(a, b, rtol=1e-5, atol=1e-5).all(0)
                bad |= ~close
                err = max(err, float((a - b).abs()[:, close].max()))
            else:
                bad |= (a != b).any(0)
        n_bad = int(bad.sum())
        flips = max(flips, n_bad)
        lanes = torch.nonzero(bad).flatten()[:8].tolist()
        log(f"  K3 features ({name}): spec lanes {int((si[4] > 0).sum())}, "
            f"lanes that differ {n_bad} (budget {P_MAIN // 200}) {lanes}; "
            f"next_work {int(out[4])} vs {int(ref[4])}, live {int(out[6])} "
            f"vs {int(ref[6])}")
        check(n_bad <= P_MAIN // 200, f"K3 features ({name}): {n_bad} lanes")
        check(int(out[5]) == int(ref[5]), "K3 features: segment count")
    # K3 fused's feature variant on the same states. A pixel's beauty and
    # spec lanes add to different channels, so each address gets at most
    # one add: the accumulator within 1e-5 off the pixels of lanes that
    # flip a fog flight.
    err_f = 0.0
    hits = {}
    for name, (sf, si) in states.items():
        hits[name] = k1.closest_hit(sf[:6].contiguous(), T_MIN, tables.scan)
        err_f = max(err_f, fused_against_plain(
            f"K3 fused features ({name})", tables, hits[name],
            (sf, si, next_work, segments), aparams, bparams, sp, 1e-5,
            P_MAIN // 200))
    rec1 = fs.trace_decode(tables, states["bounce"][0][:6].contiguous(), aparams)
    args = (rec1, *states["bounce"], next_work, segments, bparams, sp)
    t_k3 = time_ms("K3 features", lambda: fs.shade_advance(tables, *args))
    t_k3p = time_ms("K3 features plain",
                    lambda: fs.shade_advance_plain(tables, *args), rounds=3)
    state = (*states["bounce"], next_work, segments)
    hb = hits["bounce"]
    acc = fs.new_accumulator(sp, dev)
    steps = torch.zeros(1, dtype=torch.int64, device=dev)
    fused = lambda: fs.shade_accumulate(tables, hb, *state, steps, aparams,
                                        bparams, sp, acc)
    old = _old_step(tables, hb, state, aparams, bparams, sp,
                    fs.new_accumulator(sp, dev))
    t_f, t_old = time_ms("K3 fused features", fused), time_ms(
        "K2 + K3 features + index_add_", old)
    t_old = (t_old + time_ms("K2 + K3 features + index_add_", old)) / 2
    t_f = (t_f + time_ms("K3 fused features", fused)) / 2
    t_fp = time_ms("K3 fused features plain", lambda: fs.shade_accumulate_plain(
        tables, hb, *state, steps, aparams, bparams, sp, acc), rounds=3)
    contrib, tgt, adds = _step_adds(tables, hb, state, aparams, bparams, sp)
    f_bytes = k3_fused_bytes(tables, hb, state, aparams, sp, adds)
    n_c, n_t = fs.output_rows(sp)
    nf, ni = fs.state_rows(sp)
    # Record rows, state in and out, texel words, contributions, targets.
    nbytes = P_MAIN * 4 * (fs._RO_ROWS + 2 * (nf + ni) + 6 + n_c + n_t)
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    f_bound = f_bytes / PEAK_BYTES_PER_S * 1e3
    results["shade_advance_features"] = dict(
        name="shade_advance_features", route="cuda",
        source="raytracer_project_tpu_torch/csrc/shade_advance.cu",
        replaces="raytracer_project_tpu/ops/fused_step.py:669",
        also_replaces=["raytracer_project_tpu/ops/fused_step.py:326",
                       "raytracer_project_tpu/ops/fused_step.py:1398"],
        variant="fused", max_abs_err=err_f, ms=t_f, plain_ms=t_fp,
        bound_ms=f_bound, bound_by="bytes", library_ms=None,
        bytes_per_lane=f_bytes / P_MAIN, adds=adds, yardstick_ms=t_old,
        unfused_ms=t_k3, unfused_plain_ms=t_k3p, unfused_bound_ms=bound,
        unfused_max_abs_err=err,
        accumulator=accumulator_block("features", contrib, tgt, sp))
    log(f"  K3 fused features: {t_f:.4f} ms/launch against K2 + K3 features "
        f"+ index_add_ {t_old:.4f} ms; plain {t_fp:.4f} ms, bound "
        f"{f_bound:.4f} ms (bytes, {f_bytes / P_MAIN:.1f} B/lane, {adds} "
        f"adds); unfused K3 features {t_k3:.4f} ms, plain {t_k3p:.4f} ms, "
        f"bound {bound:.4f} ms ({nbytes // P_MAIN} B/lane), most lanes that "
        f"differ {flips}")


def _features_cfg(width, height, spp, **kw):
    from raytracer_project_tpu_torch.ops import integrator

    return integrator.RenderConfig(
        width=width, height=height, samples_per_pixel=spp, max_depth=10,
        use_reflection=True, use_refraction=True, **kw)


def phase_features_smoke(results: dict) -> None:
    """The reference's fused-features stage on the card (utils/smoke.py:
    241-292) through the smoke module's render, against its device and
    CPU goldens, and its run-to-run spread."""
    from raytracer_project_tpu_torch.utils import smoke

    _reset_counters()
    with _PlainCallCounter() as plain:
        images = smoke.render_fused_features("cuda")
    launches = _launches(FEATURES_KERNELS)
    log(f"features smoke: 64x36@4spp fog, AOVs, passes: launches {launches}, "
        f"plain calls {plain.calls}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    _smoke_gate_check(images)
    _smoke_spread(smoke.render_fused_features, images, results)


def phase_features_full(results: dict) -> None:
    """800x450 @ 32 spp, depth 10, fog, the three AOVs and both passes
    through the fused pool (two sample chunks of 23 and 9 spp, with the spec
    lanes twice the work of beauty alone)."""
    import numpy as np
    import torch

    from raytracer_project_tpu_torch.ops import integrator

    inputs = _showcase(800, 450, use_fog=True)
    integrator.render(*inputs, 0, _features_cfg(800, 450, 2))   # warm-up
    _reset_counters()
    torch.cuda.synchronize()
    with _PlainCallCounter() as plain:
        t0 = time.perf_counter()
        out, stats = integrator.render(*inputs, 1, _features_cfg(800, 450, 32),
                                       with_stats=True)
        imgs = {k: v.cpu().numpy() for k, v in out.items()}
        wall = time.perf_counter() - t0
    launches = _launches(FEATURES_KERNELS)
    log(f"features full: 800x450@32spp depth 10, fog, six buffers, wall "
        f"{wall:.3f} s, segments {stats['segments']}, steps {stats['steps']}, "
        f"segments/s {stats['segments'] / wall:.4g}, launches {launches}, "
        f"plain calls {plain.calls}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    results["shade_advance_features"]["launches"] = launches[
        "shade_advance_features"]
    for name, img in imgs.items():
        log(f"  {name}: mean {img.mean():.4f} max {img.max():.4f}")
        check(bool(np.isfinite(img).all()) and img.max() > 0,
              f"features full {name}: not finite or zero")
    # The albedo AOV against the first hits of a chunked render of the same
    # frame (1 spp, depth 1): a dimmed AOV would show here.
    ref = integrator.render(*inputs, 1, _chunked_cfg(800, 450, 1, max_depth=1))
    ref_mean = float(ref["albedo"].mean())
    rel = abs(float(imgs["albedo"].mean()) - ref_mean) / ref_mean
    log(f"  albedo mean {imgs['albedo'].mean():.5f} vs first-hit chunked "
        f"{ref_mean:.5f}: {rel:.4f} relative (limit 0.02)")
    check(rel <= 0.02, "features full: albedo mean off")
    _profile("800x450@32spp fused features", inputs,
             _features_cfg(800, 450, 32), fused=True)


# --- phase 10: the kernel probes ----------------------------------------------

def sass_opcodes(source: str) -> dict:
    """Opcode counts of each kernel of the built csrc/<source>.cu, from
    cuobjdump -sass (mangled kernel name -> {opcode: count})."""
    import re
    import shutil

    from raytracer_project_tpu_torch import kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(kernels.BUILD_DIR /
                                              f"lib{source}.so")],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), {})
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if m and cur is not None:
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return counts


def ptxas_resources(source: str) -> dict:
    """Registers, spill-store bytes and stack frame bytes of each kernel of
    csrc/<source>.cu from its build log (nvcc -Xptxas -v): mangled name ->
    (registers, spill bytes, stack bytes)."""
    import re

    from raytracer_project_tpu_torch import kernels

    out, cur = {}, None
    for line in (kernels.BUILD_DIR / f"{source}.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = [0, 0, 0]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and cur:
            out[cur][2], out[cur][1] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def _kernel_code(source: str, tag: str) -> dict:
    """{mangled name: (SASS opcode counts, (registers, spill bytes))} of the
    kernels of csrc/<source>.cu whose name holds `tag`."""
    res = ptxas_resources(source)
    return {name: (ops, res.get(name, (None, None, None)))
            for name, ops in sass_opcodes(source).items() if tag in name}


def _log_code(label: str, ops: dict, res) -> None:
    log(f"  SASS {label}: {sum(ops.values())} instructions, {res[0]} "
        f"registers, {res[1]} B spilled, {res[2]} B stack; LDG "
        f"{ops.get('LDG', 0)}, STG {ops.get('STG', 0)}, LDL "
        f"{ops.get('LDL', 0)}, STL {ops.get('STL', 0)}, BRA "
        f"{ops.get('BRA', 0)}; FFMA {ops.get('FFMA', 0)}, MUFU "
        f"{ops.get('MUFU', 0)}, FSETP {ops.get('FSETP', 0)}, LDGSTS "
        f"{ops.get('LDGSTS', 0)}, LDS {ops.get('LDS', 0)}, BAR "
        f"{ops.get('BAR', 0)}, VOTE {ops.get('VOTE', 0)}")


def _p1_sass() -> None:
    """The SASS and registers of P1's variants: the compact-scan probe's
    four instantiations of tile_scan_kernel beside K1's and K4's (the same
    template at SCAN_FULL, from csrc/closest_hit.cu), and the dense
    yardstick's. The work a variant takes away is gone, and only that
    work: cheapepi keeps the dots (FFMA), nodots the epilogues (MUFU: the
    sqrt and the reciprocals) and drops the row copies (LDGSTS:
    cp.async)."""
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa

    for label, tag in (("K1", "ILb1ELi0ELb0EE"), ("K4", "ILb0ELi0ELb0EE")):
        found = _kernel_code("closest_hit", "tile_scan_kernel" + tag)
        check(len(found) == 1, f"{label}'s tile_scan_kernel: {list(found)}")
        _log_code(f"{label} tile_scan_kernel<SCAN_FULL>",
                  *next(iter(found.values())))
    code = _kernel_code("probe_a1_ablate", "tile_scan_kernel")
    dense = _kernel_code("probe_a1_ablate", "ablate_kernel")
    new_ops, dense_ops = {}, {}
    for i, v in enumerate(pa.VARIANTS):
        name = next(n for n in code if f"ILb1ELi{i}ELb1EE" in n)
        new_ops[v] = code[name][0]
        _log_code(f"P1 tile_scan_kernel<{v}>", *code[name])
        name = next(n for n in dense if f"ILi{i}E" in n)
        dense_ops[v] = dense[name][0]
        _log_code(f"P1 dense ablate_kernel<{v}>", *dense[name])
    # The compact dots: 9 + 19 + 21 structural FMAs, unrolled once per
    # table's row loop, and the 7 FMAs of ray features 6-10 that they read
    # (csrc/closest_hit.cuh ray_features); the dense ones 16 per output.
    dots = sum(map(len, (k for s in k1.SLOTS for k in s)))
    check(new_ops["cheapepi"].get("FFMA", 0) >= dots + 7,
          "cheapepi lost its dots")
    check(new_ops["nodots"].get("MUFU", 0) >= new_ops["full"].get("MUFU", 0),
          "nodots lost its epilogues")
    check(new_ops["nodots"].get("FFMA", 0) < new_ops["full"].get("FFMA", 0)
          and new_ops["nodots"].get("LDGSTS", 0) == 0
          and new_ops["full"].get("LDGSTS", 0) > 0, "nodots kept its dots")
    check(dense_ops["cheapepi"].get("FFMA", 0) >= 192,
          "dense cheapepi lost its dots")
    check(dense_ops["nodots"].get("MUFU", 0) >= dense_ops["full"].get("MUFU", 0),
          "dense nodots lost its epilogues")


def _p1_rows(results: dict, key: str, od, entry, fn, plain, counter, nbytes,
             flops, t_k1) -> None:
    """One of P1's two kernels on the probe's rays: each variant through its
    entry with the counts read around it, against its plain version, full
    and nocull against K1's t (t_k1) bit for bit, timed, with its bound."""
    import torch

    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa

    for v in pa.VARIANTS:
        _reset_counters()
        entry(v)
        launches = counter.launches
        check(launches > 0, f"{key} {v}: not launched")
        t = fn(v)[0]
        ref = plain(v)[0]
        torch.cuda.synchronize()
        stats = pa.compare(v, t, ref)
        log(f"  {key} {v} vs plain: {stats}")
        check(stats["ok"], f"{key} {v} disagrees with its plain version")
        if v in ("full", "nocull"):
            lanes = torch.nonzero(t.view(torch.int32)
                                  != t_k1.view(torch.int32)).flatten()
            for i in lanes[:8].tolist():
                log(f"    lane {i}: {key} {v} t {float(t[i]):.9g} K1 t "
                    f"{float(t_k1[i]):.9g}")
            log(f"  {key} {v} vs K1 at tmin 0: {lanes.numel()} lanes differ")
            check(lanes.numel() == 0, f"{key} {v} differs from K1")
        ms = time_ms(f"{key} {v}", lambda: fn(v))
        plain_ms = time_ms(f"{key} {v} plain", lambda: plain(v), n=3, rounds=3)
        ops = flops(v)
        bound, by = bound_ms(nbytes(v), ops)
        log(f"  {key}.{v}: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, "
            f"bound {bound:.4f} ms ({by}, {ops / od.shape[1]:.0f} operations "
            f"per ray), {ms / bound:.1f}x the bound, launches {launches}")
        check(ms >= bound, f"{key} {v} runs below its bound: work was dropped")
        results[f"{key}.{v}"] = dict(
            name=f"{key}.{v}", route="cuda",
            source="raytracer_project_tpu_torch/csrc/probe_a1_ablate.cu",
            replaces="tools/probe_a1_ablate.py:43", launches=launches,
            max_abs_err=stats["max_abs_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None)


def _probe_p1(results: dict) -> None:
    """P1 on the probe's 262,144 rays: the compact-scan probe (K1's own
    scan, P1.*) and its dense yardstick (P1_dense.*), each variant through
    its entry (`run`, `run_dense`) with the counts read around it, against
    its plain version (the card's grouping: warps over 128-wide tiles; the
    yardstick's: warps over 512-wide chunks), full and nocull against K1
    bit for bit (the dense scan's t is the compact one's on finite
    features), timed, with its operation bound."""
    import torch

    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import intersect
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa

    dev = torch.device("cuda")
    scene = _showcase(8, 8)[0]
    tables = k1.scan_tables(scene)
    dense = pa.scene_tables(scene)
    fine = fine_tables(scene, tables)
    od = pa.make_rays(pa.P, 0, dev)
    _p1_sass()
    t_k1 = k1.closest_hit(od, 0.0, tables)[0]
    t_full = pa.ablate(od, 0.0, tables, "full")[0]
    rows = sum(4 * (r.numel() + b.numel())
               for r, b in zip(tables.rows, tables.bounds))
    _p1_rows(results, "P1", od,
             lambda v: pa.run(v, od, tables),
             lambda v: pa.ablate(od, 0.0, tables, v),
             lambda v: pa.ablate_plain(od, 0.0, tables.coeffs, tables.bounds,
                                       tables.counts, v),
             pa.ablate,
             lambda v: pa.P * (6 * 4 + 3 * 4) + (0 if v == "nodots" else rows),
             lambda v: p1_operations(od, t_full, fine, v, intersect.MM_FINE),
             t_k1)
    dense_bytes = pa.P * (6 * 4 + 3 * 4) + sum(
        4 * (c.numel() + b.numel()) for c, b in zip(*dense[:2]))
    _p1_rows(results, "P1_dense", od,
             lambda v: pa.run_dense(v, od, *dense),
             lambda v: pa.ablate_dense(od, 0.0, *dense, v),
             lambda v: pa.ablate_plain(od, 0.0, *dense, v),
             pa.ablate_dense, lambda v: dense_bytes,
             lambda v: p1_operations(od, t_full, dense, v, k1.CHUNK_PRIMS),
             t_k1)


def _bits_differ(out, ref) -> int:
    """Values of two f32 results (tensors or tuples of them) whose bits
    differ."""
    import torch

    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    return sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
               for a, b in zip(out, ref))


def _probe_onehot(results: dict) -> None:
    """P2 and P4's five layouts at the pool's width: each through its entry
    (`main`) with the counts read around it, against the plain version on a
    random table and indices in [-2, n_rows + 2) (exact) and against its
    yardstick (the first port's kernel) bit for bit, timed there and at the
    probes' 8,192 lanes beside the yardstick, the fetch in place and staged
    (the modes with a table; the entry picks one) and index_select + add."""
    import torch

    from raytracer_project_tpu_torch.tools import probe_onehot as po
    from raytracer_project_tpu_torch.tools import probe_onehot2 as po2

    dev = torch.device("cuda")
    n_rows, n_out = 1536, 24
    cases = [("P2", "col", lambda: po.main(2048, 512, n_rows, n_out, P_MAIN))]
    cases += [(f"P4.{m}", m, lambda m=m: po2.main(m, n_out, 2048, n_rows, P_MAIN))
              for m in po.MODES]
    for name, mode, entry in cases:
        _reset_counters()
        entry()
        launches = po.onehot_fetch.launches
        check(launches > 0, f"{name}: not launched")
        plain, transposed, matrix = po.MODES[mode]
        sizes = {}
        for p in (P_MAIN, 8192):
            t, idx, table = po.make_inputs(n_rows, p, transposed, seed=1,
                                           device=dev)
            fn = lambda: po.onehot_fetch(t, idx, table, n_out, mode)
            scalar = lambda: po.onehot_fetch_scalar(t, idx, table, n_out, mode)
            in_place = lambda: po.onehot_fetch(t, idx, table, n_out, mode,
                                               staged=False)
            staged = lambda: po.onehot_fetch(t, idx, table, n_out, mode,
                                             staged=True)
            ref = po.onehot_fetch_plain(t, idx, table, n_out, mode)
            for label, f in (("kernel", fn), ("in place", in_place),
                             ("yardstick", scalar)) + (
                    () if plain else (("staged", staged),)):
                bad = _bits_differ(f(), ref)
                check(bad == 0, f"{name} {label} p={p}: {bad} values differ "
                      "from the plain version")
            # The library's fetch: index_select of the table with a zero
            # row appended, indices mapped beforehand (outside: that row),
            # then the add of t; it fetches all 28 columns.
            row = idx.to(torch.int32).long()
            row = torch.where((row >= 0) & (row < n_rows), row, n_rows)
            if plain:
                ks = torch.arange(n_out, device=dev, dtype=torch.float32)[:, None]
                lib = lambda: torch.add(t, ks)
            elif transposed:
                tab1 = torch.cat([table, table.new_zeros(28, 1)], 1)
                lib = lambda: torch.index_select(tab1, 1, row).add_(t)
            else:
                tab1 = torch.cat([table, table.new_zeros(1, 28)])
                lib = lambda: torch.index_select(tab1, 0, row).add_(t[:, None])
            sizes[p] = dict(
                ms=time_ms(f"{name} p={p}", fn),
                yardstick_ms=time_ms(f"{name} yardstick p={p}", scalar),
                in_place_ms=None if plain else time_ms(
                    f"{name} in place p={p}", in_place),
                staged_ms=None if plain else time_ms(f"{name} staged p={p}",
                                                     staged),
                plain_ms=time_ms(f"{name} plain p={p}", lambda: po.onehot_fetch_plain(
                    t, idx, table, n_out, mode), rounds=3),
                library_ms=time_ms(f"{name} library p={p}", lib),
                bound=bound_ms(p * (4 * (1 if plain else 2) + 4 * n_out)
                               + (0 if plain else table.numel() * 4)))
        r, r8 = sizes[P_MAIN], sizes[8192]
        staged_text = "" if plain else (
            f", in place {r['in_place_ms']:.5f} ({r8['in_place_ms']:.5f}), "
            f"staged {r['staged_ms']:.5f} ({r8['staged_ms']:.5f})")
        log(f"  {name}: exact and equal to its yardstick at {P_MAIN} and "
            f"8192 lanes; {r['ms']:.5f} ms/launch (at 8192: {r8['ms']:.5f}), "
            f"yardstick {r['yardstick_ms']:.5f} ({r8['yardstick_ms']:.5f})"
            f"{staged_text}, plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.5f} ({r8['library_ms']:.5f}), bound "
            f"{r['bound'][0]:.5f} ({r8['bound'][0]:.5f}) ms; launches "
            f"{launches}")
        results[name] = dict(
            name=name, route="cuda",
            source="raytracer_project_tpu_torch/csrc/probe_onehot.cu",
            replaces=("tools/probe_onehot.py:22" if name == "P2"
                      else "tools/probe_onehot2.py:52"),
            launches=launches, max_abs_err=0.0, ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
            yardstick_ms=r["yardstick_ms"], in_place_ms=r["in_place_ms"],
            staged_ms=r["staged_ms"],
            ms_8192=r8["ms"], yardstick_ms_8192=r8["yardstick_ms"],
            bound_ms_8192=r8["bound"][0])


def _probe_decode(results: dict) -> None:
    """P3's stages d0-d2 and d3 (= K2) on K1's hits of the showcase camera
    rays at the pool's width: each through its entry (`run`) with the counts
    read around it, against its plain version, d0-d2 against their
    yardstick (the first port's kernel) bit for bit, also on the lanes
    shuffled from a seed, timed there and at the probe's 8,192 lanes beside
    the yardstick, with the byte bound."""
    import torch

    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.tools import probe_decode as pd

    inputs = {p: pd.camera_hits(p) for p in (P_MAIN, 8192)}
    tables, od, hit, _ = inputs[P_MAIN]
    perm = torch.randperm(P_MAIN, generator=torch.Generator().manual_seed(4))
    perm = perm.to(od.device)
    shuffled = (od[:, perm].contiguous(),
                *(x[perm].contiguous() for x in hit))
    k2_int = (fs._RO_HIT, fs._RO_FRONT, fs._RO_MTYPE, fs._RO_GU, fs._RO_GV,
              fs._RO_HASB, fs._RO_TEXROW, fs._RO_BUMPROW, fs._RO_ENVROW)
    for v in ("d0", "d1", "d2", "d3"):
        _reset_counters()
        pd.run(v, *inputs[P_MAIN])
        counter = pd.decode_stage if v in pd.STAGES else fs.decode
        launches = counter.launches
        check(launches > 0, f"P3 {v}: not launched")
        if v == "d3":
            # K2 runs on no render path now: its launches are the probe's.
            results["decode"]["launches"] = launches
        yard = {}
        if v in pd.STAGES:
            stage = pd.STAGES[v]
            plain = lambda tables, od, hit, ap: pd.decode_stage_plain(
                stage, tables, od, *hit)
            exact = (tuple(range(24)) if stage == 0 else
                     tuple(k for k in range(24) if k not in range(2, 11)
                           and k not in (12, 13)))
            bad = _bits_differ(pd.decode_stage(stage, tables, *shuffled),
                               pd.decode_stage_scalar(stage, tables, *shuffled))
            check(bad == 0, f"P3 {v}: {bad} values differ from the yardstick "
                  "on shuffled lanes")
        else:
            plain = lambda tables, od, hit, ap: fs.decode_plain(
                tables, od, *hit, ap)
            exact = k2_int
        ms, err = {}, 0.0
        for p, args in inputs.items():
            fn = pd.variant_fn(v, *args)
            out, ref = fn(), plain(*args)
            torch.cuda.synchronize()
            err = max(err, rows_agree(f"P3 {v} p={p}", out, ref, exact))
            ms[p] = time_ms(f"P3 {v} p={p}", fn)
            if v in pd.STAGES:
                scalar = lambda: pd.decode_stage_scalar(stage, args[0],
                                                        args[1], *args[2])
                bad = _bits_differ(out, scalar())
                check(bad == 0, f"P3 {v} p={p}: {bad} values differ from "
                      "the yardstick")
                yard[p] = time_ms(f"P3 {v} yardstick p={p}", scalar)
        plain_ms = time_ms(f"P3 {v} plain", lambda: plain(*inputs[P_MAIN]),
                           rounds=3)
        per_lane = (12 if v == "d0" else 36) + 4 * fs._RO_ROWS
        bound, by = bound_ms(P_MAIN * per_lane)
        yard_text = (f", yardstick {yard[P_MAIN]:.5f} ({yard[8192]:.5f} at "
                     "8192), equal bit for bit also on shuffled lanes"
                     if yard else "")
        log(f"  P3.{v}: {ms[P_MAIN]:.5f} ms/launch ({ms[8192]:.5f} at 8192 "
            f"lanes){yard_text}, plain {plain_ms:.4f} ms, bound {bound:.5f} "
            f"ms ({by}, {per_lane} B/lane), max |d| {err:.3g}, launches "
            f"{launches}")
        results[f"P3.{v}"] = dict(
            name=f"P3.{v}", route="cuda",
            source=("raytracer_project_tpu_torch/csrc/probe_decode.cu"
                    if v in pd.STAGES else
                    "raytracer_project_tpu_torch/csrc/decode.cu"),
            replaces="tools/probe_decode.py:55", launches=launches,
            max_abs_err=err, ms=ms[P_MAIN], plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None, ms_8192=ms[8192],
            bound_ms_8192=bound_ms(8192 * per_lane)[0])
        if yard:
            results[f"P3.{v}"].update(yardstick_ms=yard[P_MAIN],
                                      yardstick_ms_8192=yard[8192])
    log("  P3 d3w4096 and d3u are d3 on the card (Mosaic tiling knobs)")


def _fetch_code() -> None:
    """The SASS, registers and stack frames of P2/P4's and P3's kernels and
    of their yardsticks; the new ones keep every lane's state out of local
    memory."""
    for source in ("probe_onehot", "probe_decode"):
        for name, (ops, res) in sorted(_kernel_code(source, "_kernel").items()):
            _log_code(name, ops, res)
            if name.startswith(("_Z12fetch_kernel", "_Z12stage_kernel")):
                check(res[2] == 0 and not ops.get("STL") and not ops.get("LDL"),
                      f"{name} uses local memory")


def _fetch_causes(label: str, fetch, stage, staged: bool = False) -> dict:
    """What sets the time of one build of P2/P4's fetch and P3's stages
    (`fetch` and `stage` take onehot_fetch's and decode_stage's arguments)
    at the pool's width: the fetch in col and tdot at 1, 8, 24 and 32
    outputs, whose ms per added output is set against the 4 B per
    lane it writes (a serial chain per output costs more); d0-d2 on K1's
    hits of the showcase camera rays in pool order and with the lanes
    sorted by primitive type, so that no warp mixes types (the cost of
    divergence). With `staged`, the fetch in place and staged at 8,192 to
    131,072 lanes (where staging starts to pay)."""
    import torch

    from raytracer_project_tpu_torch.tools import probe_decode as pd
    from raytracer_project_tpu_torch.tools import probe_onehot as po

    dev = torch.device("cuda")
    per_out = bound_ms(P_MAIN * 4)[0]
    out = {}
    for mode in ("col", "tdot"):
        t, idx, table = po.make_inputs(1536, P_MAIN, po.MODES[mode][1], seed=1,
                                       device=dev)
        ms = {n: time_ms(f"{label} {mode} n_out={n}",
                         lambda n=n: fetch(t, idx, table, n, mode))
              for n in (1, 8, 24, 32)}
        slope = (ms[32] - ms[8]) / 24
        log(f"  {label} {mode}: ms at n_out 1/8/24/32 "
            + "/".join(f"{v:.5f}" for v in ms.values())
            + f"; {slope:.6f} ms per added output, {slope / per_out:.2f}x "
            f"its {per_out:.6f} ms of bytes")
        out[mode] = dict(ms=ms, per_output_ms=slope)
    if staged:
        for mode in ("col", "tdot"):
            for p in (8192, 32768, 65536, P_MAIN):
                t, idx, table = po.make_inputs(1536, p, po.MODES[mode][1],
                                               seed=1, device=dev)
                ms = [time_ms(f"{label} {mode} p={p} staged={s}",
                              lambda s=s: fetch(t, idx, table, 24, mode,
                                                staged=s))
                      for s in (False, True)]
                log(f"  {label} {mode} at {p} lanes: {ms[0]:.5f} ms in place, "
                    f"{ms[1]:.5f} ms staged")
                out[f"{mode}_{p}"] = dict(in_place_ms=ms[0], staged_ms=ms[1])
    tables, od, (t, idx, typ), _ = pd.camera_hits(P_MAIN)
    mixed = float((typ.view(-1, 32).amin(1) != typ.view(-1, 32).amax(1))
                  .float().mean())
    order = torch.sort(typ, stable=True).indices
    by_type = (od[:, order].contiguous(), t[order].contiguous(),
               idx[order].contiguous(), typ[order].contiguous())
    counts = torch.bincount(typ.long(), minlength=3).tolist()
    log(f"  {label} P3 hits: types 0/1/2 {counts}, {mixed:.3f} of warps mix "
        f"types in pool order")
    for s in (0, 1, 2):
        ms = time_ms(f"{label} d{s}", lambda: stage(s, tables, od, t, idx, typ))
        ms_sorted = time_ms(f"{label} d{s} sorted by type",
                            lambda: stage(s, tables, *by_type))
        log(f"  {label} d{s}: {ms:.5f} ms in pool order, {ms_sorted:.5f} ms "
            f"sorted by type")
        out[f"d{s}"] = dict(ms=ms, sorted_ms=ms_sorted)
    out["mixed_warps"] = mixed
    return out


def _k1_split(label: str, od, tmin: float, scene, tables, dense=None) -> dict:
    """K1's time split by P1's variants on rays od of a render path (tmin
    as the path's): full - cheapepi ~ the epilogues, full - nodots ~ the
    dots with their staging, nocull - full what the cull saves, each as a
    share of K1's ms; full and nocull held to K1's t bit for bit on every
    lane with finite features. With `dense` (scene_tables' tables) the
    dense scan's split beside it, as a share of its own full. Returns the
    ms by variant (dense_* for the yardstick's) and the shares."""
    import torch

    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import intersect
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa

    t_k1 = k1.closest_hit(od, tmin, tables)[0]
    feats = intersect.ray_features((od[0], od[1], od[2]), (od[3], od[4], od[5]))
    finite = torch.isfinite(feats[:, :13]).all(1)
    fine = fine_tables(scene, tables)
    ms = {"K1": time_ms(f"K1 ({label})", lambda: k1.closest_hit(
        od, tmin, tables))}
    for v in pa.VARIANTS:
        t = pa.ablate(od, tmin, tables, v)[0]
        if v in ("full", "nocull"):
            n_diff = int((finite & (t.view(torch.int32)
                                    != t_k1.view(torch.int32))).sum())
            log(f"  P1 {v} vs K1 ({label}): {n_diff} of {int(finite.sum())} "
                f"finite lanes differ")
            check(n_diff == 0, f"P1 {v} differs from K1 ({label})")
        ms[v] = time_ms(f"P1 {v} ({label})", lambda: pa.ablate(
            od, tmin, tables, v))
        flops = p1_operations(od, t_k1, fine, v, intersect.MM_FINE)
        log(f"  P1 {v} ({label}): {ms[v]:.4f} ms/launch "
            f"({ms[v] / ms['K1']:.3f} of K1), {flops / od.shape[1]:.0f} "
            f"operations per ray")
    out = dict(lanes=od.shape[1], ms=ms, shares=_split_shares(ms, ms["K1"]))
    log(f"  K1 split ({label}, {od.shape[1]} lanes, K1 {ms['K1']:.4f} ms): "
        + _split_text(ms, ms["K1"]))
    if dense is not None:
        dms = {v: time_ms(f"P1 dense {v} ({label})", lambda: pa.ablate_dense(
            od, tmin, *dense, v)) for v in pa.VARIANTS}
        out.update(dense_ms=dms, dense_shares=_split_shares(dms, dms["full"]))
        log(f"  dense scan split ({label}, dense full {dms['full']:.4f} ms): "
            + _split_text(dms, dms["full"]))
    return out


def _split_shares(ms: dict, whole: float) -> dict:
    f = ms["full"]
    return {"epilogues": (f - ms["cheapepi"]) / whole,
            "dots": (f - ms["nodots"]) / whole,
            "cull_saves": (ms["nocull"] - f) / whole}


def _split_text(ms: dict, whole: float) -> str:
    sh = _split_shares(ms, whole)
    f = ms["full"]
    return (f"full {f:.4f} ms; full - cheapepi {f - ms['cheapepi']:.4f} ms "
            f"({sh['epilogues']:.3f}, ~epilogues); full - nodots "
            f"{f - ms['nodots']:.4f} ms ({sh['dots']:.3f}, ~dots and "
            f"staging); nocull - full {ms['nocull'] - f:.4f} ms "
            f"({sh['cull_saves']:.3f}, what the cull saves)")


def _launch_floor(results: dict) -> None:
    """The floor under the small kernels' times: an empty kernel
    (csrc/launch_floor.cu) over the P2-P4 probes' lanes, timed as they are
    (time_ms: 20 launches back to back behind a device sleep), recorded
    with their rows and K2's and K3's, each with its bound's share of its
    time with and without the floor."""
    from raytracer_project_tpu_torch import tools

    floor = {p: time_ms(f"empty kernel over {p} lanes",
                        lambda p=p: tools.launch_floor(p))
             for p in (P_MAIN, 8192)}
    log(f"  launch floor: {floor[P_MAIN]:.5f} ms at {P_MAIN} lanes, "
        f"{floor[8192]:.5f} ms at 8192")
    for key, r in results.items():
        if key in ("decode", "shade_advance", "P2") or key.startswith(
                ("P3.", "P4.")):
            r.update(launch_floor_ms=floor[P_MAIN],
                     launch_floor_8192_ms=floor[8192])
            # K3's yardstick_ms is K2 + K3 + index_add_, not one kernel.
            for label in ("ms",) + (("yardstick_ms",) if key[0] == "P"
                                    and "yardstick_ms" in r else ()):
                ms = r[label]
                share = r["bound_ms"] / ms
                less = r["bound_ms"] / max(ms - floor[P_MAIN], 1e-6)
                r[label.replace("ms", "share")] = share
                r[label.replace("ms", "share_less_floor")] = less
                log(f"  {key} {label[:-3] or 'kernel'}: {ms:.5f} ms/launch at "
                    f"{P_MAIN} lanes, {share:.3f} of it the bound; less the "
                    f"floor {ms - floor[P_MAIN]:.5f} ms, {less:.3f}")


def phase_probes(results: dict, main_rays) -> None:
    """The four TPU probes' twins: P1 (K1 ablations, also splitting K1 on
    the main path's bounce rays `main_rays`), P2/P4 (one-hot row fetch
    layouts) and P3 (decode bisection), each beside its yardstick, with
    what sets their times; and the launch floor under them."""
    from raytracer_project_tpu_torch.core.constants import T_MIN
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa
    from raytracer_project_tpu_torch.tools import probe_decode as pd
    from raytracer_project_tpu_torch.tools import probe_onehot as po

    log("probes:")
    _probe_p1(results)
    scene = _showcase(8, 8)[0]
    results["closest_hit"]["split"] = {"showcase": _k1_split(
        "showcase bounce set", main_rays, T_MIN, scene, k1.scan_tables(scene),
        pa.scene_tables(scene))}
    _probe_onehot(results)
    _probe_decode(results)
    _fetch_code()
    results["P2"]["causes"] = {
        "yardstick": _fetch_causes("yardstick", po.onehot_fetch_scalar,
                                   pd.decode_stage_scalar),
        "kernel": _fetch_causes("kernel", po.onehot_fetch, pd.decode_stage,
                                staged=True)}
    _launch_floor(results)


# --- phases 11-16: the scenes past the showcase, the BVH, the bench ---------

def _fused_kernel_names(scene, cfg) -> tuple:
    """The counters of the fused pool's kernels for a render: K3's features
    variant with fog, AOVs or split passes, else its beauty variant; the
    BVH kernel in K1's place from BVH_MIN_PRIMS primitives on."""
    features = (scene.volumes is not None or cfg.use_albedo or cfg.use_normal
                or cfg.use_z_depth or cfg.use_reflection or cfg.use_refraction)
    names = FEATURES_KERNELS if features else FUSED_KERNELS
    if _k1_kernel(scene.primitive_count) == "bvh_hit_kernel":
        names = tuple("bvh_closest_hit" if n == "closest_hit" else n
                      for n in names)
    return names


def phase_scenes_smoke() -> None:
    """The goldens past the showcase (shirley, cornell with fog 0.002, hdri
    with the procedural equirect and DoF; the reference's
    tests/test_goldens.py configs) on the card, each through
    integrator.render on the chunked integrator (K4) and on the fused pool
    (K1-K3), with the counts read around each render, against
    tests/goldens/<name>.npz under the cross-backend budgets."""
    import dataclasses

    import numpy as np
    import torch

    from raytracer_project_tpu_torch import native
    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.tools import goldens

    dev = torch.device("cuda")
    log(f"scenes smoke: BVHs built by {native.version() or 'python'}")
    for name in goldens.NAMES:
        scene, cam, env, cfg = goldens.golden_config(name)
        scene = scene.to(dev)
        for engine in ("chunked", "fused"):
            c = dataclasses.replace(cfg, wavefront=engine == "fused")
            names = (CHUNKED_KERNELS if engine == "chunked"
                     else _fused_kernel_names(scene, c))
            _reset_counters()
            with _PlainCallCounter() as plain:
                img = integrator.render(scene, cam, env, 0, c)["beauty"]
                img = img.cpu().numpy()
            launches = _launches(names)
            check(bool(np.isfinite(img).all()) and img.max() > 0,
                  f"scenes smoke {name} {engine}: not finite or black")
            mean, frac = goldens.golden_diff(img, name)
            log(f"scenes smoke: {name} {engine} {c.width}x{c.height}@"
                f"{c.samples_per_pixel}spp launches {launches}, plain calls "
                f"{plain.calls}; vs CPU golden mean|d| {mean:.5f} frac(>0.05) "
                f"{frac:.4f} (budgets 0.06 / 0.20)")
            check(all(v > 0 for v in launches.values()),
                  f"scenes smoke {name} {engine}: a kernel was not launched")
            check(plain.calls == 0, "a plain version ran during the CUDA render")
            check(mean <= 0.06 and frac <= 0.20,
                  f"scenes smoke {name} {engine}: disagrees with its golden")


def phase_bvh_traverse() -> None:
    """The reference's bvh-traverse gate (utils/smoke.py:420-455):
    bvh_stress_scene(n_spheres=9000), 512 camera rays of the funnel camera
    at 128x72; the port's BVH traversal on the card against its brute-force
    oracle on the card: equal hit sets, t within rtol/atol 2e-4."""
    import torch

    from raytracer_project_tpu_torch import bench, native
    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import intersect, traverse

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    big = presets.bvh_stress_scene(n_spheres=9000)
    build_s = time.perf_counter() - t0
    big = big.to(dev)
    cam = tcam.make_camera(image_width=128, image_height=72,
                           **bench.FUNNEL_CAM).to(dev)
    px = torch.randint(0, 128 * 72, (512,),
                       generator=torch.Generator().manual_seed(7)).to(dev)
    lr = rng.lane_rng(rng.seed_from_int(8), px, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, px, 128)
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hb = traverse.intersect_bvh(big, o, d, 1e-3, stats)
    torch.cuda.synchronize()
    trav_s = time.perf_counter() - t0
    ho = intersect.intersect_brute(big, o, d, 1e-3)
    both = hb.hit & ho.hit
    dt = float((hb.t - ho.t).abs()[both].max()) if bool(both.any()) else 0.0
    log(f"bvh traverse: {big.primitive_count} primitives, builder "
        f"{native.version() or 'python'} ({build_s:.2f} s "
        f"scene build), {big.bvh.node_count} nodes, depth {big.bvh.n_levels}, "
        f"leaf {big.bvh.leaf_size}; {stats['iterations']} steps in "
        f"{trav_s * 1e3:.1f} ms; hits {int(both.sum())}/512, hit flips "
        f"{int((hb.hit != ho.hit).sum())}, max |dt| {dt:.3g}")
    check(bool(torch.equal(hb.hit, ho.hit)), "bvh traverse: hit sets differ")
    check(bool(torch.allclose(hb.t[both], ho.t[both], rtol=2e-4, atol=2e-4)),
          "bvh traverse: t differs")
    check(int(both.sum()) > 0, "bvh traverse: no hits")


def phase_funnel_kernels(results: dict) -> None:
    """K1 and K4 on the funnel (bench.py's BENCH_SCENE=funnel,
    bvh_stress_scene(8192, mesh_detail=2), 25,091 primitives): one scatter
    of the 800x450 funnel camera rays, made on the card by the chunked
    path's own functions; K4 on all 360,000 of them and K1 on the first
    131,072 (the pool's width), each against its plain version, K4 also
    against the brute-force oracle, timed, with the operation bound
    counted as for the showcase; then K1's split by P1 on those lanes."""
    import torch

    from raytracer_project_tpu_torch import bench
    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import intersect, shade

    dev = torch.device("cuda")
    scene = presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2).to(dev)
    cam = tcam.make_camera(image_width=800, image_height=450,
                           **bench.FUNNEL_CAM).to(dev)
    tables = intersect.hit_tables(scene)
    pix = torch.arange(P_CHUNKED, device=dev)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 800)
    first = intersect.intersect(scene, o, d, 1e-3, tables)
    sc = shade.scatter(scene, intersect.make_record(scene, o, d, first), d, lr)
    ro, rd = sc.origin.contiguous(), sc.direction.contiguous()
    left = (first.prim_idx, first.prim_type, first.hit)
    log(f"funnel kernels: {scene.primitive_count} primitives "
        f"{tables.counts}; bounce set from {int(first.hit.sum())} hits")

    feats = intersect.ray_feature_rows(ro, rd).contiguous()
    tk, ik, yk = k1.closest_hit_feats(feats, 1e-3, tables)
    tp, ip, yp = k1.closest_hit_feats_plain(feats, 1e-3, tables.coeffs,
                                            tables.counts)
    torch.cuda.synchronize()
    grazing = near_tangent(scene, ro, rd, tk, ik, yk)
    log(f"  funnel: {int(grazing.sum())} of K4's hits are near-tangent "
        f"sphere hits")
    k4_err = hit_agree("funnel K4 vs plain", tk, ik, yk, tp, ip, yp, left,
                       grazing)
    ob = intersect.intersect_brute(scene, ro, rd, 1e-3)
    hit_agree("funnel K4 vs brute oracle", tk, ik, yk, ob.t, ob.prim_idx,
              ob.prim_type, left, grazing)
    od = torch.cat([ro.T, rd.T])[:, :P_MAIN].contiguous()
    left1 = tuple(x[:P_MAIN] for x in left)
    t1, i1, y1 = k1.closest_hit(od, 1e-3, tables)
    grazing1 = near_tangent(scene, ro[:P_MAIN], rd[:P_MAIN], t1, i1, y1)
    k1_err = hit_agree("funnel K1 vs plain", t1, i1, y1,
                       *k1.closest_hit_plain(od, 1e-3, tables.coeffs,
                                             tables.counts), left1, grazing1)
    hit_agree("funnel K1 vs K4", t1, i1, y1, tk[:P_MAIN], ik[:P_MAIN],
              yk[:P_MAIN], left1, grazing1)

    fine = fine_tables(scene, tables)
    rows = sum(4 * (c.numel() + b.numel())
               for c, b in zip(tables.rows, tables.bounds))
    for key, n, err, fn, plain, rays, t_hit, per_ray in (
            ("closest_hit", P_MAIN, k1_err,
             lambda: k1.closest_hit(od, 1e-3, tables),
             lambda: k1.closest_hit_plain(od, 1e-3, tables.coeffs,
                                          tables.counts), od, t1, 36),
            ("closest_hit_feats", P_CHUNKED, k4_err,
             lambda: k1.closest_hit_feats(feats, 1e-3, tables),
             lambda: k1.closest_hit_feats_plain(feats, 1e-3, tables.coeffs,
                                                tables.counts),
             torch.cat([ro.T, rd.T]).contiguous(), tk, 76)):
        ms = time_ms(f"funnel {key}", fn)
        plain_ms = time_ms(f"funnel {key} plain", plain, n=1, rounds=2)
        flops = k1_operations(rays, t_hit, fine, width=intersect.MM_FINE)
        bound, by = bound_ms(n * per_ray + rows, flops)
        log(f"  funnel {key}: {ms:.4f} ms/launch on {n} bounce lanes, plain "
            f"{plain_ms:.2f} ms, bound {bound:.4f} ms ({by}, "
            f"{flops / n:.0f} operations per ray; structural "
            f"{k1_structural_operations(rays, t_hit, tables) / n:.0f}), "
            f"{ms / bound:.1f}x the bound")
        results[key].update(funnel_lanes=n, funnel_ms=ms,
                            funnel_plain_ms=plain_ms, funnel_bound_ms=bound,
                            funnel_bound_by=by, funnel_max_abs_err=err)
    # K1 split by P1 on the same 131,072 bounce lanes: where the 59-63x
    # over its bound goes (the cull per 128-ray block was the suspect).
    results["closest_hit"].setdefault("split", {})["funnel"] = _k1_split(
        "funnel bounce set", od, 1e-3, scene, tables)


def _bvh_against_k1(name, tb, ib, yb, tk, ik, yk) -> dict:
    """The BVH kernel against K1's tile scan on the same lanes: t bit for
    bit on every lane where both chose the same primitive, hit and winner
    flips within the reference's budgets; the counts logged and returned."""
    import torch

    n = tb.shape[0]
    hb, hk = tb < 1e30, tk < 1e30
    both = hb & hk
    same = both & (ib == ik) & (yb == yk)
    t_bits = int((tb[same].view(torch.int32)
                  != tk[same].view(torch.int32)).sum())
    out = dict(lanes=n, hits=int(both.sum()), same=int(same.sum()),
               hit_flips=int((hb != hk).sum()),
               winner_flips=int((both & ~same).sum()), t_bits_differ=t_bits)
    log(f"  {name}: {out}")
    check(t_bits == 0, f"{name}: {t_bits} same-primitive t differ from K1's")
    check(out["hit_flips"] <= max(2, n // 100), f"{name}: hit flips")
    check(out["winner_flips"] <= max(2, n // 40), f"{name}: winner flips")
    return out


def phase_bvh_kernel(results: dict) -> None:
    """The fused pool's closest hit past BVH_MIN_PRIMS (csrc/bvh_hit.cu,
    closest_hit.bvh_closest_hit) on the funnel's 131,072 bounce lanes (one
    scatter of the 800x450 funnel camera's rays, as phase funnel kernels
    makes them): against K1's tile scan on the same lanes and tables (t bit
    for bit where both chose the same primitive; the counts logged), against
    its plain traversal under the reference's budgets, on the showcase with
    the threshold lowered, on 0 and 1 lanes; timed beside K1 with K1's byte
    bound; the tree's nodes, depth and build ms."""
    import torch

    from raytracer_project_tpu_torch import bench
    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.ops import intersect, shade

    dev = torch.device("cuda")
    env = tenv.make_environment(**ENV_KW).to(dev)
    scene = presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2,
                                     with_bvh=False).to(dev)
    scan = fs.build_tables(scene, env, tenv.PHYSICAL_SUN).scan
    tree = scan.bvh
    check(tree is not None, "bvh kernel: the funnel's tables carry no BVH")
    cam = tcam.make_camera(image_width=800, image_height=450,
                           **bench.FUNNEL_CAM).to(dev)
    pix = torch.arange(P_CHUNKED, device=dev)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 800)
    first = intersect.intersect(scene, o, d, 1e-3, intersect.hit_tables(scene))
    sc = shade.scatter(scene, intersect.make_record(scene, o, d, first), d, lr)
    od = torch.cat([sc.origin.T, sc.direction.T])[:, :P_MAIN].contiguous()
    left = tuple(x[:P_MAIN] for x in (first.prim_idx, first.prim_type,
                                       first.hit))
    log(f"bvh kernel: funnel {scene.primitive_count} primitives, "
        f"{tree.node_count} nodes, depth {tree.depth}, built in "
        f"{tree.build_ms:.1f} ms")
    k1_scan = scan._replace(bvh=None)
    tb, ib, yb = k1.closest_hit(od, 1e-3, scan)
    tk, ik, yk = k1.closest_hit(od, 1e-3, k1_scan)
    torch.cuda.synchronize()
    funnel = _bvh_against_k1("funnel bvh kernel vs K1", tb, ib, yb, tk, ik,
                             yk)
    tp, ip, yp = k1.bvh_closest_hit_plain(od, 1e-3, tree)
    grazing = near_tangent(scene, od[:3].T, od[3:].T, tb, ib, yb)
    err = hit_agree("funnel bvh kernel vs plain traversal", tb, ib, yb, tp,
                    ip, yp, left, grazing)
    for lanes in (0, 1):
        sub = od[:, :lanes].contiguous()
        a, b = k1.closest_hit(sub, 1e-3, scan), k1.closest_hit(sub, 1e-3,
                                                                 k1_scan)
        torch.cuda.synchronize()
        check(all(x.shape == (lanes,) and torch.equal(x, y)
                  for x, y in zip(a, b)), f"bvh kernel: {lanes} lanes")
    log("  bvh kernel: 0 and 1 lanes as K1")

    ms = time_ms("funnel bvh_closest_hit", lambda: k1.closest_hit(
        od, 1e-3, scan))
    k1_ms = time_ms("funnel closest_hit (tile scan)", lambda: k1.closest_hit(
        od, 1e-3, k1_scan))
    plain_ms = time_ms("funnel bvh_closest_hit plain",
                       lambda: k1.bvh_closest_hit_plain(od, 1e-3, tree),
                       n=1, rounds=2)
    rows = sum(4 * r.numel() for r in scan.rows)
    bound, by = bound_ms(P_MAIN * 36 + rows)
    log(f"  funnel bvh_closest_hit: {ms:.4f} ms/launch on {P_MAIN} bounce "
        f"lanes, K1's tile scan {k1_ms:.4f} ms, plain {plain_ms:.2f} ms, "
        f"bound {bound:.4f} ms ({by}), {ms / bound:.1f}x the bound")

    show = presets.showcase_scene(with_bvh=False).to(dev)
    orig = intersect.BVH_MIN_PRIMS
    intersect.BVH_MIN_PRIMS = show.primitive_count
    try:
        sscan = fs.build_tables(show, env, tenv.PHYSICAL_SUN).scan
    finally:
        intersect.BVH_MIN_PRIMS = orig
    cam = tcam.make_camera(image_width=800, image_height=450,
                           **CAM_KW).to(dev)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 800)
    first = intersect.intersect(show, o, d, 1e-3, intersect.hit_tables(show))
    sc = shade.scatter(show, intersect.make_record(show, o, d, first), d, lr)
    sod = torch.cat([sc.origin.T, sc.direction.T])[:, :P_MAIN].contiguous()
    showcase = _bvh_against_k1(
        "showcase bvh kernel vs K1", *k1.closest_hit(sod, 1e-3, sscan),
        *k1.closest_hit(sod, 1e-3, sscan._replace(bvh=None)))
    s_ms = time_ms("showcase bvh_closest_hit", lambda: k1.closest_hit(
        sod, 1e-3, sscan))
    s_k1 = time_ms("showcase closest_hit (tile scan)", lambda: k1.closest_hit(
        sod, 1e-3, sscan._replace(bvh=None)))
    results["bvh_closest_hit"] = dict(
        name="bvh_closest_hit", route="cuda",
        source="raytracer_project_tpu_torch/csrc/bvh_hit.cu", replaces=None,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None, k1_ms=k1_ms, nodes=tree.node_count,
        depth=tree.depth, build_ms=tree.build_ms, funnel=funnel,
        showcase=dict(showcase, ms=s_ms, k1_ms=s_k1,
                      nodes=sscan.bvh.node_count, depth=sscan.bvh.depth))


def _baseline_configs():
    """(label, scene builder, camera kwargs, environment, config) of the
    repository's render configurations at their published sizes
    (BASELINE.json configs 1, 2 and 4) and bench.py's funnel."""
    from raytracer_project_tpu_torch import bench
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.tools import goldens

    off = dict(use_albedo=False, use_normal=False, use_z_depth=False)
    shirley_cam = dict(vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
                       lookat=(0.0, 0.0, 0.0), focus_dist=10.0)
    yield ("config 1: Shirley grid 11, 400x225@16spp, depth 8, solid sky",
           lambda: presets.shirley_final_scene(grid=11),
           dict(shirley_cam, defocus_angle=0.6),
           tenv.make_environment(background_color=(0.7, 0.8, 1.0)),
           integrator.RenderConfig(width=400, height=225, samples_per_pixel=16,
                                   max_depth=8, env_mode=tenv.SOLID_COLOR,
                                   **off))
    yield ("config 2: Cornell box, fog 0.002, 512x512@64spp, depth 8",
           lambda: presets.cornell_box_scene(with_fog=True,
                                             fog_density=0.002),
           dict(vfov=40.0, lookfrom=(278.0, 278.0, -800.0),
                lookat=(278.0, 278.0, 0.0)),
           tenv.make_environment(background_color=(0.0, 0.0, 0.0)),
           integrator.RenderConfig(width=512, height=512, samples_per_pixel=64,
                                   max_depth=8, env_mode=tenv.SOLID_COLOR,
                                   **off))
    yield ("config 4: HDRI, Shirley grid 11, 1920x1080@8spp, depth 6, DoF",
           lambda: presets.shirley_final_scene(grid=11),
           dict(shirley_cam, defocus_angle=2.0),
           tenv.make_environment(hdr_image=goldens.procedural_hdr(),
                                 hdri_rotation=0.7, hdri_tilt=0.2,
                                 hdri_roll=0.1),
           integrator.RenderConfig(width=1920, height=1080, samples_per_pixel=8,
                                   max_depth=6, env_mode=tenv.HDR_MAP, **off))
    yield ("funnel: 8192 spheres + 2 tori, 800x450@32spp, depth 10, sun",
           lambda: presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2),
           bench.FUNNEL_CAM, tenv.make_environment(**ENV_KW),
           integrator.RenderConfig(width=800, height=450, samples_per_pixel=32,
                                   max_depth=10, **off))


def phase_baseline_configs(results: dict) -> None:
    """Each configuration of _baseline_configs on the fused pool: built,
    rendered once to warm up, then timed (wall, segments, steps, sample
    chunks) with the counts read around the timed render, then profiled
    (the closest hit's ms per launch, device busy and idle share). A scene
    of BVH_MIN_PRIMS primitives or more (the funnel) launches the BVH
    kernel for every closest hit and K1's tile scan never, in the counts
    and in the trace, and builds its tables once over the three renders;
    its launches go to the bvh_closest_hit entry."""
    import math

    import numpy as np
    import torch

    from raytracer_project_tpu_torch import native
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.ops import fused_step, integrator

    dev = torch.device("cuda")
    for label, build, cam_kw, env, cfg in _baseline_configs():
        t0 = time.perf_counter()
        scene = build()
        build_s = time.perf_counter() - t0
        scene = scene.to(dev)
        cam = tcam.make_camera(image_width=cfg.width, image_height=cfg.height,
                               **cam_kw)
        chunks = math.ceil(cfg.samples_per_pixel
                           / fused_step.fused_spp_chunk(scene, cfg, env))
        built = fused_step.tables_cache.built
        integrator.render(scene, cam, env, 0, cfg)["beauty"].cpu()  # warm-up
        names = _fused_kernel_names(scene, cfg)
        on_bvh = "bvh_closest_hit" in names
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = integrator.render(scene, cam, env, 1, cfg, with_stats=True)
        img = out["beauty"].cpu().numpy()
        wall = time.perf_counter() - t0
        launches = _launches(names)
        check(all(v > 0 for v in launches.values()),
              f"{label}: a kernel was not launched")
        tile_scans = _launches(("closest_hit",))["closest_hit"]
        check(not on_bvh or tile_scans == 0,
              f"{label}: {tile_scans} tile-scan launches past BVH_MIN_PRIMS")
        if on_bvh:
            results["bvh_closest_hit"]["launches"] = launches[
                "bvh_closest_hit"]
        check(bool(np.isfinite(img).all()) and img.max() > 0,
              f"{label}: image not finite or black")
        log(f"baseline {label}: {scene.primitive_count} primitives (scene "
            f"build {build_s:.2f} s, BVH by {native.version() or 'python'}), "
            f"wall {wall:.3f} s, segments "
            f"{stats['segments']}, steps {stats['steps']}, sample chunks "
            f"{chunks}, segments/s {stats['segments'] / wall:.4g}, launches "
            f"{launches}, mean {img.mean():.4f}")
        prof = _profile(label, (scene, cam, env), cfg, fused=True)
        if on_bvh:
            n_built = fused_step.tables_cache.built - built
            log(f"  {label}: pool tables built {n_built} time(s) over the "
                f"warm-up, timed and profiled renders")
            check(n_built == 1, f"{label}: pool tables built {n_built} times")
        want = _k1_kernel(scene.primitive_count)
        k1 = prof and next((v for k, v in prof["kernels"].items()
                            if want in k), None)
        if k1:
            log(f"  {label}: {want} {k1[0] / k1[1]:.4f} ms per launch "
                f"({k1[1]} launches, {k1[0]:.1f} ms, "
                f"{k1[0] / prof['wall_ms']:.3f} of the profiled wall)")
        else:
            log(f"  {label}: {want} per launch not measured (not in the "
                f"trace)")


def phase_bench() -> None:
    """The port's bench entry point, as a user runs it: `python -m
    raytracer_project_tpu_torch.bench` for the showcase and with
    BENCH_SCENE=funnel; each must print its JSON line without an error."""
    for scene in ("showcase", "funnel"):
        env = dict(os.environ)
        env.pop("BENCH_DEVICE", None)
        if scene == "funnel":
            env["BENCH_SCENE"] = "funnel"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "raytracer_project_tpu_torch.bench"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        log(f"bench {scene}: exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s: {lines[-1] if lines else ''}")
        check(proc.returncode == 0 and len(lines) == 1,
              f"bench {scene} failed: {proc.stderr[-2000:]}")
        row = json.loads(lines[0])
        check("error" not in row and row["value"] > 0,
              f"bench {scene}: no measurement")


def phase_bench_bvh() -> None:
    """tools/bench_bvh's twin: the BVH traversal against K4 on 262,144
    mixed rays over the reference tool's six cases and a funnel of 116,226
    primitives (one JSON row each); the two agree on a hit and its t
    (within 1e-3) on at least 96.5% of the rays (the closest-hit budgets:
    1% hit flips, 2.5% winner flips); the fused pool's BVH kernel and K1's
    tile scan timed on the same rays, their hits within the same budgets
    and t bit for bit where both chose the same primitive."""
    from raytracer_project_tpu_torch.tools import bench_bvh

    log("bench_bvh:")
    for row in bench_bvh.main("cuda"):
        diff = row["k1_vs_bvh_kernel"]
        n = row["rays"]
        log(f"  {row['scene']}: {row['primitives']} primitives, SAH build "
            f"{row['bvh_build_ms']:.1f} ms, {row['bvh_nodes']} nodes, "
            f"traversal {row['bvh_ms']:.2f} ms ({row['bvh_steps']} steps), "
            f"K4 {row['k4_ms']:.2f} ms, agreement {row['hit_agreement']:.4f}; "
            f"K1 {row['k1_ms']:.3f} ms, BVH kernel "
            f"{row['bvh_kernel_ms']:.3f} ms, {diff}")
        check(row["hit_agreement"] >= 0.965,
              f"bench_bvh {row['scene']}: traversal and K4 disagree")
        check(diff["hit_flips"] <= n // 100 and diff["winner_flips"] <= n // 40
              and diff["t_bits_differ"] == 0,
              f"bench_bvh {row['scene']}: BVH kernel and K1 disagree")


# --- phases 17-22: the unfused pool, pixel windows, sort_rays, processes,
# --- the post chain -----------------------------------------------------------

class _NoFused:
    """RAYTRACER_TPU_NO_FUSED=1 while inside: the unfused pool for every
    render (the reference's switch, utils/smoke.py:307-336)."""

    def __enter__(self):
        self.old = os.environ.get("RAYTRACER_TPU_NO_FUSED")
        os.environ["RAYTRACER_TPU_NO_FUSED"] = "1"

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("RAYTRACER_TPU_NO_FUSED")
        else:
            os.environ["RAYTRACER_TPU_NO_FUSED"] = self.old


def _textured_fog_showcase(width, height, device):
    """The fog showcase with its fog's phase material textured by the
    scene's checker (outside the fused step: the unfused pool renders it)."""
    import torch

    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.models import textures

    scene = presets.showcase_scene(use_fog=True, fog_density=0.03)
    vmat = int(scene.volumes.mat[0])
    checker = int(torch.nonzero(scene.textures.kind
                                == textures.KIND_CHECKER)[0, 0])
    tex = torch.as_tensor(scene.materials.texture_id).clone()
    tex[vmat] = checker
    scene = scene._replace(
        materials=scene.materials._replace(texture_id=tex),
        volumes=scene.volumes._replace(textured=torch.tensor([vmat])))
    return (scene.to(device),
            tcam.make_camera(image_width=width, image_height=height, **CAM_KW),
            tenv.make_environment(**ENV_KW))


def phase_pool_smoke(results: dict) -> None:
    """The reference's pool-render stage (utils/smoke.py:307-336): the
    128x72 @ 4 spp showcase through the unfused pool on the card (the
    smoke module's render) against its device and CPU goldens, with its
    run-to-run spread; then the fog showcase with textured fog at 64x36 @
    4 spp on the pool (the route render takes for it) against the port's
    own CPU render under the cross-backend budgets; the counts read around
    each render."""
    import dataclasses

    import torch

    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.utils import smoke

    _reset_counters()
    with _PlainCallCounter() as plain:
        images = smoke.render_pool("cuda")
    launches = _launches(UNFUSED_CHECK)
    log(f"pool smoke: 128x72@4spp unfused pool, launches {launches}, plain "
        f"calls {plain.calls}")
    check(launches["closest_hit"] > 0, "pool smoke: K1 was not launched")
    check(launches["shade_advance"] == launches["shade_advance_features"] == 0,
          "pool smoke: the fused step ran")
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    _smoke_gate_check(images)
    _smoke_spread(smoke.render_pool, images, results)

    cfg = dataclasses.replace(_cfg(64, 36, 4), use_albedo=True)
    scene, cam, env = _textured_fog_showcase(64, 36, torch.device("cuda"))
    _reset_counters()
    with _PlainCallCounter() as plain:
        card, st = integrator.render(scene, cam, env, 2, cfg, with_stats=True)
        card = {k: v.cpu().numpy() for k, v in card.items()}
    launches = _launches(("closest_hit",))
    check(st["engine"] == "pool", "textured fog: not the unfused pool")
    check(launches["closest_hit"] > 0, "textured fog: K1 was not launched")
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    t0 = time.perf_counter()
    cpu = integrator.render(scene.to("cpu"), cam, env, 2, cfg, device="cpu")
    log(f"pool smoke: textured fog 64x36@4spp launches {launches}, segments "
        f"{st['segments']}; CPU render {time.perf_counter() - t0:.1f} s")
    for name in ("beauty", "albedo"):
        _image_agree(f"textured fog {name} card vs CPU", card[name],
                     cpu[name].numpy())


class _KernelEvents:
    """CUDA events around every launch of one C entry (closest_hit_od is
    K1, closest_hit_feats K4) while inside: its device ms per launch in a
    render, without the profiler (2 events per launch)."""

    def __init__(self, entry: str):
        self.entry = entry

    def __enter__(self):
        import torch

        from raytracer_project_tpu_torch import kernels

        self.pairs, self.orig = [], kernels.launch

        def timed(entry, *args):
            if entry != self.entry:
                return self.orig(entry, *args)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            self.orig(entry, *args)
            ev[1].record()
            self.pairs.append(ev)

        kernels.launch = timed
        return self

    def __exit__(self, *exc):
        from raytracer_project_tpu_torch import kernels

        kernels.launch = self.orig

    def ms_per_launch(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / len(self.pairs)


def _pool_render(label, scene, cam, env, cfg, seed=1):
    """One timed unfused-pool render (K1's count read around it, its
    launches timed with CUDA events) and a device-only profile of it;
    (wall s, stats, K1 ms per launch)."""
    import numpy as np
    import torch

    from raytracer_project_tpu_torch.ops import integrator

    with _NoFused():
        _reset_counters()
        torch.cuda.synchronize()
        with _KernelEvents("closest_hit_od") as k1:
            t0 = time.perf_counter()
            out, stats = integrator.render(scene, cam, env, seed, cfg,
                                           with_stats=True)
            img = out["beauty"].cpu().numpy()
            wall = time.perf_counter() - t0
        launches = _launches(UNFUSED_CHECK)
        prof = _profile(label, (scene, cam, env), cfg, host=False)
    check(stats["engine"] == "pool" and launches["closest_hit"] > 0,
          f"{label}: not the unfused pool through K1")
    check(launches["shade_advance"] == launches["shade_advance_features"] == 0,
          f"{label}: the fused step ran")
    check(bool(np.isfinite(img).all()) and img.max() > 0,
          f"{label}: image not finite or black")
    k1_ms = k1.ms_per_launch()
    idle = (max(0.0, 1.0 - prof["busy_ms"] / prof["wall_ms"]) if prof
            else None)
    log(f"pool full {label}: wall {wall:.3f} s, segments {stats['segments']}, "
        f"steps {stats['steps']}, segments/s {stats['segments'] / wall:.4g}, "
        f"K1 launches {launches['closest_hit']}, K1 {k1_ms:.4f} ms per launch "
        f"(events), idle share "
        f"{'not measured' if idle is None else f'{idle:.3f}'} (profile), "
        f"mean {img.mean():.4f}")
    return wall, stats, k1_ms


def phase_pool_full(results: dict) -> None:
    """The unfused pool at full size, beauty, depth 10, 800x450 @ 32 spp
    (262,144 lanes): the showcase and the funnel, each with sort_lanes off
    and on (the lanes re-sorted by direction octant and origin cell after
    every step), each timed and profiled after a small warm-up: K1's ms
    per launch both ways."""
    import dataclasses

    import torch

    from raytracer_project_tpu_torch import bench
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import integrator

    dev = torch.device("cuda")
    cfg = _cfg(800, 450, 32)
    cases = (("showcase", _showcase(800, 450), ""),
             ("funnel", (presets.bvh_stress_scene(n_spheres=8192,
                                                  mesh_detail=2).to(dev),
                         tcam.make_camera(image_width=800, image_height=450,
                                          **bench.FUNNEL_CAM),
                         tenv.make_environment(**ENV_KW)), "funnel_"))
    with _NoFused():
        integrator.render(*_showcase(64, 36), 0, _cfg(64, 36, 1))  # warm-up
    for name, inputs, key in cases:
        segs = {}
        for sort in (False, True):
            label = f"{name} sort_lanes={sort}"
            wall, stats, k1_ms = _pool_render(
                label, *inputs, dataclasses.replace(cfg, sort_lanes=sort))
            segs[sort] = stats["segments"]
            tag = "sorted_" if sort else ""
            results["closest_hit"][f"{key}pool_{tag}ms"] = k1_ms
            results["closest_hit"][f"{key}pool_{tag}wall_s"] = wall
        check(segs[False] == segs[True],
              f"pool full {name}: sort_lanes changed the segments")


def _window_state(n_local, poff, cam, tables, aparams, bparams, sp):
    """The bounce state of a pool window: camera rays of the 131,072 first
    work items of the window [poff, poff + n_local) (global pixel ids),
    one plain step later."""
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs

    dev = torch.device("cuda")
    w = torch.arange(P_MAIN, device=dev)
    li = (poff + w % n_local).to(torch.int32)
    samp = (w // n_local).to(torch.int32)
    o, d = tcam.generate_rays_soa(cam.to(dev), rng.LaneRng(
        sp.seed, rng.u32(li), rng.u32(samp), 0), li, 800)
    ones = torch.ones(P_MAIN, device=dev)
    state_f = torch.stack([*o, *d, ones, ones, ones, 0 * ones, 0 * ones,
                           0 * ones]).contiguous()
    state_i = torch.stack([torch.ones_like(li), torch.zeros_like(li), samp,
                           li]).contiguous()
    next_work = torch.tensor([P_MAIN], dtype=torch.int32, device=dev)
    segments = torch.zeros(1, dtype=torch.int64, device=dev)
    rec0 = fs.decode_plain(tables, state_f[:6], *k1.closest_hit_plain(
        state_f[:6], 1e-3, tables.scan.coeffs, tables.scan.counts), aparams)
    step1 = fs.shade_advance_plain(tables, rec0, state_f, state_i, next_work,
                                   segments, bparams, sp)
    return step1[0].contiguous(), step1[1].contiguous(), step1[4], step1[5]


def _sums_agree(name, got, ref, rtol=3e-4, atol=3e-4) -> None:
    """Sums equal up to float reassociation (the card's scatter-adds run in
    no fixed order): rtol/atol 3e-4, as tests/test_fused_step.py allows."""
    import torch

    for f, a, b in zip(got._fields, got, ref):
        a, b = a.to(b.device), b
        ok = torch.isclose(a, b, rtol=rtol, atol=atol)
        err = float((a - b).abs().max()) if a.numel() else 0.0
        check(bool(ok.all()), f"{name} {f}: {int((~ok).sum())} values differ "
              f"(max |d| {err:.3g})")
    log(f"  {name}: every buffer within rtol/atol {rtol:g}")


def phase_windows(results: dict) -> None:
    """Pixel windows on the card: K3 fused with pixel_offset != 0 against
    its plain version at 131,072 lanes (timed); render_sharded over 4 windows
    of cuda:0 on the fused pool, on a frame of 801x451 pixels (not a
    multiple of 4); sharded_accumulate with explicit pixel ids on the
    unfused pool and the chunked path. Each against the one-window render:
    segments exactly (plus the padding's), sums within rtol/atol 3e-4."""
    import dataclasses

    import numpy as np
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.parallel import render as prender

    dev = torch.device("cuda")
    scene, cam, env = _showcase(800, 450)
    tables = fs.build_tables(scene, env, tenv.PHYSICAL_SUN)
    aparams = fs._aparams(env, dev)
    bparams = fs._bparams(cam, env, dev)
    n_local, poff = 800 * 450 // 4, 2 * 800 * 450 // 4
    sp = fs.StepParams(seed=rng.seed_from_int(0), sample_offset=0,
                       n_pixels=n_local, width=800, total_work=n_local * 32,
                       max_depth=10, env_mode=tenv.PHYSICAL_SUN,
                       pixel_offset=poff)
    state = _window_state(n_local, poff, cam, tables, aparams, bparams, sp)
    hits = k1.closest_hit(state[0][:6].contiguous(), 1e-3, tables.scan)
    # 131,072 lanes over 90,000 pixels: two lanes of a pixel may finish in
    # one step, summed in either order (rtol/atol 3e-4).
    err = fused_against_plain("K3 fused window", tables, hits, state,
                              aparams, bparams, sp, 3e-4)
    acc = fs.new_accumulator(sp, dev)
    steps = torch.zeros(1, dtype=torch.int64, device=dev)
    out = fs.shade_accumulate(tables, hits, *state, steps, aparams, bparams,
                              sp, acc)
    check(bool(((out[1][3] >= poff) & (out[1][3] < poff + n_local)).all()),
          "K3 window: a respawned lane left the window")
    _, tgt, adds = _step_adds(tables, hits, state, aparams, bparams, sp)
    fin = tgt[0] < n_local
    check(bool(((tgt[0][fin] + poff) == state[1][3][fin]).all()),
          "K3 window: a target is not its lane's slot")
    fused = lambda: fs.shade_accumulate(tables, hits, *state, steps, aparams,
                                        bparams, sp, acc)
    old = _old_step(tables, hits, state, aparams, bparams, sp,
                    fs.new_accumulator(sp, dev))
    t_win, t_old = time_ms("K3 fused window", fused), time_ms(
        "K2 + K3 window + index_add_", old)
    t_winp = time_ms("K3 fused window plain", lambda: fs.shade_accumulate_plain(
        tables, hits, *state, steps, aparams, bparams, sp, acc), rounds=3)
    results["shade_advance"].update(window_ms=t_win, window_plain_ms=t_winp,
                                    window_max_abs_err=err,
                                    window_yardstick_ms=t_old)
    log(f"windows: K3 fused window (offset {poff}, {n_local} pixels) "
        f"{t_win:.4f} ms/launch (K2 + K3 + index_add_ {t_old:.4f} ms), plain "
        f"{t_winp:.4f} ms, {int(fin.sum())} finishing lanes, {adds} adds")

    # Four windows of cuda:0 on the fused pool: 801x451 = 361,251 pixels.
    w, h, spp = 801, 451, 8
    cfg = _cfg(w, h, spp)
    cam_w = tcam.make_camera(image_width=w, image_height=h, **CAM_KW)
    full, fst = integrator.accumulate_samples(scene, cam_w, env, 3, cfg,
                                              with_stats=True)
    mesh = prender.make_mesh(4, device="cuda:0")
    ids = prender._padded_pixel_ids(cfg.n_pixels, 4)
    pad = ids.shape[0] - cfg.n_pixels
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, st = prender.sharded_accumulate(scene, cam_w, env, 3, cfg, ids, 0,
                                         mesh=mesh, with_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(FUSED_KERNELS)
    check(all(v > 0 for v in launches.values()),
          "windows: a kernel was not launched")
    phantom = integrator.accumulate_samples(
        scene, cam_w, env, 3, cfg, pixel_offset=cfg.n_pixels,
        n_pixels_local=pad, with_stats=True)[1]["segments"]
    log(f"windows: 4 fused windows of {ids.shape[0] // 4} pixels ({pad} "
        f"padding) in threads, wall {wall:.4f} s, launches {launches}, "
        f"segments {st['segments']} = "
        f"{fst['segments']} + {phantom} (padding), steps {st['steps']} "
        f"(one window {fst['steps']})")
    check(st["segments"] == fst["segments"] + phantom,
          "windows: the fused windows' segments differ")
    _sums_agree("4 fused windows vs the frame",
                integrator.SampleBuffers(*(x[:cfg.n_pixels] for x in acc)), full)
    _fused_trace("4 fused windows", _profile_fn(
        "4 fused windows", lambda: prender.sharded_accumulate(
            scene, cam_w, env, 3, cfg, ids, 0, mesh=mesh).beauty.cpu()),
        scene.primitive_count)
    img = prender.render_sharded(scene, cam_w, env, 3, cfg, mesh)["beauty"]
    check(bool(torch.isfinite(img).all()), "render_sharded: not finite")

    # Explicit pixel ids (every third pixel, shuffled) over 4 windows: the
    # unfused pool and the chunked path.
    w, h, spp = 200, 113, 4
    cam_s = tcam.make_camera(image_width=w, image_height=h, **CAM_KW)
    n = w * h
    ids = np.random.default_rng(5).permutation(np.arange(0, n, 3))[:7000]
    for engine, kw in (("pool", {}), ("chunked", dict(wavefront=False))):
        cfg = dataclasses.replace(_cfg(w, h, spp), **kw)
        names = ("closest_hit",) if engine == "pool" else CHUNKED_KERNELS
        # The frame on the same engine (the fused pool's K2 rounds the
        # records otherwise than the unfused pool).
        with _NoFused():
            whole, wst = integrator.accumulate_samples(scene, cam_s, env, 4,
                                                       cfg, with_stats=True)
        _reset_counters()
        acc, st = prender.sharded_accumulate(scene, cam_s, env, 4, cfg, ids, 0,
                                             mesh=mesh, with_stats=True)
        launches = _launches(names)
        one, ost = integrator.accumulate_samples(
            scene, cam_s, env, 4, cfg, torch.as_tensor(ids, device=dev),
            with_stats=True)
        log(f"windows: explicit ids on the {engine} path ({len(ids)} of {n} "
            f"pixels over 4 windows), launches {launches}, segments "
            f"{st['segments']} (one call {ost['segments']})")
        check(all(v > 0 for v in launches.values()),
              f"windows {engine}: a kernel was not launched")
        check(st["segments"] == ost["segments"],
              f"windows {engine}: segments differ")
        _sums_agree(f"{engine} pixel ids vs one call", acc, one)
        sel = torch.as_tensor(ids, device=dev)
        _sums_agree(f"{engine} pixel ids vs the frame", acc,
                    integrator.SampleBuffers(*(x[sel] for x in whole)))
        check(wst["segments"] > 0, "windows: empty frame")


class _WindowWalls:
    """Records the wall of every integrator.accumulate_samples call, from
    whichever thread makes it, while active. A fused call ends in a read of
    its segment count, so its wall covers its work on the card."""

    def __enter__(self):
        from raytracer_project_tpu_torch.ops import integrator

        self.walls = []
        self.orig = integrator.accumulate_samples

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = self.orig(*args, **kw)
            self.walls.append(time.perf_counter() - t0)
            return out

        integrator.accumulate_samples = timed
        return self

    def __exit__(self, *exc):
        from raytracer_project_tpu_torch.ops import integrator

        integrator.accumulate_samples = self.orig


def _multicard_frame():
    """The showcase main path's frame split into 4 windows: 800x450 @ 32
    spp, depth 10, beauty, PHYSICAL_SUN (90,000 pixels a window)."""
    scene, cam, env = _showcase(800, 450)
    return scene, cam, env, _cfg(800, 450, 32)


def _timed(label: str, fn):
    """(result, wall s, {kernel: launches}) of fn(), synchronised."""
    import torch

    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(FUSED_KERNELS)
    check(all(v > 0 for v in launches.values()),
          f"multicard {label}: a kernel was not launched")
    return out, wall, launches


def _multicard_threaded(results: dict, frame, one) -> None:
    """(a) 4 windows of cuda:0, one thread each, against the same windows
    rendered one after another and the one-device render; walls in turns
    (threaded, serial, serial, threaded), the threads' overlap."""
    import torch

    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.parallel import render as prender

    scene, cam, env, cfg = frame
    mesh = [torch.device("cuda", 0)] * 4
    ids = prender._padded_pixel_ids(cfg.n_pixels, 4)
    n_local = ids.shape[0] // 4

    def threaded():
        with _WindowWalls() as ww:
            out = prender.sharded_accumulate(scene, cam, env, 0, cfg, ids, 0,
                                             mesh=mesh, with_stats=True)
        return out, ww.walls

    def serial():
        parts, segments = [], 0
        for i in range(4):
            buf, st = integrator.accumulate_samples(
                scene, cam, env, 0, cfg, with_stats=True,
                pixel_offset=i * n_local, n_pixels_local=n_local)
            parts.append(buf)
            segments += st["segments"]
        return integrator.SampleBuffers(*(torch.cat(x) for x in zip(*parts))), \
            segments

    walls = {"threaded": [], "serial": []}
    for kind in ("threaded", "serial", "serial", "threaded"):
        if kind == "threaded":
            ((acc, st), window_walls), wall, launches = _timed(kind, threaded)
            overlap = sum(window_walls) / wall
            log(f"multicard (a): threaded 4 x cuda:0 wall {wall:.4f} s, "
                f"windows " + ", ".join(f"{w:.4f}" for w in window_walls)
                + f" s, overlap {overlap:.3f} (sum of window walls / wall), "
                f"launches {launches}, segments {st['segments']}, steps "
                f"{st['steps']}")
            walls[kind].append((wall, overlap))
            got, got_segments = acc, st["segments"]
            results["closest_hit"]["multicard_launches"] = launches[
                "closest_hit"]
        else:
            (ser, segments), wall, launches = _timed(kind, serial)
            log(f"multicard (a): serial 4 windows wall {wall:.4f} s, launches "
                f"{launches}, segments {segments}")
            walls[kind].append((wall, 1.0))
    check(got_segments == segments == one[1]["segments"],
          f"multicard (a): segments {got_segments} threaded, {segments} "
          f"serial, {one[1]['segments']} one device")
    _sums_agree("multicard (a) threaded vs serial windows", got, ser)
    _sums_agree("multicard (a) threaded vs one device", got, one[0])
    t, s = [w for w, _ in walls["threaded"]], [w for w, _ in walls["serial"]]
    log(f"multicard (a): threaded {min(t):.4f}-{max(t):.4f} s, serial "
        f"{min(s):.4f}-{max(s):.4f} s, one device {one[2]:.4f} s; overlap "
        + ", ".join(f"{o:.3f}" for _, o in walls["threaded"]))


def _multicard_nccl(frame, one) -> None:
    """(b) A process group of one rank on NCCL: render_distributed over 4
    windows of cuda:0 (make_global_mesh, the windows gathered and averaged
    on the card, one copy to the host) and the group's statistics reduced
    on the card, against the one-process render."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from raytracer_project_tpu_torch.ops import integrator, post
    from raytracer_project_tpu_torch.parallel import distributed

    scene, cam, env, cfg = frame
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    init = os.path.join(out_dir, "nccl_init")
    if os.path.exists(init):
        os.remove(init)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{init}",
                            world_size=1, rank=0)
    try:
        check(dist.get_backend() == "nccl", "multicard (b): not NCCL")
        setup = time.perf_counter() - t0
        img, wall, launches = _timed("nccl", lambda: distributed.render_distributed(
            scene, cam, env, 0, cfg, device="cuda:0", per_process=4))
        want = integrator.finalize_buffers(one[0], cfg)
        stats = post.analyze_framebuffer_psum(want["beauty"].reshape(-1, 3))
    finally:
        dist.destroy_process_group()
    ref = want["beauty"].cpu().numpy()
    ok = np.isclose(img["beauty"], ref, rtol=3e-4, atol=3e-4)
    log(f"multicard (b): one NCCL rank, 4 windows of cuda:0: group set up in "
        f"{setup:.2f} s, render_distributed wall {wall:.4f} s, launches "
        f"{launches}; {int((~ok).sum())} values off the one-process render "
        f"(max |d| {float(np.abs(img['beauty'] - ref).max()):.3g})")
    check(bool(ok.all()) and bool(np.isfinite(img["beauty"]).all()),
          "multicard (b): the NCCL frame differs from the one-process render")
    whole = post.analyze_framebuffer(want["beauty"])
    check(stats.histogram.device.type == "cuda"
          and torch.equal(stats.histogram, whole.histogram)
          and bool(torch.isclose(stats.average_luminance,
                                 whole.average_luminance, rtol=1e-5)),
          "multicard (b): the statistics reduced over NCCL differ")
    log("  multicard (b): statistics reduced on the card equal the frame's")


def _nccl_rank_worker(rank: int, world: int, per_process: int, init: str,
                      out: str) -> None:
    """One rank of multicard (d): per_process cards from LOCAL_RANK *
    per_process, an NCCL group by default, its windows of the frame (a
    warm-up render, then a timed one); rank 0 writes the beauty and the
    wall."""
    import numpy as np
    import torch

    from raytracer_project_tpu_torch.parallel import distributed

    os.environ["LOCAL_RANK"] = str(rank)
    check(distributed.init_distributed(num_processes=world, process_id=rank,
                                       init_method=init), "no process group")
    try:
        import torch.distributed as dist

        check(dist.get_backend() == "nccl", "multicard (d): not NCCL")
        scene, cam, env, cfg = _multicard_frame()
        distributed.render_distributed(scene, cam, env, 0, cfg,
                                       per_process=per_process)
        t0 = time.perf_counter()
        img = distributed.render_distributed(scene, cam, env, 0, cfg,
                                             per_process=per_process)
        wall = time.perf_counter() - t0
        if distributed.is_host0():
            np.savez(out, beauty=img["beauty"], wall=wall,
                     cards=torch.cuda.device_count())
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _nccl_ranks(world: int, per_process: int, ref) -> None:
    """multicard (d): `world` spawned NCCL ranks of per_process cards each,
    their frame against the one-device render `ref` (host beauty)."""
    import numpy as np
    import torch.multiprocessing as mp

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    init = os.path.join(out_dir, f"nccl_{world}x{per_process}_init")
    if os.path.exists(init):
        os.remove(init)
    out = os.path.join(out_dir, f"nccl_{world}x{per_process}.npz")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_nccl_rank_worker,
                             args=(world, per_process, f"file://{init}", out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + 300
    while not ctx.join(timeout=1):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("multicard (d): the NCCL ranks did not finish")
    with np.load(out) as got:
        beauty, wall = got["beauty"], float(got["wall"])
    ok = np.isclose(beauty, ref, rtol=3e-4, atol=3e-4)
    log(f"multicard (d): {world} NCCL ranks x {per_process} card(s) in "
        f"{time.perf_counter() - t0:.1f} s, render_distributed wall "
        f"{wall:.4f} s; {int((~ok).sum())} values off the one-device render "
        f"(max |d| {float(np.abs(beauty - ref).max()):.3g})")
    check(bool(ok.all()), f"multicard (d): the {world}-rank NCCL frame differs")


def _multicard_distinct(frame, one) -> None:
    """(d) Where the machine has two cards or more: a mesh of every card
    (one thread each) against the one-device render; a spawned NCCL rank
    per card; with four cards or more, ranks of two cards each."""
    import torch

    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.parallel import render as prender

    count = torch.cuda.device_count()
    if count < 2:
        log(f"multicard (d): not run: this machine has {count} card (distinct "
            "cards and two NCCL ranks need two); unverified here")
        return
    scene, cam, env, cfg = frame
    mesh = prender.make_mesh()
    ids = prender._padded_pixel_ids(cfg.n_pixels, len(mesh))
    for _ in range(2):
        (acc, st), wall, launches = _timed(
            "distinct", lambda: prender.sharded_accumulate(
                scene, cam, env, 0, cfg, ids, 0, mesh=mesh, with_stats=True))
        log(f"multicard (d): {len(mesh)} distinct cards wall {wall:.4f} s "
            f"(one device {one[2]:.4f} s), launches {launches}, segments "
            f"{st['segments']}")
    pad = ids.shape[0] - cfg.n_pixels
    phantom = integrator.accumulate_samples(
        scene, cam, env, 0, cfg, pixel_offset=cfg.n_pixels,
        n_pixels_local=pad, with_stats=True)[1]["segments"] if pad else 0
    check(st["segments"] == one[1]["segments"] + phantom,
          "multicard (d): the distinct cards' segments differ")
    _sums_agree("multicard (d) distinct cards vs one device",
                integrator.SampleBuffers(*(x[:cfg.n_pixels] for x in acc)),
                one[0])
    ref = integrator.finalize_buffers(one[0], cfg)["beauty"].cpu().numpy()
    _nccl_ranks(count, 1, ref)
    if count >= 4 and count % 2 == 0:
        _nccl_ranks(count // 2, 2, ref)


def phase_multicard(results: dict) -> None:
    """The frame over several devices at once (parallel/render.py's window
    threads, parallel/distributed.py on NCCL), at the main path's size:
    (a) 4 windows of cuda:0 in threads against the same windows in turn
    and the one-device render, walls and overlap; (b) a one-rank NCCL
    group through render_distributed; (d) every card, an NCCL rank per
    card and ranks of two cards, where the machine has two cards or more.
    Each against the one-device render: equal segments, sums within
    rtol/atol 3e-4."""
    import torch

    from raytracer_project_tpu_torch.ops import integrator

    frame = _multicard_frame()
    scene, cam, env, cfg = frame
    integrator.accumulate_samples(scene, cam, env, 0, cfg)   # warm-up
    (acc, st), wall, launches = _timed("one device", lambda: (
        integrator.accumulate_samples(scene, cam, env, 0, cfg,
                                      with_stats=True)))
    log(f"multicard: one device wall {wall:.4f} s, launches {launches}, "
        f"segments {st['segments']}, {torch.cuda.device_count()} card(s)")
    one = (acc, st, wall)
    _multicard_threaded(results, frame, one)
    _multicard_nccl(frame, one)
    _multicard_distinct(frame, one)


def phase_sort_rays(results: dict) -> None:
    """K4 on the chunked path's 360,000 bounce lanes (phase_k4's set) with
    sort_rays off and on: equal hits lane for lane through intersect, and
    K4 timed on the rays in their order and in the sorted order, the sort
    and un-sort timed beside."""
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import intersect, shade

    dev = torch.device("cuda")
    scene = _showcase(800, 450)[0]
    cam = tcam.make_camera(image_width=800, image_height=450, **CAM_KW).to(dev)
    tables = intersect.hit_tables(scene)
    pix = torch.arange(P_CHUNKED, device=dev)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 800)
    first = intersect.intersect(scene, o, d, 1e-3, tables)
    sc = shade.scatter(scene, intersect.make_record(scene, o, d, first), d, lr)
    ro, rd = sc.origin.contiguous(), sc.direction.contiguous()
    _reset_counters()
    plain = intersect.intersect(scene, ro, rd, 1e-3, tables)
    srt = intersect.intersect(scene, ro, rd, 1e-3, tables, sort_rays=True)
    torch.cuda.synchronize()
    check(k1.closest_hit_feats.launches == 2, "sort rays: K4 launches")
    for f, a, b in zip(plain._fields, plain, srt):
        check(bool(torch.equal(a, b)), f"sort rays: {f} differs")
    order, dest = intersect.sort_order(scene, ro, rd)
    feats = intersect.ray_feature_rows(ro, rd).contiguous()
    feats_s = intersect.ray_feature_rows(ro[order], rd[order]).contiguous()
    k4 = lambda f: (lambda: k1.closest_hit_feats(f, 1e-3, tables))
    t_u, t_s = time_ms("K4 unsorted", k4(feats)), time_ms("K4 sorted", k4(feats_s))
    t_s = (t_s + time_ms("K4 sorted", k4(feats_s))) / 2
    t_u = (t_u + time_ms("K4 unsorted", k4(feats))) / 2
    t_sort = time_ms("sort_order", lambda: intersect.sort_order(scene, ro, rd),
                     rounds=3)
    t_all = time_ms("intersect sort_rays=True", lambda: intersect.intersect(
        scene, ro, rd, 1e-3, tables, sort_rays=True), rounds=3)
    groups = int(torch.unique(intersect._sort_key(
        ro, rd, torch.cat([k1.coarsen_bounds(b) for b in (
            scene.mm.sphere_bounds, scene.mm.tri_bounds,
            scene.mm.box_bounds)]))[0]).numel())
    results["closest_hit_feats"].update(unsorted_ms=t_u, sorted_ms=t_s,
                                        sort_order_ms=t_sort,
                                        sort_rays_ms=t_all)
    log(f"sort rays: {P_CHUNKED} bounce lanes, equal hits ({int(plain.hit.sum())}"
        f" hits), {groups} chunk keys; K4 {t_u:.4f} ms unsorted, {t_s:.4f} ms "
        f"sorted; sort_order {t_sort:.4f} ms; intersect with sort_rays "
        f"{t_all:.4f} ms")


def _two_process_worker(rank: int, world: int, init: str, out: str) -> None:
    """One rank of phase_two_process: its window of the 256x144 @ 8 spp
    showcase on cuda:0, gathered to every rank; rank 0 writes the frame."""
    import numpy as np

    from raytracer_project_tpu_torch.parallel import distributed

    check(distributed.init_distributed(num_processes=world, process_id=rank,
                                       init_method=init, backend="gloo"),
          "no process group")
    try:
        scene, cam, env = _showcase(256, 144)
        img = distributed.render_distributed(scene, cam, env, 6,
                                             _cfg(256, 144, 8), device="cuda:0")
        if distributed.is_host0():
            np.save(out, img["beauty"])
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def phase_two_process():
    """torch.multiprocessing spawns 2 ranks; each joins a gloo group
    (init_distributed with backend="gloo": NCCL refuses two ranks on one
    card), renders its window of the 256x144 @ 8 spp showcase
    on cuda:0 and gathers to rank 0, which writes the frame; it equals the
    one-process render within rtol/atol 3e-4. A rank that fails fails the
    phase. Returns the one-process beauty (f32 [144, 256, 3], host)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from raytracer_project_tpu_torch.ops import integrator

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    init = os.path.join(out_dir, "two_process_init")
    if os.path.exists(init):
        os.remove(init)
    out = os.path.join(out_dir, "two_process_beauty.npy")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_two_process_worker,
                             args=(2, f"file://{init}", out), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + 300
    while not ctx.join(timeout=1):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("two process: the ranks did not finish")
    got = np.load(out)
    scene, cam, env = _showcase(256, 144)
    one = integrator.render(scene, cam, env, 6, _cfg(256, 144, 8))["beauty"]
    one = one.cpu().numpy()
    ok = np.isclose(got, one, rtol=3e-4, atol=3e-4)
    log(f"two process: 2 ranks in {time.perf_counter() - t0:.1f} s; frame "
        f"{got.shape}, {int((~ok).sum())} values off the one-process render "
        f"(max |d| {float(np.abs(got - one).max()):.3g})")
    check(bool(ok.all()) and bool(np.isfinite(got).all()),
          "two process: the frame differs from the one-process render")
    return torch.as_tensor(one)


def phase_post(beauty) -> None:
    """The post chain on the showcase beauty: update_post_processing with
    bloom and sharpening on the card and on the CPU (within 1e-5), the
    statistics of 4 windows on the card (analyze_sharded) against the
    whole image's, and the exported PNG written under build/ by save_png
    (PIL where it is installed), the native writer and the pure-Python one,
    each read back pixel for pixel."""
    import numpy as np
    import torch

    from raytracer_project_tpu_torch import native
    from raytracer_project_tpu_torch.core import colorspace
    from raytracer_project_tpu_torch.ops import post
    from raytracer_project_tpu_torch.parallel import render as prender
    from raytracer_project_tpu_torch.utils import image_io

    cfg = post.PostConfig(use_bloom=True, use_sharpening=True)
    params = post.make_post_params(exposure=0.3)
    card = post.update_post_processing(beauty.cuda(), params.to("cuda"), cfg)
    cpu = post.update_post_processing(beauty.cpu(), params, cfg)
    d = float((card.cpu() - cpu).abs().max())
    log(f"post: update_post_processing {tuple(beauty.shape)} card vs CPU max "
        f"|d| {d:.3g}")
    check(d <= 1e-5, "post: card and CPU disagree")
    flat = beauty.cuda().reshape(-1, 3)
    whole = post.analyze_framebuffer(flat)
    parts = prender.analyze_sharded(flat, prender.make_mesh(4, device="cuda:0"))
    log(f"post: statistics avg {float(whole.average_luminance):.5f} / "
        f"{float(parts.average_luminance):.5f}, max "
        f"{float(whole.max_luminance):.4f} / {float(parts.max_luminance):.4f}")
    check(bool(torch.equal(whole.histogram, parts.histogram))
          and float(whole.max_luminance) == float(parts.max_luminance)
          and abs(float(whole.average_luminance)
                  - float(parts.average_luminance))
          <= 1e-5 * float(whole.average_luminance),
          "post: the windows' statistics differ from the image's")
    px = colorspace.to_srgb_u8(card).cpu().numpy()
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    for writer, write in (("save_png", image_io.save_png),
                          ("native", native.write_png),
                          ("pure", image_io._save_png_pure)):
        path = os.path.join(out_dir, f"showcase_post_{writer}.png")
        if write(path, px) is False:
            raise AssertionError(f"post: the {writer} writer failed")
        back = image_io.read_png(path)
        log(f"post: {writer} wrote {os.path.getsize(path)} bytes, read back "
            f"{'equal' if np.array_equal(back, px) else 'DIFFERENT'}")
        check(np.array_equal(back, px), f"post: the {writer} PNG differs")


# --- phases 23 and 24: the differentiable mode and the denoisers --------------

def _sun_vector(elevation: float, azimuth: float = DIFF_SUN_AZIMUTH,
                length: float = DIFF_SUN_LENGTH):
    """The sun direction at `elevation` and `azimuth` degrees (azimuth from
    +x toward +z), stored at `length`."""
    import numpy as np

    e, a = np.deg2rad(elevation), np.deg2rad(azimuth)
    return (float(length * np.cos(e) * np.cos(a)), float(length * np.sin(e)),
            float(length * np.cos(e) * np.sin(a)))


def _sun_angles(v, truth):
    """(angle between v and truth, v's elevation), in degrees."""
    import numpy as np

    u, w = np.asarray(v, np.float64), np.asarray(truth, np.float64)
    u, w = u / np.linalg.norm(u), w / np.linalg.norm(w)
    return (float(np.rad2deg(np.arccos(np.clip(u @ w, -1.0, 1.0)))),
            float(np.rad2deg(np.arcsin(u[1]))))


@contextlib.contextmanager
def _recorded_searches():
    """While inside, every closest-hit search (ops/intersect.py
    `intersect`, which intersect_detached calls) appends its Hit, copied to
    the CPU, to the list this yields."""
    from raytracer_project_tpu_torch.ops import intersect as isect

    search, records = isect.intersect, []

    def recorded(*args, **kw):
        hit = search(*args, **kw)
        records.append(isect.Hit(*(x.detach().cpu() for x in hit)))
        return hit

    isect.intersect = recorded
    try:
        yield records
    finally:
        isect.intersect = search


def _free_render(state, cfg, paths, seed, device):
    """A differentiable render on `device` with its searches recorded:
    (image, {path: leaf}, the searches' Hits)."""
    from raytracer_project_tpu_torch import diff

    state = state.to(device)
    params = {p: diff.tree_get(state, p).detach().clone().requires_grad_(True)
              for p in paths}
    with _recorded_searches() as hits:
        img = diff.render_beauty(diff.apply_params(state, params), seed, cfg,
                                 device=device)
    return img, params, hits


def _grads(loss, params):
    """(loss, {path: gradient as numpy}); a leaf no part of the loss reaches
    has zeros."""
    import numpy as np
    import torch

    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                             retain_graph=True)
    return float(loss.detach()), {
        p: (np.zeros(tuple(v.shape), np.float32) if g is None
            else g.cpu().numpy()) for (p, v), g in zip(params.items(), gs)}


def _diff_cell(dev):
    """The differentiable cell: the showcase (seed 3) at DIFF_SIZE, depth 8,
    beauty, PHYSICAL_SUN with the sun at DIFF_SUN_ELEVATION; the true state,
    the config, the start state (FIT_MATERIAL's albedo blended 40% toward
    (0.2, 0.8, 0.5), the sun FIT_SUN_DROP degrees lower), and that
    material's row."""
    import numpy as np
    import torch

    from raytracer_project_tpu_torch import diff
    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.models.scene import SceneBuilder
    from raytracer_project_tpu_torch.ops import integrator, intersect

    w, h, spp = DIFF_SIZE
    scene = presets.showcase_scene().to(dev)
    cam = tcam.make_camera(image_width=w, image_height=h, **CAM_KW).to(dev)
    truth = _sun_vector(DIFF_SUN_ELEVATION)
    env = tenv.make_environment(sun_direction=truth, sun_intensity=6.0).to(dev)
    cfg = integrator.RenderConfig(
        width=w, height=h, samples_per_pixel=spp, max_depth=8,
        env_mode=tenv.PHYSICAL_SUN, use_albedo=False, use_normal=False,
        use_z_depth=False, differentiable=True)
    state = diff.RenderState(scene, cam, env)
    # The showcase registers the reference's materials first, in this order.
    b = SceneBuilder()
    presets.load_reference_materials(b, np.random.default_rng(3))
    row = b.materials.get(FIT_MATERIAL)
    pix = torch.arange(w * h, device=dev)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, w)
    hit = intersect.intersect(scene, o, d, 1e-3, intersect.hit_tables(scene))
    seen = int((intersect.make_record(scene, o, d, hit).mat[hit.hit]
                == row).sum())
    m = scene.materials
    albedo = m.albedo.clone()
    albedo[row] = 0.6 * albedo[row] + 0.4 * albedo.new_tensor((0.2, 0.8, 0.5))
    sun = _sun_vector(DIFF_SUN_ELEVATION - FIT_SUN_DROP)
    start = diff.apply_params(state, {
        "scene.materials.albedo": albedo,
        "env.sun_direction": env.sun_direction.new_tensor(sun)})
    angle, elev = _sun_angles(sun, truth)
    log(f"diff cell: {w}x{h}@{spp}spp depth 8, {FIT_MATERIAL} (row {row}, "
        f"{seen} camera hits) albedo {m.albedo[row].tolist()} -> "
        f"{albedo[row].tolist()}, sun {tuple(round(x, 5) for x in truth)} -> "
        f"{tuple(round(x, 5) for x in sun)} (elevation "
        f"{DIFF_SUN_ELEVATION} -> {elev:.2f} degrees, {angle:.2f} degrees "
        f"apart)")
    check(seen > 0, f"diff cell: {FIT_MATERIAL} is not in the frame")
    return state, cfg, start, row


def phase_diff(results: dict) -> None:
    """D1-D4: the differentiable mode (K4 on detached rays, autograd through
    the chunked integrator) and the inverse fit on the card."""
    import dataclasses

    import numpy as np
    import torch

    from raytracer_project_tpu_torch import diff
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import materials as tmat
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.tools import diff_cases

    dev = torch.device("cuda")
    # D1: the chunked smoke's frame in the differentiable mode.
    scene = presets.showcase_scene(grid=6)
    cam = tcam.make_camera(image_width=64, image_height=36, **CAM_KW)
    env = tenv.make_environment(**ENV_KW)
    cfg = dataclasses.replace(_chunked_cfg(64, 36, 8, max_depth=6, aovs=False),
                              differentiable=True)
    state = diff.RenderState(scene.to(dev), cam, env)
    _reset_counters()
    with _PlainCallCounter() as plain:
        img = diff.render_beauty(state, 0, cfg, device=dev).detach().cpu().numpy()
    launches = _launches(CHUNKED_KERNELS)
    log(f"diff D1: 64x36@8spp depth 6 differentiable, launches {launches}, "
        f"plain calls {plain.calls}")
    check(all(v > 0 for v in launches.values()), "K4 was not launched")
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "showcase.npz"))["beauty"]
    _image_agree("D1 differentiable vs CPU golden showcase.npz", img, golden)
    # The same mode on the CPU (tests/test_torch_diff.py holds that against
    # the reference's differentiable render under jax.jit).
    with torch.no_grad():
        cpu = diff.render_beauty(diff.RenderState(scene, cam, env), 0, cfg,
                                 device="cpu").numpy()
    dd = np.abs(img - cpu)
    log(f"  D1 vs the CPU's differentiable render: mean|d| {dd.mean():.2e}, "
        f"frac(>3e-3) {(dd > 3e-3).mean():.5f} (budgets 1e-3 / 0.005)")
    check(dd.mean() < 1e-3 and (dd > 3e-3).mean() < 0.005,
          "D1: the card's and the CPU's differentiable renders disagree")
    # Against the plain render: the recomputed t moves hit points by a few
    # ulps and turns a path here and there. The reference's own
    # differentiable render leaves 0.535% of values over 3e-3 against its
    # plain render here (jax.jit on the CPU), so only the mean is held.
    ref = integrator.render(scene, cam, env, 0, dataclasses.replace(
        cfg, differentiable=False), device=dev)["beauty"].cpu().numpy()
    dd = np.abs(img - ref)
    log(f"  D1 vs the card's plain render: mean|d| {dd.mean():.2e} (budget "
        f"1e-3), frac(>3e-3) {(dd > 3e-3).mean():.5f} (the reference's own "
        f"0.00535)")
    check(dd.mean() < 1e-3, "D1: differentiable and plain renders disagree")

    # D2: the reference's tiny gradient scene, free-running on the card and
    # on the CPU. Lanes whose closest hit differs on any search (K4 against
    # its plain version) are counted; the gradients of the loss over the
    # pixels whose every lane agrees are held card against CPU, and the
    # whole loss's gap is logged beside them.
    paths = ["scene.materials.albedo", "scene.materials.param",
             "env.background_color", "env.sun_intensity",
             "env.sun_direction", "cam.center"]
    target = torch.from_numpy(np.random.default_rng(8).uniform(
        0.0, 1.0, (16, 24, 3)).astype(np.float32))

    def rel(ga, gb):
        return {p: float(np.abs(ga[p] - gb[p]).max())
                / (float(np.abs(gb[p]).max()) + 1e-6) for p in paths}

    for mode in (tenv.SOLID_COLOR, tenv.PHYSICAL_SUN):
        state, tcfg = diff_cases.tiny_state(mode)
        runs = [_free_render(state, tcfg, paths, 0, dv) for dv in (dev, "cpu")]
        lanes, pixels = diff_cases.search_agreement(runs[0][2], runs[1][2],
                                                    tcfg.n_pixels)
        weight = pixels.reshape(tcfg.height, tcfg.width, 1).float()
        whole, held = [], []
        for img, params, _ in runs:
            dt = img - target.to(img.device)
            whole.append(_grads((dt * dt).mean(), params))
            w8 = weight.to(img.device)
            held.append(_grads((dt * dt * w8).sum() / (3 * w8.sum()), params))
        r_whole, r_held = rel(whole[0][1], whole[1][1]), rel(held[0][1], held[1][1])
        n_lanes = int(lanes.numel())
        n_diff = int((~lanes).sum())
        log(f"diff D2 mode {mode}: {n_diff} of {n_lanes} lanes hit another "
            f"primitive on some search (budget 2.5%), {int(pixels.sum())} of "
            f"{tcfg.n_pixels} pixels agree on every lane; loss card / CPU "
            f"{whole[0][0]:.7f} / {whole[1][0]:.7f}, on the agreeing pixels "
            f"{held[0][0]:.7f} / {held[1][0]:.7f} (rtol 1e-4); gradients card "
            f"vs CPU, max|d| / (max|g| + 1e-6) per group, on the agreeing "
            f"pixels (budget 2e-3) and on the whole image:")
        for p in paths:
            log(f"    {p}: max|g| {np.abs(held[0][1][p]).max():.4g}, "
                f"{r_held[p]:.2e}, {r_whole[p]:.2e}")
        check(n_diff <= 0.025 * n_lanes, "D2: too many lanes change their hit")
        check(abs(held[0][0] - held[1][0]) <= 1e-4 * abs(held[1][0]),
              "D2: loss card vs CPU on the agreeing pixels")
        check(max(r_held.values()) <= 2e-3,
              "D2: gradients card vs CPU on the agreeing pixels")
    for mode, path, index, rtol in diff_cases.FD_CHECKS:
        state, tcfg = diff_cases.tiny_state(getattr(tenv, mode))
        g, fd = diff_cases.fd_check(state, tcfg, 0, path, index, device=dev)
        ok = diff_cases.fd_agrees(g, fd, rtol)
        log(f"  D2 FD {path}[{index}] ({mode}): autograd {g:.6g}, central "
            f"difference {fd:.6g}, rtol {rtol}: {'ok' if ok else 'FAIL'}")
        check(ok, f"D2: {path}[{index}] autograd disagrees with FD")

    # D3: the differentiable cell at full size, from the fit's start.
    state, cfg, start, row = _diff_cell(dev)
    with torch.no_grad():
        target = diff.render_beauty(state, 5, cfg, device=dev)
    paths = ["scene.materials.albedo", "scene.materials.param",
             "env.sun_direction"]
    loss_fn, p0 = diff.make_loss_fn(start, cfg, target, paths, device=dev)

    def leaves():
        return {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}

    params = leaves()                                  # warm-up
    loss_fn(params, 5).backward()
    torch.cuda.synchronize()
    params = leaves()
    _reset_counters()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _KernelEvents("closest_hit_feats") as k4:
        t0 = time.perf_counter()
        loss = loss_fn(params, 5)
        float(loss.detach())
        t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - base
    fwd, bwd = t1 - t0, t2 - t1
    n_k4 = _launches(CHUNKED_KERNELS)["closest_hit_feats"]
    k4_event_ms = k4.ms_per_launch()

    def fwd_bwd():
        p = leaves()
        loss_fn(p, 5).backward()
        float(p["env.sun_direction"].grad[0])

    prof = _profile_fn("D3 forward + backward", fwd_bwd, host=False)
    idle = (max(0.0, 1.0 - prof["busy_ms"] / prof["wall_ms"]) if prof
            else None)
    # K4's device time per launch from the trace (the events above also
    # hold the host's launch gaps of this host-paced loop).
    scans = [v for k, v in (prof["kernels"].items() if prof else ())
             if "tile_scan_kernel" in k]
    k4_ms = (sum(t for t, _ in scans) / sum(c for _, c in scans) if scans
             else None)
    log(f"diff D3: loss {float(loss.detach()):.6g}; forward {fwd:.3f} s, "
        f"backward {bwd:.3f} s, backward/forward {bwd / fwd:.3f}; peak "
        f"memory {peak / 2**30:.3f} GiB above the inputs "
        f"({torch.cuda.max_memory_allocated() / 2**30:.3f} GiB in all); K4 "
        f"launches {n_k4}, "
        f"{'not measured' if k4_ms is None else f'{k4_ms:.4f}'} ms per launch "
        f"(profile), {k4_event_ms:.4f} (events); idle share "
        f"{'not measured' if idle is None else f'{idle:.3f}'} (profile)")
    for p in paths:
        g = params[p].grad
        check(g is not None and bool(torch.isfinite(g).all()),
              f"D3: gradient of {p} missing or not finite")
        log(f"  D3 grad {p}: max|g| {float(g.abs().max()):.4g}"
            + (f", row {row} {g[row].tolist()}" if p.endswith("albedo") else
               f" {g.tolist()}" if p.endswith("direction") else ""))
    check(float(params["scene.materials.albedo"].grad.abs().max()) > 0
          and float(params["env.sun_direction"].grad.abs().max()) > 0,
          "D3: albedo or sun-direction gradient is zero")
    check(n_k4 > 0, "D3: K4 was not launched")
    results["closest_hit_feats"].update(diff_launches=n_k4, diff_ms=k4_ms,
                                        diff_event_ms=k4_event_ms)

    # D4: the fit from the start state; the sun's angle to the truth after
    # each step.
    emissive = start.scene.materials.mtype == tmat.EMISSIVE
    truth = state.env.sun_direction.tolist()
    suns = [_sun_angles(start.env.sun_direction.tolist(), truth)]

    def project(p):
        suns.append(_sun_angles(p["env.sun_direction"].tolist(), truth))
        a = p["scene.materials.albedo"]
        return {"scene.materials.albedo": torch.where(
            emissive[:, None], a, torch.clamp(a, 0.0, 1.0))}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted, losses = diff.fit(start, 5, cfg, target,
                              ["scene.materials.albedo", "env.sun_direction"],
                              steps=FIT_STEPS, learning_rate=2e-2,
                              project=project, device=dev)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / FIT_STEPS
    log(f"diff D4: fit {FIT_STEPS} steps (Adam lr 2e-2), {per_step:.3f} s "
        f"per step; losses {', '.join(f'{x:.6g}' for x in losses)}; "
        f"last/first {losses[-1] / losses[0]:.4f} (budget < 0.5); albedo "
        f"row {row} {fitted.scene.materials.albedo[row].tolist()} (start "
        f"{start.scene.materials.albedo[row].tolist()}, true "
        f"{state.scene.materials.albedo[row].tolist()}); sun "
        f"{fitted.env.sun_direction.tolist()} (true {truth}); the sun's angle "
        f"to the truth / its elevation in degrees, from the start, after "
        f"each step: {', '.join(f'{a:.2f}/{e:.2f}' for a, e in suns)}")
    check(all(np.isfinite(losses)), "D4: a loss is not finite")
    check(losses[-1] < 0.5 * losses[0], "D4: the fit did not halve the loss")
    check(suns[-1][0] < suns[0][0], "D4: the sun did not turn toward the truth")


def _q1_scenes():
    """The reference's denoise-quality scenes (tests/test_denoise_quality.py
    :35-57): (name, scene, camera, environment, env mode)."""
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets

    w, h = Q1_SIZE
    return [
        ("shirley", presets.shirley_final_scene(grid=5, with_bvh=False),
         tcam.make_camera(image_width=w, image_height=h, vfov=20,
                          lookfrom=(13, 2, 3), lookat=(0, 0, 0),
                          defocus_angle=0.0, focus_dist=10.0),
         tenv.make_environment(sun_direction=(0.4, 0.6, 0.2),
                               sun_intensity=5.0), tenv.PHYSICAL_SUN),
        ("cornell", presets.cornell_box_scene(with_bvh=False),
         tcam.make_camera(image_width=w, image_height=h, vfov=40,
                          lookfrom=(278, 278, -800), lookat=(278, 278, 0)),
         tenv.make_environment(background_color=(0.0, 0.0, 0.0)),
         tenv.SOLID_COLOR)]


def _aov_render(scene, cam, env, mode, w, h, spp, seed):
    """(beauty, albedo, normal) [H, W, 3] on the card from the fused pool
    with the albedo and normal AOVs, depth 8."""
    from raytracer_project_tpu_torch.ops import integrator

    cfg = integrator.RenderConfig(
        width=w, height=h, samples_per_pixel=spp, max_depth=8, env_mode=mode,
        use_albedo=True, use_normal=True, use_z_depth=False, wavefront=True)
    out = integrator.render(scene, cam, env, seed, cfg, device="cuda")
    return out["beauty"], out["albedo"], out["normal"]


def phase_denoise() -> None:
    """Q1-Q3: the reference's denoise-quality gate on the card, both
    denoisers card against CPU, and their times at 1080p."""
    import torch

    from raytracer_project_tpu_torch.models import denoiser_unet
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.ops import denoise
    from raytracer_project_tpu_torch.utils import metrics

    dev = torch.device("cuda")
    model = denoiser_unet.load_default(device=dev)
    check(model is not None, "the shipped denoiser weights are missing")
    w, h = Q1_SIZE
    low, high = Q1_SPP
    for name, scene, cam, env, mode in _q1_scenes():
        scene = scene.to(dev)
        ref, _, _ = _aov_render(scene, cam, env, mode, w, h, high, 42)
        _reset_counters()
        noisy, albedo, normal = _aov_render(scene, cam, env, mode, w, h, low, 42)
        launches = _launches(FEATURES_KERNELS)
        check(all(v > 0 for v in launches.values()),
              f"Q1 {name}: the fused pool's AOV kernels were not launched")
        with torch.no_grad():
            at = denoise.atrous_denoise(noisy, albedo, normal)
            un = denoise.denoise(noisy, albedo, normal, model=model)
        p = {k: float(metrics.psnr(v, ref)) for k, v in
             (("raw", noisy), ("atrous", at), ("unet", un))}
        s = {k: float(metrics.ssim(v, ref)) for k, v in
             (("raw", noisy), ("atrous", at), ("unet", un))}
        log(f"denoise Q1 {name} {w}x{h} {low} vs {high} spp: PSNR raw "
            f"{p['raw']:.2f} atrous {p['atrous']:.2f} unet {p['unet']:.2f} dB; "
            f"SSIM raw {s['raw']:.4f} atrous {s['atrous']:.4f} unet "
            f"{s['unet']:.4f}; launches {launches}")
        check(p["atrous"] > p["raw"] and s["atrous"] > s["raw"],
              f"Q1 {name}: a-trous does not improve on the raw render")
        check(p["unet"] > p["raw"] + 2.0 and s["unet"] > s["raw"] + 0.04,
              f"Q1 {name}: the U-Net gains less than 2 dB / 0.04 SSIM")
        if name == "cornell":
            check(p["unet"] > p["raw"] + 6.0 and s["unet"] > 0.98,
                  "Q1 cornell: the U-Net gains less than 6 dB or SSIM <= 0.98")
            buf_t1 = (noisy, albedo, normal)
        # Q2: both denoisers card against CPU on these buffers.
        cpu_in = [x.cpu() for x in (noisy, albedo, normal)]
        cpu_model = denoiser_unet.load_default(device="cpu")
        with torch.no_grad():
            for label, card, cpu in (
                    ("atrous", at, denoise.atrous_denoise(*cpu_in)),
                    ("unet", un, cpu_model(*cpu_in))):
                err = float((card.cpu() - cpu).abs().max())
                scale = float(cpu.abs().max())
                log(f"  Q2 {name} {label} card vs CPU: max|d| {err:.3g} "
                    f"(budget 1e-4 x max {scale:.3g})")
                check(err <= 1e-4 * scale, f"Q2 {name} {label}: card vs CPU")

    # T1: a short training run on the card (6 pairs, 200 steps): the loss
    # falls, and the weights written load back through load_params into a
    # U-Net whose output equals the trained one's and is finite.
    from raytracer_project_tpu_torch.tools import train_denoiser

    base = os.path.join(REPO, "build", "chip_smoke")
    res = train_denoiser.main(
        steps=T1_STEPS, pairs=T1_PAIRS,
        out=os.path.join(base, "denoiser", "denoiser_weights.npz"),
        cache=os.path.join(base, "denoiser_data"), device=dev)
    losses = res["losses"]
    first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    log(f"denoise T1: {T1_PAIRS} pairs rendered in {res['data_s']:.2f} s, "
        f"{T1_STEPS} steps in {res['train_s']:.2f} s; loss over the first / "
        f"last 20 steps {first:.5f} / {last:.5f}, last {losses[-1]:.5f}; "
        f"validation PSNR " + "; ".join(
            ", ".join(f"{k} {v:.2f}" for k, v in row.items())
            for row in res["val"]))
    check(all(v == v for v in losses) and last < first,
          "T1: the training loss did not fall")
    loaded = denoiser_unet.DenoiserUNet(
        denoiser_unet.load_params(res["out"])).to(dev)
    with torch.no_grad():
        a, b = res["model"](*buf_t1), loaded(*buf_t1)
    err = float((a - b).abs().max())
    check(bool(torch.isfinite(b).all()), "T1: the loaded U-Net is not finite")
    check(err <= 1e-6 * float(a.abs().max()),
          f"T1: the loaded weights give another output (max |d| {err:.3g})")
    log(f"denoise T1: weights {res['out']} load back; output against the "
        f"trained U-Net's: bit-equal {bool(torch.equal(a, b))}, max |d| "
        f"{err:.3g}")

    # Q3: both denoisers on the 1080p showcase buffers.
    qw, qh, qspp = Q3_SIZE
    inputs = _showcase(qw, qh)
    buf = _aov_render(*inputs, tenv.PHYSICAL_SUN, qw, qh, qspp, 1)
    pixels = qw * qh
    flops = pixels * sum(
        2 * kh * kw * cin * cout // (4 ** level)
        for (_, (kh, kw, cin, cout), _), level in zip(
            denoiser_unet._LAYERS, (0, 0, 1, 1, 2, 2, 1, 1, 0, 0, 0)))
    nbytes = pixels * (9 + 3) * 4 + 4 * denoiser_unet.param_count(model.params())
    bound, bound_by = bound_ms(nbytes, flops)
    with torch.no_grad():
        for label, fn in (("atrous", lambda: denoise.atrous_denoise(*buf)),
                          ("unet", lambda: model(*buf))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            check(bool(torch.isfinite(out).all()), f"Q3 {label}: not finite")
            ms = time_ms(f"Q3 {label} {qw}x{qh}", fn, n=5, rounds=3)
            extra = (f"; bound {bound:.3f} ms ({bound_by}: {flops / 1e12:.4f} "
                     f"TFLOP at 67 TFLOP/s f32), {bound / ms:.1%} of it"
                     if label == "unet" else "")
            log(f"denoise Q3 {label} {qw}x{qh}@{qspp}spp buffers: {ms:.3f} ms, "
                f"peak memory {peak / 2**30:.3f} GiB above the inputs{extra}")


def phase_tools() -> None:
    """The last tool twins once on the card: prof_fused_step at bench
    shapes (800x450, the 23 spp chunk, depth 10), and the parity gallery's
    16 PNGs written under build/ and read back."""
    from raytracer_project_tpu_torch.tools import make_parity_gallery
    from raytracer_project_tpu_torch.tools import prof_fused_step
    from raytracer_project_tpu_torch.utils import image_io

    rows = prof_fused_step.main([])
    log("prof_fused_step (800x450, 23 spp chunk, 10 reps after two warm "
        "steps): " + ", ".join(f"{k} {v:.4f} ms" for k, v in rows.items()))
    check(all(v > 0 for v in rows.values()), "prof_fused_step: a row is 0")
    t0 = time.perf_counter()
    written = make_parity_gallery.main(
        ["--out", os.path.join(REPO, "build", "chip_smoke", "parity")])
    wall = time.perf_counter() - t0
    check(len(written) == 16, f"gallery: {len(written)} PNGs")
    lit = 0
    for path in written:
        img = image_io.read_png(path)
        check(img.shape == (112, 200, 3), f"gallery: {path} reads back as "
              f"{img.shape}")
        lit += int(img.max() > 0)
    log(f"gallery: 16 PNGs at 200x112 in {wall:.1f} s, read back, {lit} "
        f"not black")
    check(lit >= 15, "gallery: more than one black image")


# --- phase 25: the front end (session, CLI, interactive loop) ----------------

FRONT = os.path.join(REPO, "build", "frontend")
FRONT_SIZE = (800, 450, 32, 4)          # width, height, spp, chunk
FRONT_PASSES = ("rgb", "albedo", "normals", "z_depth")
FRONT_SCRIPT = ("set post.exposure 1.5\npass albedo\nstats\npass rgb\n"
                "wire 2\nset camera.vfov 35\nsun 45 172 12\n"
                f"saveall {os.path.join(FRONT, 'all')}\nquit\n")


class _SessionSpy:
    """Records, while the front end runs, each RenderSession it drives and
    the wall (synchronised), segments and pool steps of every chunk's
    integrator.accumulate_samples call."""

    def __enter__(self):
        import torch

        from raytracer_project_tpu_torch.ops import integrator
        from raytracer_project_tpu_torch.utils import session

        self.sessions, self.chunks = [], []
        self.orig = (integrator.accumulate_samples,
                     session.RenderSession.render_progressive)
        acc, prog = self.orig

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, stats = acc(*args, **kw)
            torch.cuda.synchronize()
            self.chunks.append((time.perf_counter() - t0, stats["segments"],
                                stats["steps"]))
            return out, stats

        def progressive(sess, *args, **kw):
            self.sessions.append(sess)
            return prog(sess, *args, **kw)

        integrator.accumulate_samples = timed
        session.RenderSession.render_progressive = progressive
        return self

    def __exit__(self, *exc):
        from raytracer_project_tpu_torch.ops import integrator
        from raytracer_project_tpu_torch.utils import session

        (integrator.accumulate_samples,
         session.RenderSession.render_progressive) = self.orig


def _front_config():
    """The config `render` builds for the F1 command line."""
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.ops import integrator

    w, h, spp, _ = FRONT_SIZE
    return integrator.RenderConfig(env_mode=tenv.PHYSICAL_SUN, width=w,
                                   height=h, samples_per_pixel=spp,
                                   max_depth=10)


def _front_inputs():
    """The scene, camera and environment `render --preset showcase` builds."""
    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv

    w, h, _, _ = FRONT_SIZE
    scene, cam_kw = cli._preset("showcase")
    return (scene.to("cuda"),
            tcam.make_camera(image_width=w, image_height=h, defocus_angle=0.0,
                             focus_dist=10.0, **cam_kw),
            tenv.make_environment())


def _timed_session(inputs, cfg, mesh=None):
    import torch

    from raytracer_project_tpu_torch.utils.session import RenderSession

    sess = RenderSession(*inputs, cfg, key=0, chunk_samples=FRONT_SIZE[3],
                         mesh=mesh, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.render_progressive(cfg.samples_per_pixel)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, sess


def _timed_one_shot(inputs, cfg):
    import torch

    from raytracer_project_tpu_torch.ops import integrator

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = integrator.render(*inputs, 0, cfg, device="cuda",
                                   with_stats=True)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out, stats


def _front_f1(results: dict):
    """F1: `render` through cli.main at 800x450 @ 32 spp in chunks of 4 with
    four passes, against a one-shot integrator.render of the frame."""
    import numpy as np

    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.ops import post
    from raytracer_project_tpu_torch.utils import image_io
    from raytracer_project_tpu_torch.utils.session import to_u8

    w, h, spp, chunk = FRONT_SIZE
    argv = ["render", "--preset", "showcase", "--width", str(w), "--height",
            str(h), "--spp", str(spp), "--max-depth", "10", "--chunk",
            str(chunk), "--passes", ",".join(FRONT_PASSES), "--out", FRONT,
            "--checkpoint", os.path.join(FRONT, "ck.npz"), "--quiet"]
    _reset_counters()
    with _PlainCallCounter() as plain, _SessionSpy() as spy:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        cli_wall = time.perf_counter() - t0
    launches = _launches(("closest_hit", "shade_advance",
                          "shade_advance_features"))
    check(rc == 0, f"render exited {rc}")
    sess = spy.sessions[0]
    walls = [c[0] for c in spy.chunks]
    log(f"frontend F1: cli.main render {w}x{h}@{spp}spp chunks of {chunk}: "
        f"{cli_wall:.3f} s in all, {len(walls)} chunks "
        f"{sum(walls):.3f} s, segments {sum(c[1] for c in spy.chunks)}, "
        f"steps {sum(c[2] for c in spy.chunks)}, launches {launches}, plain "
        f"calls {plain.calls}")
    log("  chunk walls ms: " + ", ".join(f"{t * 1e3:.1f}" for t in walls))
    check(launches["closest_hit"] > 0
          and launches["shade_advance_features"] > 0,
          "F1: a kernel was not launched")
    check(plain.calls == 0, "F1: a plain version ran during the CUDA render")
    results["closest_hit"]["session_launches"] = launches["closest_hit"]
    results["shade_advance_features"]["session_launches"] = launches[
        "shade_advance_features"]
    pngs = {}
    for name in FRONT_PASSES:
        pngs[name] = image_io.read_png(os.path.join(FRONT,
                                                    f"render_{name}.png"))
        check(pngs[name].shape == (h, w, 3), f"F1 {name} PNG shape")

    cfg = _front_config()
    inputs = _front_inputs()
    _, one, _ = _timed_one_shot(inputs, cfg)
    params = sess.post_params
    pc = post.PostConfig()
    params = params._replace(exposure=post.auto_exposure(
        params, post.analyze_framebuffer(one["beauty"]), pc))
    want = to_u8(post.update_post_processing(one["beauty"], params, pc,
                                             post.PASS_RGB))
    over = (np.abs(pngs["rgb"].astype(int) - want.astype(int)).max(-1)
            > 1).mean()
    log(f"  beauty PNG vs the one-shot render's: {over:.5f} of pixels over "
        f"1 LSB (limit 0.01)")
    check(over <= 0.01, "F1: the session's beauty PNG is off the one-shot's")
    got = sess.buffers()
    for name in ("albedo", "normal", "z_depth"):
        a, b = float(got[name].mean()), float(one[name].mean())
        rel = abs(a - b) / b
        log(f"  {name} mean {a:.6f} vs one-shot {b:.6f}: {rel:.2e} relative "
            f"(limit 3e-4)")
        check(rel <= 3e-4, f"F1: the {name} AOV is off the one-shot's")

    # Walls in turns: one-shot, session, session, one-shot.
    order = []
    for kind in ("one-shot", "session", "session", "one-shot"):
        if kind == "session":
            with _SessionSpy() as spy:
                wall, s = _timed_session(inputs, cfg)
            segs = s.segments_traced
            steps = sum(c[2] for c in spy.chunks)
            walls = [c[0] * 1e3 for c in spy.chunks]
            extra = (f", chunk walls ms {min(walls):.1f}-{max(walls):.1f} "
                     f"(mean {sum(walls) / len(walls):.1f})")
        else:
            wall, _, st = _timed_one_shot(inputs, cfg)
            segs, steps, extra = st["segments"], st["steps"], ""
        order.append((kind, wall))
        log(f"  {kind}: wall {wall:.4f} s, segments {int(segs)}, steps "
            f"{steps}, segments/s {segs / wall:.4g}{extra}")
    sess_w = [t for k, t in order if k == "session"]
    one_w = [t for k, t in order if k == "one-shot"]
    log(f"frontend F1: session {min(sess_w):.4f}-{max(sess_w):.4f} s against "
        f"one-shot {min(one_w):.4f}-{max(one_w):.4f} s: overhead "
        f"{min(sess_w) - max(one_w):.4f}-{max(sess_w) - min(one_w):.4f} s")
    return sess, inputs, cfg


def _front_f2(sess, inputs, cfg) -> None:
    """F2: checkpoint at 16 spp, `render --resume` finishes it to 32 in a
    fresh session; its checkpoint holds the uninterrupted session's sums."""
    import numpy as np
    import torch

    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.utils.session import RenderSession

    w, h, spp, chunk = FRONT_SIZE
    half = RenderSession(*inputs, cfg, key=0, chunk_samples=chunk,
                         device="cuda")
    half.render_progressive(spp // 2)
    ck = os.path.join(FRONT, "ck_resume.npz")
    half.checkpoint(ck)
    argv = ["render", "--preset", "showcase", "--width", str(w), "--height",
            str(h), "--spp", str(spp), "--max-depth", "10", "--chunk",
            str(chunk), "--passes", "rgb", "--out",
            os.path.join(FRONT, "resume"), "--checkpoint", ck, "--resume",
            "--quiet"]
    with _SessionSpy() as spy:
        check(cli.main(argv) == 0, "F2: render --resume failed")
    resumed = spy.sessions[0]
    check(len(spy.chunks) == (spp // 2) // chunk,
          f"F2: {len(spy.chunks)} chunks after the resume")
    check(any("Restored 16 samples" in e for e in resumed.log.entries),
          "F2: the checkpoint was not restored")
    with np.load(ck) as data:
        check(int(data["samples_done"]) == spp, "F2: samples_done")
        got = integrator.SampleBuffers(*(torch.as_tensor(data[f])
                                         for f in integrator.SampleBuffers._fields))
    ref = integrator.SampleBuffers(*(x.cpu() for x in sess.acc))
    _sums_agree("frontend F2 resumed at 16 spp vs uninterrupted", got, ref)


def _front_f3(sess, inputs, cfg) -> None:
    """F3: a session over a mesh of cuda:0 listed 4 times against the
    single-device session."""
    import torch

    one_wall, _ = _timed_session(inputs, cfg)
    mesh_wall, meshed = _timed_session(inputs, cfg,
                                       mesh=[torch.device("cuda", 0)] * 4)
    log(f"frontend F3: mesh of 4 x cuda:0 session {mesh_wall:.4f} s, "
        f"single-device session {one_wall:.4f} s")
    _sums_agree("frontend F3 mesh vs single device", meshed.acc, sess.acc)


def _front_f4(results: dict) -> None:
    """F4: `interactive` at 400x225 with a preview PNG, fed a command
    script through InteractiveLoop.run."""
    import io

    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.utils import image_io
    from raytracer_project_tpu_torch.utils.interactive import InteractiveLoop

    preview = os.path.join(FRONT, "preview.png")
    args = cli._build_parser().parse_args(["interactive", "--watch", preview])
    loop = cli.build_interactive(args)
    loop.log.echo = False
    check((loop.config.width, loop.config.height) == (400, 225),
          "F4: interactive's default size")
    loop.tick()
    loop.tick()
    record, commands = [], []

    def tick():
        notes = InteractiveLoop.tick(loop)
        record.append((commands[-1] if commands else "",
                       loop.session.samples_done, id(loop.session), notes))
        return notes

    def handle(line):
        commands.append(line.strip())
        return InteractiveLoop.handle_command(loop, line)

    loop.tick, loop.handle_command = tick, handle
    out = io.StringIO()
    k1.closest_hit_feats.launches = 0
    t0 = time.perf_counter()
    loop.run(stdin=io.StringIO(FRONT_SCRIPT), max_ticks=40, out=out)
    wall = time.perf_counter() - t0
    wire = k1.closest_hit_feats.launches
    log(f"frontend F4: {len(record)} ticks in {wall:.3f} s, K4 launches "
        f"{wire}; samples_done after each command: "
        + ", ".join(f"{c!r} {n}" for c, n, _, _ in record))
    ticks = {c: i for i, (c, _, _, _) in enumerate(record)}
    i = ticks["set post.exposure 1.5"]
    check(record[i][2] == record[i - 1][2]
          and record[i][1] == record[i - 1][1] + 2,
          f"F4: the post edit did not keep samples_done ({record[i][1]})")
    j = ticks["set camera.vfov 35"]
    check(record[j][2] != record[j - 1][2] and record[j][1] == 2,
          f"F4: the camera edit did not restart ({record[j][1]} samples)")
    text = out.getvalue()
    check("[Config] sun synced" in text, "F4: the sun line did not sync")
    check(image_io.read_png(preview).shape == (225, 400, 3),
          "F4: the preview PNG")
    check(wire > 0, "F4: wire did not launch K4")
    check(not loop.running, "F4: quit did not stop the loop")
    for name in ("rgb", "albedo", "normals", "reflections", "refractions",
                 "z_depth"):
        check(os.path.exists(os.path.join(FRONT, "all", f"render_{name}.png")),
              f"F4: saveall did not write {name}")
    results["closest_hit_feats"]["wire_launches"] = wire


def _front_f5_f6() -> None:
    """F5: --check-numerics on a 16x9 frame is clean, and the trap raises
    on a NaN on the card. F6: info, and --profile writes a trace."""
    import contextlib
    import io
    import torch

    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.utils import debug

    argv = ["render", "--width", "16", "--height", "9", "--spp", "1",
            "--out", os.path.join(FRONT, "numerics"), "--check-numerics"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(argv) == 0, "F5: --check-numerics render failed")
    check("check-numerics pass clean" in buf.getvalue(),
          "F5: the probe was not clean")
    x = torch.linspace(0.0, 4.0, 9, device="cuda")
    try:
        debug.checked(lambda v: torch.where(v < 2.0, 0.0,
                                            torch.sqrt(v - 2.0)))(x)
        raise AssertionError("F5: the trap did not raise on a NaN")
    except FloatingPointError as e:
        check("aten.sqrt" in str(e), f"F5: the trap named {e}")
        log(f"frontend F5: --check-numerics clean; trap: {e}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(["info"]) == 0, "F6: info failed")
    info = json.loads(buf.getvalue())
    check(info["cuda_available"] and info["card"], "F6: info saw no card")
    check("jax" not in buf.getvalue().lower(), "F6: info names JAX")
    prof = os.path.join(FRONT, "profile")
    argv = ["render", "--width", "64", "--height", "36", "--spp", "2",
            "--chunk", "2", "--out", prof, "--profile", prof, "--quiet"]
    check(cli.main(argv) == 0, "F6: --profile render failed")
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(ev.get("cat") == "kernel" for ev in events)
    check(kernels > 0, "F6: the trace holds no CUDA kernel")
    scatters = {ev.get("name", "") for ev in events
                if "index_add" in ev.get("name", "")
                or "indexFunc" in ev.get("name", "")}
    check(not scatters, f"F6: index_add_ in the fused render: {scatters}")
    log(f"frontend F6: info card {info['card']!r}; trace of {len(events)} "
        f"events, {kernels} CUDA kernels")


def phase_frontend(results: dict) -> None:
    """F1-F6: the progressive session, the CLI and the interactive loop on
    the card (outputs under build/frontend/)."""
    import shutil

    shutil.rmtree(FRONT, ignore_errors=True)
    os.makedirs(FRONT)
    t0 = time.perf_counter()
    sess, inputs, cfg = _front_f1(results)
    _front_f2(sess, inputs, cfg)
    _front_f3(sess, inputs, cfg)
    _front_f4(results)
    _front_f5_f6()
    log(f"frontend: F1-F6 in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from raytracer_project_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    smi = nvidia_smi_line()
    log(f"card: {smi}")
    secs = kernels.build_all(force=True)
    log(f"build: {len(kernels.SOURCES)} kernels in {secs:.1f} s")
    for name in kernels.SOURCES:
        text = (kernels.BUILD_DIR / f"{name}.log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  {name}: {line.strip()}")
    results: dict = {}
    ray_sets = phase_kernels(results)
    phase_start(results)
    phase_k4(results)
    phase_smoke(results)
    phase_smoke_module(results)
    phase_full(results)
    phase_chunked_smoke()
    phase_chunked_full(results)
    phase_k3_features(results)
    phase_features_smoke(results)
    phase_features_full(results)
    phase_probes(results, ray_sets["bounce"])
    phase_scenes_smoke()
    phase_bvh_traverse()
    phase_funnel_kernels(results)
    phase_bvh_kernel(results)
    phase_baseline_configs(results)
    phase_bench()
    phase_bench_bvh()
    phase_pool_smoke(results)
    phase_pool_full(results)
    phase_windows(results)
    phase_multicard(results)
    phase_sort_rays(results)
    phase_post(phase_two_process())
    phase_diff(results)
    phase_denoise()
    phase_tools()
    phase_frontend(results)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
