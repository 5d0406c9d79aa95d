#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (raytracer_project_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints flushed lines; any failure raises and exits non-zero):
  1. build     compile the CUDA kernels (csrc/*.cu, nvcc in parallel) and
               print the card's name and power limit;
  2. kernels   hold each kernel against its plain PyTorch version on the
               card at its path's shapes (K1-K3: 131,072 lanes of showcase
               camera rays and one bounce of their scattered rays; K4:
               360,000 lanes, the 800x450 camera rays and one scatter of
               them), the closest hits also against the exact brute-force
               oracle, K4 against K1, and K1 and K4 bit for bit against
               the dense 16-term scan of the first port (every lane with
               finite features; the others counted), both designs timed;
  3. smoke     render the 64x36 @ 2 spp showcase (seed 0) through
               integrator.render and compare it with the reference's CPU
               golden under the cross-backend budgets;
  4. full      the fused main path: 800x450 @ 32 spp after one warm-up,
               with the launch counts read around it, then 1920x1080 @
               8 spp (two sample chunks);
  5. chunked smoke  the chunked integrator (wavefront=False): 64x36 @ 8 spp
               depth 6 against the reference's CPU golden, and 32x18 @ 4 spp
               with all six buffers against the port's own CPU render;
  6. chunked full   the chunked path at full size: 800x450 @ 32 spp, depth
               10, the AOVs and both split passes on, with K4's launches
               read around it, and a profile of a 4 spp render;
  7. k3 features   K3's variant with fog, every AOV and both split passes
               against its plain version at 131,072 lanes (the fog
               showcase's camera rays with every other lane a spec lane,
               and one step of them), timed, with its byte bound;
  8. features smoke  the fog showcase at 64x36 @ 4 spp with every AOV and
               both passes through integrator.render against the
               reference's three `smoke_features_*` CPU goldens;
  9. features full   the fused path with every feature at full size:
               800x450 @ 32 spp, depth 10, showcase_scene(use_fog=True),
               all six buffers, with the launch counts read around it, a
               profile, and the albedo AOV against a first-hit chunked
               render of the same frame;
 10. probes    the twins of the reference's kernel probes (tools/): P1,
               K1's scan in four ablations on 262,144 rays (the SASS of
               each variant checked for the work it keeps, full against
               K1 bit for bit); P2 and P4, the one-hot row fetch in six
               layouts; P3, the decode stages d0-d2 and d3 (= K2) on K1's
               hits of the showcase camera rays. Each variant runs through
               its entry with the counts read around it, is held against
               its plain version on the card, and is timed with its bound;
then one JSON line of per-kernel numbers, the nvidia-smi line, and the
device JSON line last. Takes no arguments and always runs every phase.
Exits non-zero without a CUDA device, and outside a checkout of the repo.
"""

from __future__ import annotations

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
# f32 operations of one K1 epilogue with its compare against the running
# best, counted from csrc/closest_hit.cu (sphere_epi, tri_epi, box_epi).
EPILOGUE_OPS = (15, 12, 35)
# Kernels each path launches (the counters of _counters()).
FUSED_KERNELS = ("closest_hit", "decode", "shade_advance")
FEATURES_KERNELS = ("closest_hit", "decode", "shade_advance_features")
CHUNKED_KERNELS = ("closest_hit_feats",)
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

def hit_agree(name, t_a, idx_a, typ_a, t_b, idx_b, typ_b, left=None):
    """Closest-hit agreement under the reference's budgets
    (utils/smoke.py:351-359): hit flips <= 1%, winner flips <= 2.5%,
    same-winner t at most 3% of rays over 5e-3 relative, none over 5e-2.

    left = (idx, type, hit) of the primitive each ray starts on (bounce
    rays only): a same-winner lane that hits that primitive again is a
    self-hit from an origin RAY_EPSILON off its surface, where near-grazing
    rays re-enter at a root the f32 rounding of each formulation decides,
    the exact oracle's included. Such lanes count in the 3% budget but are
    not held to the 5e-2 cap; their number over it is logged. Returns the
    max |dt| over the same-winner hits held to the cap."""
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
        self_hit = left[2] & (idx_a == left[0]) & (typ_a == left[1])
    near = self_hit[same]
    held = same & ~self_hit
    frac = float((rel > 5e-3).float().mean()) if rel.numel() else 0.0
    mx = float(rel[~near].max()) if bool(held.any()) else 0.0
    abs_err = float((t_a - t_b).abs()[held].max()) if bool(held.any()) else 0.0
    selfhit = ""
    if left is not None:
        dt_self = float((t_a - t_b).abs()[same & self_hit].max()) if bool(
            (same & self_hit).any()) else 0.0
        selfhit = (f"; self-hits {int(near.sum())}, of them over 5e-2 "
                   f"{int((near & (rel > 5e-2)).sum())}, "
                   f"max |dt| {dt_self:.3g}")
    log(f"  {name}: hits {int(both.sum())}/{n}, hit flips {flips}, winner "
        f"flips {winner}, frac(rel>5e-3) {frac:.5f}, max rel {mx:.3g}, "
        f"max |dt| {abs_err:.3g}{selfhit}")
    if rel.numel() and float(rel.max()) > 5e-2:
        order = torch.argsort(rel, descending=True)[:4]
        order = order[rel[order] > 5e-2]
        for i, k in zip(torch.nonzero(same).flatten()[order].tolist(),
                        order.tolist()):
            log(f"    lane {i}: type {int(typ_a[i])} idx {int(idx_a[i])} "
                f"t {float(t_a[i]):.6g} vs {float(t_b[i]):.6g}"
                f"{' (self-hit)' if bool(near[k]) else ''}")
    check(flips <= max(2, n // 100), f"{name}: {flips} hit flips")
    check(winner <= max(2, n // 40), f"{name}: {winner} winner flips")
    check(frac <= 0.03 and mx <= 5e-2, f"{name}: same-winner t drift")
    return abs_err


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
    dot) plus one epilogue per primitive. The K1 and K4 bounds count it at
    the tables' finest AABBs (`fine_tables`, width MM_FINE = 128); P1,
    whose kernel culls 512-wide chunks, at 512, and its ablations count
    only the dots or only the epilogues."""
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


def p1_operations(od, t_full, tab, variant: str) -> int:
    """f32 operations of P1 `variant` on the rays od with every ray culled
    on its own: full as K1 (its closest hit t_full); nocull every chunk;
    nodots the epilogues of every chunk a ray reaches (its best t stays
    T_MAX); cheapepi the dots of the chunks a ray reaches before its own
    running minimum of raw group-0 dots, chunk by chunk in scan order."""
    import torch

    from raytracer_project_tpu_torch.ops import intersect

    if variant != "cheapepi":
        return k1_operations(od, t_full if variant == "full" else
                             torch.full_like(t_full, 1e30), tab,
                             dots=variant != "nodots", cull=variant != "nocull")
    feats = intersect.ray_features((od[0], od[1], od[2]), (od[3], od[4], od[5]))
    o, d = od[:3], od[3:]
    inv_d = 1.0 / torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
    best = torch.full_like(t_full, 1e30)
    total = 0
    for coeff, bnd, n in zip(*tab):
        for c, c0 in enumerate(range(0, n, 512)):
            block = coeff[:, :, c0:min(c0 + 512, n)]
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


def phase_kernels(results: dict):
    """K1-K3 against their plain versions; returns the ray sets (the pool's
    camera rays and one bounce of them, f32[6, 131072] each)."""
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
            max_abs_err=k3_err, ms=t_k3, plain_ms=t_k3p,
            bound_ms=bound(k3_bytes), bound_by="bytes", library_ms=None),
    })
    for r in results.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms/launch, plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  closest_hit dense: {t_k1d:.4f} ms/launch "
        f"({t_k1d / t_k1:.2f}x the new scan)")
    return ray_sets


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

    return {"closest_hit": (k1.closest_hit, "launches"),
            "decode": (fs.decode, "launches"),
            "shade_advance": (fs.shade_advance, "launches"),
            "shade_advance_features": (fs.shade_advance, "features_launches"),
            "closest_hit_feats": (k1.closest_hit_feats, "launches"),
            "ablate": (pa.ablate, "launches"),
            "onehot_fetch": (po.onehot_fetch, "launches"),
            "decode_stage": (pd.decode_stage, "launches")}


def _reset_counters():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _launches(names) -> dict:
    counters = _counters()
    return {k: getattr(*counters[k]) for k in names}


class _PlainCallCounter:
    """Counts calls of the plain versions, and of the dense closest-hit
    scan, while the render runs."""

    def __enter__(self):
        from raytracer_project_tpu_torch.ops import closest_hit as k1
        from raytracer_project_tpu_torch.ops import fused_step as fs

        self.calls = 0
        self.saved = [(k1, "closest_hit_plain"), (fs, "decode_plain"),
                      (fs, "shade_advance_plain"),
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


def phase_smoke() -> None:
    import numpy as np

    from raytracer_project_tpu_torch.ops import integrator

    scene, cam, env = _showcase(64, 36)
    _reset_counters()
    with _PlainCallCounter() as plain:
        out = integrator.render(scene, cam, env, 0, _cfg(64, 36, 2))
        img = out["beauty"].cpu().numpy()
    launches = _launches(FUSED_KERNELS)
    log(f"smoke: 64x36@2spp launches {launches}, plain calls {plain.calls}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    check(bool(np.isfinite(img).all()) and img.max() > 0, "smoke image bad")
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "smoke_fused_64x36.npz"))["beauty"]
    d = np.abs(img - golden)
    mean, frac = float(d.mean()), float((d.max(axis=-1) > 0.05).mean())
    log(f"smoke: CPU-golden diff mean|d| {mean:.5f} frac(>0.05) {frac:.4f} "
        f"(budgets 0.06 / 0.20)")
    check(mean <= 0.06 and frac <= 0.20, "smoke image disagrees with golden")


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
    log(f"full: main-path launches {launches}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    for name, n in launches.items():
        results[name]["launches"] = n
    _render_timed(1920, 1080, 8, 2)
    _profile("800x450@32spp fused", _showcase(800, 450), _cfg(800, 450, 32))


def _profile(label: str, inputs, cfg) -> None:
    """Device time by kernel and the device's idle share over one render
    (seed 1) of `cfg`, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracer_project_tpu_torch.ops import integrator

    scene, cam, env = inputs
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = integrator.render(scene, cam, env, 1, cfg)
        out["beauty"].cpu()
        wall = time.perf_counter() - t0
    # Kernel executions only (device-side events); host ops are left out,
    # since they carry the device time of the kernels they launch.
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        tot, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + (end - start), cnt + 1)
    if not spans:
        log(f"profile {label}: the trace holds no device time (not measured)")
        return
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
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
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
    rec1 = fs.trace_decode(tables, states["bounce"][0][:6].contiguous(), aparams)
    args = (rec1, *states["bounce"], next_work, segments, bparams, sp)
    t_k3 = time_ms("K3 features", lambda: fs.shade_advance(tables, *args))
    t_k3p = time_ms("K3 features plain",
                    lambda: fs.shade_advance_plain(tables, *args), rounds=3)
    n_c, n_t = fs.output_rows(sp)
    nf, ni = fs.state_rows(sp)
    # Record rows, state in and out, texel words, contributions, targets.
    nbytes = P_MAIN * 4 * (fs._RO_ROWS + 2 * (nf + ni) + 6 + n_c + n_t)
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    results["shade_advance_features"] = dict(
        name="shade_advance_features", route="cuda",
        source="raytracer_project_tpu_torch/csrc/shade_advance.cu",
        replaces="raytracer_project_tpu/ops/fused_step.py:669",
        max_abs_err=err, ms=t_k3, plain_ms=t_k3p, bound_ms=bound,
        bound_by="bytes", library_ms=None)
    log(f"  shade_advance_features: {t_k3:.4f} ms/launch, plain {t_k3p:.4f} "
        f"ms, bound {bound:.4f} ms (bytes, {nbytes // P_MAIN} B/lane), "
        f"most lanes that differ {flips}")


def _features_cfg(width, height, spp, **kw):
    from raytracer_project_tpu_torch.ops import integrator

    return integrator.RenderConfig(
        width=width, height=height, samples_per_pixel=spp, max_depth=10,
        use_reflection=True, use_refraction=True, **kw)


def phase_features_smoke() -> None:
    """The reference's fused-features stage on the card (utils/smoke.py:
    241-292) against its CPU goldens, under the cross-backend budgets."""
    import numpy as np

    from raytracer_project_tpu_torch.ops import integrator

    inputs = _showcase(64, 36, use_fog=True, fog_density=0.02)
    _reset_counters()
    with _PlainCallCounter() as plain:
        out = integrator.render(*inputs, 0, _features_cfg(64, 36, 4))
        imgs = {k: v.cpu().numpy() for k, v in out.items()}
    launches = _launches(FEATURES_KERNELS)
    log(f"features smoke: 64x36@4spp fog, AOVs, passes: launches {launches}, "
        f"plain calls {plain.calls}")
    check(all(v > 0 for v in launches.values()), "a kernel was not launched")
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    for name in ("beauty", "albedo", "reflection"):
        golden = np.load(os.path.join(
            REPO, "tests", "goldens", f"smoke_features_{name}_64x36.npz"))["beauty"]
        check(imgs[name].max() > 0, f"features smoke {name} black")
        _image_agree(f"features {name} vs CPU golden", imgs[name], golden)


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
    _profile("800x450@32spp fused features", inputs, _features_cfg(800, 450, 32))


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


def _probe_p1(results: dict) -> None:
    """P1 on the probe's 262,144 rays, each variant through its entry
    (`run`) with the counts read around it, against its plain version
    grouped per warp, timed, with its operation bound; full against K1."""
    import torch

    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa

    dev = torch.device("cuda")
    scene = _showcase(8, 8)[0]
    tab = pa.scene_tables(scene)
    od = pa.make_rays(pa.P, 0, dev)
    # The SASS of each variant: the work the probe takes away is gone, and
    # only that work (FFMA: the dots; MUFU: the epilogues' sqrt/rcp).
    sass = {name: ops for name, ops in sass_opcodes("probe_a1_ablate").items()
            if "ablate_kernel" in name}
    ops = {v: next(o for name, o in sass.items() if f"ILi{i}E" in name)
           for i, v in enumerate(pa.VARIANTS)}
    for v, o in ops.items():
        log(f"  SASS ablate_kernel<{v}>: {sum(o.values())} instructions, "
            f"FFMA {o.get('FFMA', 0)}, MUFU {o.get('MUFU', 0)}, "
            f"FSETP {o.get('FSETP', 0)}")
    # 16-term dots for G = 2 + 4 + 6 outputs: 192 FMAs per primitive.
    check(ops["cheapepi"].get("FFMA", 0) >= 192, "cheapepi lost its dots")
    check(ops["nodots"].get("MUFU", 0) >= ops["full"].get("MUFU", 0),
          "nodots lost its epilogues")
    nbytes = pa.P * (6 * 4 + 3 * 4) + sum(
        4 * (c.numel() + b.numel()) for c, b in zip(*tab[:2]))
    for v in pa.VARIANTS:
        _reset_counters()
        entry = pa.run(v, od, *tab)
        launches = pa.ablate.launches
        check(launches > 0, f"P1 {v}: not launched")
        t = pa.ablate(od, 0.0, *tab, v)[0]
        ref = pa.ablate_plain(od, 0.0, *tab, v, pa.WARP)[0]
        torch.cuda.synchronize()
        stats = pa.compare(v, t, ref)
        log(f"  P1 {v} vs plain: {stats}")
        check(stats["ok"], f"P1 {v} disagrees with its plain version")
        if v == "full":
            t_full = t
            tk = k1.closest_hit(od, 0.0, k1.scan_tables(scene))[0]
            lanes = torch.nonzero(t != tk).flatten()
            for i in lanes[:8].tolist():
                log(f"    lane {i}: P1 full t {float(t[i]):.9g} K1 t "
                    f"{float(tk[i]):.9g}")
            log(f"  P1 full vs K1 at tmin 0: {lanes.numel()} lanes differ")
            check(lanes.numel() == 0, "P1 full differs from K1")
        ms = time_ms(f"P1 {v}", lambda: pa.ablate(od, 0.0, *tab, v))
        plain_ms = time_ms(f"P1 {v} plain", lambda: pa.ablate_plain(
            od, 0.0, *tab, v, pa.WARP), n=3, rounds=3)
        flops = p1_operations(od, t_full, tab, v)
        bound, by = bound_ms(nbytes, flops)
        log(f"  P1.{v}: {ms:.4f} ms/launch (entry {entry['ms']:.4f}), plain "
            f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
            f"{flops / pa.P:.0f} operations per ray), launches {launches}")
        check(ms >= bound, f"P1 {v} runs below its bound: work was dropped")
        results[f"P1.{v}"] = dict(
            name=f"P1.{v}", route="cuda",
            source="raytracer_project_tpu_torch/csrc/probe_a1_ablate.cu",
            replaces="tools/probe_a1_ablate.py:43", launches=launches,
            max_abs_err=stats["max_abs_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None)


def _probe_onehot(results: dict) -> None:
    """P2 and P4's five layouts at the pool's width: each through its entry
    (`main`) with the counts read around it, against the plain version on a
    random table and indices in [-2, n_rows + 2) (exact), timed there and
    at the probes' 8,192 lanes, beside index_select + add."""
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
            out = po.onehot_fetch(t, idx, table, n_out, mode)
            ref = po.onehot_fetch_plain(t, idx, table, n_out, mode)
            torch.cuda.synchronize()
            bad = sum(int((a != b).sum()) for a, b in zip(out, ref))
            check(bad == 0, f"{name} p={p}: {bad} values differ")
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
            fn = lambda: po.onehot_fetch(t, idx, table, n_out, mode)
            sizes[p] = dict(
                ms=time_ms(f"{name} p={p}", fn),
                plain_ms=time_ms(f"{name} plain p={p}", lambda: po.onehot_fetch_plain(
                    t, idx, table, n_out, mode), rounds=3),
                library_ms=time_ms(f"{name} library p={p}", lib),
                bound=bound_ms(p * (4 * (1 if plain else 2) + 4 * n_out)
                               + (0 if plain else table.numel() * 4)))
        r = sizes[P_MAIN]
        log(f"  {name}: exact at {P_MAIN} and 8192 lanes; {r['ms']:.5f} "
            f"ms/launch, plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.5f}, bound {r['bound'][0]:.5f} ms; at 8192: "
            f"{sizes[8192]['ms']:.5f}, library {sizes[8192]['library_ms']:.5f},"
            f" bound {sizes[8192]['bound'][0]:.5f}; launches {launches}")
        results[name] = dict(
            name=name, route="cuda",
            source="raytracer_project_tpu_torch/csrc/probe_onehot.cu",
            replaces=("tools/probe_onehot.py:22" if name == "P2"
                      else "tools/probe_onehot2.py:52"),
            launches=launches, max_abs_err=0.0, ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"])


def _probe_decode(results: dict) -> None:
    """P3's stages d0-d2 and d3 (= K2) on K1's hits of the showcase camera
    rays at the pool's width: each through its entry (`run`) with the counts
    read around it, against its plain version, timed there and at the
    probe's 8,192 lanes, with its byte bound."""
    import torch

    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.tools import probe_decode as pd

    inputs = {p: pd.camera_hits(p) for p in (P_MAIN, 8192)}
    k2_int = (fs._RO_HIT, fs._RO_FRONT, fs._RO_MTYPE, fs._RO_GU, fs._RO_GV,
              fs._RO_HASB, fs._RO_TEXROW, fs._RO_BUMPROW, fs._RO_ENVROW)
    for v in ("d0", "d1", "d2", "d3"):
        _reset_counters()
        pd.run(v, *inputs[P_MAIN])
        counter = pd.decode_stage if v in pd.STAGES else fs.decode
        launches = counter.launches
        check(launches > 0, f"P3 {v}: not launched")
        if v in pd.STAGES:
            stage = pd.STAGES[v]
            plain = lambda tables, od, hit, ap: pd.decode_stage_plain(
                stage, tables, od, *hit)
            exact = (tuple(range(24)) if stage == 0 else
                     tuple(k for k in range(24) if k not in range(2, 11)
                           and k not in (12, 13)))
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
        plain_ms = time_ms(f"P3 {v} plain", lambda: plain(*inputs[P_MAIN]),
                           rounds=3)
        per_lane = (12 if v == "d0" else 36) + 4 * fs._RO_ROWS
        bound, by = bound_ms(P_MAIN * per_lane)
        log(f"  P3.{v}: {ms[P_MAIN]:.5f} ms/launch ({ms[8192]:.5f} at 8192 "
            f"lanes), plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by}, "
            f"{per_lane} B/lane), max |d| {err:.3g}, launches {launches}")
        results[f"P3.{v}"] = dict(
            name=f"P3.{v}", route="cuda",
            source=("raytracer_project_tpu_torch/csrc/probe_decode.cu"
                    if v in pd.STAGES else
                    "raytracer_project_tpu_torch/csrc/decode.cu"),
            replaces="tools/probe_decode.py:55", launches=launches,
            max_abs_err=err, ms=ms[P_MAIN], plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None)
    log("  P3 d3w4096 and d3u are d3 on the card (Mosaic tiling knobs)")


def _k1_split(od) -> None:
    """The dense scan's time split by P1's variants on the main path's own
    rays (the pool's bounce set, tmin T_MIN): full - cheapepi ~ the
    epilogues, full - nodots ~ the dots, nocull - full what the cull saves;
    with each variant's operations per ray, beside K1 (the compact-row
    scan, which P1 full and nocull equal on every lane). Logged only."""
    from raytracer_project_tpu_torch.core.constants import T_MIN
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa

    scene = _showcase(8, 8)[0]
    tab = pa.scene_tables(scene)
    scan = k1.scan_tables(scene)
    t_k1 = k1.closest_hit(od, T_MIN, scan)[0]
    ms = {"K1": time_ms("K1 (bounce set)", lambda: k1.closest_hit(
        od, T_MIN, scan))}
    for v in pa.VARIANTS:
        t = pa.ablate(od, T_MIN, *tab, v)[0]
        if v in ("full", "nocull"):
            n_diff = int((t != t_k1).sum())
            log(f"  P1 {v} vs K1 on the bounce set: {n_diff} lanes differ")
            check(n_diff == 0, f"P1 {v} differs from K1 on the bounce set")
        ms[v] = time_ms(f"P1 {v} (bounce set)", lambda: pa.ablate(
            od, T_MIN, *tab, v))
        flops = p1_operations(od, t_k1, tab, v)
        log(f"  P1 {v} on the bounce set: {ms[v]:.4f} ms/launch "
            f"({ms[v] / ms['K1']:.3f} of K1), {flops / od.shape[1]:.0f} "
            f"operations per ray")
    f = ms["full"]
    log(f"  dense scan split ({od.shape[1]} bounce lanes; K1 {ms['K1']:.4f} "
        f"ms): full {f:.4f} ms; "
        f"full - cheapepi {f - ms['cheapepi']:.4f} ms "
        f"({(f - ms['cheapepi']) / f:.3f}, ~epilogues); full - nodots "
        f"{f - ms['nodots']:.4f} ms ({(f - ms['nodots']) / f:.3f}, ~dots); "
        f"nocull - full {ms['nocull'] - f:.4f} ms "
        f"({(ms['nocull'] - f) / f:.3f}, what the cull saves)")


def phase_probes(results: dict, main_rays) -> None:
    """The four TPU probes' twins: P1 (K1 ablations, also split on the main
    path's bounce rays `main_rays`), P2/P4 (one-hot row fetch layouts), P3
    (decode bisection)."""
    log("probes:")
    _probe_p1(results)
    _k1_split(main_rays)
    _probe_onehot(results)
    _probe_decode(results)


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
    phase_k4(results)
    phase_smoke()
    phase_full(results)
    phase_chunked_smoke()
    phase_chunked_full(results)
    phase_k3_features(results)
    phase_features_smoke()
    phase_features_full(results)
    phase_probes(results, ray_sets["bounce"])
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
