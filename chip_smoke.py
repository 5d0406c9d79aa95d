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
               oracle, and K4 against K1;
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


def k1_operations(od, t_hit, tables) -> int:
    """f32 operations that the closest hit of the rays od f32[6, P] needs on
    these tables: for each ray, each 512-primitive chunk whose AABB the ray
    reaches no later than its closest hit t_hit (the chunks no cull can
    skip), and in each such chunk 2 per nonzero coefficient (one FMA of the
    dot) plus one epilogue per primitive."""
    import torch

    o, d = od[:3], od[3:]
    inv_d = 1.0 / torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
    total = 0
    for coeff, bnd, n, epi in zip(tables.coeffs, tables.bounds, tables.counts,
                                  EPILOGUE_OPS):
        for c, c0 in enumerate(range(0, n, 512)):
            w = min(512, n - c0)
            work = 2 * int(torch.count_nonzero(coeff[:, :, c0:c0 + w])) + epi * w
            lo, hi = bnd[c, :3, None], bnd[c, 3:, None]
            t0, t1 = (lo - o) * inv_d, (hi - o) * inv_d
            tn = torch.minimum(t0, t1).amax(0)
            tf = torch.maximum(t0, t1).amin(0)
            reach = (tn <= tf) & (tf > 0) & (tn <= t_hit)
            total += int(reach.sum()) * work
    return total


def phase_kernels(results: dict) -> None:
    import numpy as np
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.ops import intersect

    dev = torch.device("cuda")
    scene = presets.showcase_scene().to(dev)
    cam = tcam.make_camera(image_width=800, image_height=450, **CAM_KW)
    env = tenv.make_environment(**ENV_KW)
    tables = fs.build_tables(scene, env, tenv.PHYSICAL_SUN)
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
        state_f[:6], 1e-3, tables.coeffs, tables.counts), aparams)
    step1 = fs.shade_advance_plain(tables, rec0, state_f, state_i, next_work,
                                   segments, bparams, sp)
    ray_sets = {"camera": state_f[:6].contiguous(),
                "bounce": step1[0][:6].contiguous()}
    log(f"kernels: {P_MAIN} lanes; bounce set live lanes "
        f"{int((step1[1][0] > 0).sum())}")

    # K1 against its plain version and against the exact oracle.
    k1_err = 0.0
    hits = {}
    for name, od in ray_sets.items():
        tk, ik, yk = k1.closest_hit(od, 1e-3, tables.coeffs, tables.bounds,
                                    tables.counts)
        tp, ip, yp = k1.closest_hit_plain(od, 1e-3, tables.coeffs,
                                          tables.counts)
        torch.cuda.synchronize()
        k1_err = max(k1_err, hit_agree(f"K1 vs plain ({name})", tk, ik, yk,
                                       tp, ip, yp))
        ob = intersect.intersect_brute(scene, od[:3].T.contiguous(),
                                       od[3:].T.contiguous(), 1e-3)
        hit_agree(f"K1 vs brute oracle ({name})", tk, ik, yk, ob.t,
                  ob.prim_idx, ob.prim_type)
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

    # Times at P = 131,072 on the bounce lanes.
    od = ray_sets["bounce"]
    t_k1 = time_ms("K1", lambda: k1.closest_hit(od, 1e-3, tables.coeffs,
                                                tables.bounds, tables.counts))
    t_k1p = time_ms("K1 plain", lambda: k1.closest_hit_plain(
        od, 1e-3, tables.coeffs, tables.counts), n=5, rounds=3)
    hb = hits["bounce"]
    t_k2 = time_ms("K2", lambda: fs.decode(tables, od, *hb, aparams))
    t_k2p = time_ms("K2 plain", lambda: fs.decode_plain(tables, od, *hb,
                                                        aparams), rounds=3)
    t_k3 = time_ms("K3", lambda: fs.shade_advance(tables, rec1, *state,
                                                  bparams, sp))
    t_k3p = time_ms("K3 plain", lambda: fs.shade_advance_plain(
        tables, rec1, *state, bparams, sp), rounds=3)

    # Bounds from this run's inputs (see PERF.md for the reckoning).
    k1_flops = k1_operations(od, hb[0], tables)
    log(f"  K1 operations: {k1_flops / P_MAIN:.0f} per ray on the bounce set")
    k1_bytes = P_MAIN * (6 * 4 + 3 * 4) + sum(
        4 * (c.numel() + b.numel()) for c, b in zip(tables.coeffs,
                                                    tables.bounds))
    k2_bytes = P_MAIN * (6 * 4 + 3 * 4 + 24 * 4)
    k3_bytes = P_MAIN * (24 * 4 + 16 * 4 + (4 + 2) * 4 + 16 * 4 + 4 * 4)
    bound = lambda by, fl=0: max(by / PEAK_BYTES_PER_S, fl / PEAK_F32_FLOPS) * 1e3
    pkg = "raytracer_project_tpu_torch"
    results.update({
        "closest_hit": dict(
            name="closest_hit", route="cuda", source=f"{pkg}/csrc/closest_hit.cu",
            replaces="raytracer_project_tpu/ops/pallas_intersect.py:272",
            max_abs_err=k1_err, ms=t_k1, plain_ms=t_k1p,
            bound_ms=bound(k1_bytes, k1_flops), bound_by="operations",
            library_ms=None),
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


def phase_k4(results: dict) -> None:
    """K4 on the chunked path's shapes: the 360,000 camera rays of the
    800x450 showcase and one scatter of them, made on the card by the
    chunked path's own functions."""
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.ops import intersect, shade

    dev = torch.device("cuda")
    scene = presets.showcase_scene().to(dev)
    cam = tcam.make_camera(image_width=800, image_height=450, **CAM_KW).to(dev)
    env = tenv.make_environment(**ENV_KW).to(dev)
    tables = fs.build_tables(scene, env, tenv.PHYSICAL_SUN)
    pix = torch.arange(P_CHUNKED, device=dev)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 800)
    first = intersect.intersect(scene, o, d, 1e-3)
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
        tk, ik, yk = k1.closest_hit_feats(feats, 1e-3, tables.coeffs,
                                          tables.bounds, tables.counts)
        tp, ip, yp = k1.closest_hit_feats_plain(feats, 1e-3, tables.coeffs,
                                                tables.counts)
        torch.cuda.synchronize()
        err = max(err, hit_agree(f"K4 vs plain ({name})", tk, ik, yk,
                                 tp, ip, yp, left))
        od = torch.cat([ro.T, rd.T]).contiguous()
        hit_agree(f"K4 vs K1 ({name})", tk, ik, yk,
                  *k1.closest_hit(od, 1e-3, tables.coeffs, tables.bounds,
                                  tables.counts), left)
        ob = intersect.intersect_brute(scene, ro.contiguous(), rd.contiguous(),
                                       1e-3)
        hit_agree(f"K4 vs brute oracle ({name})", tk, ik, yk, ob.t,
                  ob.prim_idx, ob.prim_type, left)
    # Times and the bound on the bounce set (the last one above).
    t_k4 = time_ms("K4", lambda: k1.closest_hit_feats(
        feats, 1e-3, tables.coeffs, tables.bounds, tables.counts))
    t_k4p = time_ms("K4 plain", lambda: k1.closest_hit_feats_plain(
        feats, 1e-3, tables.coeffs, tables.counts), n=3, rounds=3)
    flops = k1_operations(od, tk, tables)
    log(f"  K4 operations: {flops / P_CHUNKED:.0f} per ray on the bounce set")
    nbytes = P_CHUNKED * (16 * 4 + 3 * 4) + sum(
        4 * (c.numel() + b.numel()) for c, b in zip(tables.coeffs,
                                                    tables.bounds))
    bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3
    results["closest_hit_feats"] = dict(
        name="closest_hit_feats", route="cuda",
        source="raytracer_project_tpu_torch/csrc/closest_hit.cu",
        replaces="raytracer_project_tpu/ops/pallas_intersect.py:228",
        max_abs_err=err, ms=t_k4, plain_ms=t_k4p, bound_ms=bound,
        bound_by="operations", library_ms=None)
    log(f"  closest_hit_feats: {t_k4:.4f} ms/launch, plain {t_k4p:.4f} ms, "
        f"bound {bound:.4f} ms (operations)")


# --- phases 3 and 4 -----------------------------------------------------------

def _counters():
    """Kernel name -> (wrapper, attribute holding its launch count)."""
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs

    return {"closest_hit": (k1.closest_hit, "launches"),
            "decode": (fs.decode, "launches"),
            "shade_advance": (fs.shade_advance, "launches"),
            "shade_advance_features": (fs.shade_advance, "features_launches"),
            "closest_hit_feats": (k1.closest_hit_feats, "launches")}


def _reset_counters():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _launches(names) -> dict:
    counters = _counters()
    return {k: getattr(*counters[k]) for k in names}


class _PlainCallCounter:
    """Counts calls of the plain versions while the render runs."""

    def __enter__(self):
        from raytracer_project_tpu_torch.ops import closest_hit as k1
        from raytracer_project_tpu_torch.ops import fused_step as fs

        self.calls = 0
        self.saved = [(k1, "closest_hit_plain"), (fs, "decode_plain"),
                      (fs, "shade_advance_plain"),
                      (k1, "closest_hit_feats_plain")]
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
    with _PlainCallCounter() as plain:
        cfg = _chunked_cfg(64, 36, 8, max_depth=6, aovs=False)
        out = integrator.render(scene, cam, env, 0, cfg)
        img = out["beauty"].cpu().numpy()
    launches = _launches(CHUNKED_KERNELS)
    log(f"chunked smoke: 64x36@8spp depth 6 launches {launches}, plain calls "
        f"{plain.calls}")
    check(all(v > 0 for v in launches.values()), "K4 was not launched")
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "showcase.npz"))["beauty"]
    check(img.max() > 0, "chunked smoke image black")
    _image_agree("64x36@8spp vs CPU golden showcase.npz", img, golden)

    scene = presets.showcase_scene()
    cam = tcam.make_camera(image_width=32, image_height=18, **CAM_KW)
    cfg = _chunked_cfg(32, 18, 4)
    with _PlainCallCounter() as plain:
        card = integrator.render(scene.to(dev), cam, env, 4, cfg)
        card = {k: v.cpu().numpy() for k, v in card.items()}
    check(plain.calls == 0, "a plain version ran during the CUDA render")
    t0 = time.perf_counter()
    cpu = integrator.render(scene, cam, env, 4, cfg, device="cpu")
    log(f"chunked smoke: 32x18@4spp, six buffers; CPU render "
        f"{time.perf_counter() - t0:.1f} s")
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
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    results: dict = {}
    phase_kernels(results)
    phase_k4(results)
    phase_smoke()
    phase_full(results)
    phase_chunked_smoke()
    phase_chunked_full(results)
    phase_k3_features(results)
    phase_features_smoke()
    phase_features_full(results)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
