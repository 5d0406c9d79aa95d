#!/usr/bin/env python3
"""The kernel table's timer for the PyTorch/CUDA port
(raytracer_project_tpu_torch): the numbers of PERF.md's kernel table.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels (csrc/*.cu, nvcc in parallel), logs each
kernel's registers, spills and stack frame (nvcc -Xptxas -v) and a summary
of its SASS, then times each kernel of the table on its path's inputs with
`tools.time_ms` (CUDA events around 20 launches behind a device sleep, the
median of 5 rounds), beside its plain PyTorch version and its bound (the
larger of the bytes it must move over the H100's bandwidth and its f32
operations over the f32 peak, both from benchmark.roofline). Before it
times a kernel it holds the kernel's output on those inputs against its
plain version's under the card tests' budgets (tools/agree.py), and
writes what the check found (max_abs_err) into the kernel's entry:

  K1  closest_hit's tile scan on the showcase's 131,072 bounce lanes (the
      pool's first camera rays one plain step on) and on the funnel's (one
      scatter of its 800x450 camera rays), split by P1's variants on both;
  K2  decode on the showcase's bounce lanes (P3's d3; on no render path);
  K3  the unfused shade_advance and K3 fused (shade_accumulate): beauty,
      features (the fog showcase, every AOV, both split passes, spec
      lanes) and K3 fused on a pixel window;
  K4  closest_hit_feats on the 360,000 bounce lanes of the 800x450
      showcase and of the funnel;
  S   the pool's start (initial_state) at 131,072 and 90,000 lanes;
  B   the BVH closest hit on the funnel's 131,072 bounce lanes beside K1's
      tile scan, on the showcase's with the threshold lowered, and the
      walk at each leaf size (tools/bench_bvh.walk_sweep);
  P1  the ablation probe's four variants on its 262,144 rays;
  P2, P4  the one-hot fetch in its six layouts at 131,072 and 8,192
      lanes, as its entry chooses, in place and staged, beside
      index_select + add;
  P3  the decode stages d0-d2 and d3 (= K2) at 131,072 and 8,192 lanes;
  the launch floor, an empty kernel over 131,072 and 8,192 lanes, with the
      small kernels' shares of their bounds with and without it;

and counts the launches in one frame of each path (800x450 @ 32 spp: the
fused pool's beauty and features frames, the chunked path's frame, the
funnel's frame, with each kernel's device ms a launch in the fused pool's
frames by the profiler; then pixel windows in threads, one NCCL rank,
distinct cards where the machine has two or more, the front end, the
unfused pool, the differentiable chunked path and two processes in a gloo
group). Then the JSON lines {"launches": {...}} and {"kernels": [...]},
the nvidia-smi line, and the device's JSON line with "ok". Takes no
arguments; exits non-zero without a CUDA device or where a kernel is off
its budget.

The card's tests of the port as a whole are

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
    python -m raytracer_project_tpu_torch.utils.smoke
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
W, H = 800, 450
P_MAIN = 131_072
P_SMALL = 8192
P_PROBE = 262_144
SPP = 32
CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
              defocus_angle=0.0, focus_dist=10.0)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)
FUNNEL_KW = dict(n_spheres=8192, mesh_detail=2, with_bvh=False)
# f32 operations of one K1 epilogue with its compare against the running
# best, counted from csrc/closest_hit.cu (sphere_epi, tri_epi, box_epi).
EPILOGUE_OPS = (15, 12, 35)
_T0 = time.perf_counter()


def _counters() -> dict:
    """Kernel name -> (wrapper, attribute holding its launch count). The
    wrapper of closest_hit counts the BVH kernel's launches too
    ("bvh_closest_hit")."""
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs

    return {"start_kernel": (fs.initial_state, "launches"),
            "closest_hit": (k1.closest_hit, "launches"),
            "bvh_closest_hit": (k1.closest_hit, "bvh_launches"),
            "decode": (fs.decode, "launches"),
            "shade_advance": (fs.shade_accumulate, "launches"),
            "shade_advance_features": (fs.shade_accumulate,
                                       "features_launches"),
            "shade_advance_unfused": (fs.shade_advance, "launches"),
            "closest_hit_feats": (k1.closest_hit_feats, "launches")}


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(name: str, fn, n: int = 20, rounds: int = 5) -> float:
    """tools.time_ms of fn on DEVICE, logged with its host-bound rounds."""
    from raytracer_project_tpu_torch import tools

    ms = tools.time_ms(fn, DEVICE, n, rounds)
    hb = tools.time_ms.host_bound
    log(f"  time {name}: {ms:.5f} ms/call ({n} calls x {rounds} rounds"
        f"{f', {hb} host-bound' if hb else ''})")
    return ms


def bound_ms(nbytes: int, flops: int = 0):
    """(the least ms for `nbytes` moved and `flops` f32 operations on the
    H100, which of the two bounds it)."""
    from benchmark.roofline import PEAK_BYTES_PER_S, PEAK_F32_FLOPS

    by, fl = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(by, fl) * 1e3, "operations" if fl > by else "bytes"


# --- operation counts of the closest hits ------------------------------------

def k1_operations(od, t_hit, tab, dots=True, cull=True) -> int:
    """f32 operations that the closest hit of the rays od f32[6, P] needs on
    the dense tables tab = (coeffs, MM_FINE-wide AABBs, counts)
    (`fine_tables`): for each ray, each 128-primitive tile it reaches no
    later than its closest hit t_hit (every tile without `cull`), and in
    each such tile 2 per nonzero coefficient (one FMA of the dot; none
    without `dots`) plus one epilogue per primitive."""
    import torch

    from raytracer_project_tpu_torch.ops import intersect

    coeffs, bounds, counts = tab
    width = intersect.MM_FINE
    o, d = od[:3], od[3:]
    inv_d = 1.0 / torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)
    total = 0
    for i, (bnd, n) in enumerate(zip(bounds, counts)):
        for c, c0 in enumerate(range(0, n, width)):
            w = min(width, n - c0)
            work = (2 * int(torch.count_nonzero(coeffs[i][:, :, c0:c0 + w]))
                    * dots + EPILOGUE_OPS[i] * w)
            if not cull:
                total += od.shape[1] * work
                continue
            lo, hi = bnd[c, :3, None], bnd[c, 3:, None]
            t0, t1 = (lo - o) * inv_d, (hi - o) * inv_d
            tn = torch.minimum(t0, t1).amax(0)
            tf = torch.maximum(t0, t1).amin(0)
            reach = (tn <= tf) & (tf > 0) & (tn <= t_hit)
            total += int(reach.sum()) * work
    return total


def fine_tables(scene, scan):
    """(the dense coefficient tables, their MM_FINE-wide AABBs, counts): the
    finest tiles a cull could skip, on which `k1_operations` counts."""
    mm = scene.mm
    return (scan.coeffs, (mm.sphere_bounds, mm.tri_bounds, mm.box_bounds),
            scan.counts)


def p1_operations(od, t_full, tab, variant: str) -> int:
    """f32 operations of P1 `variant` on the rays od with every ray culled
    on its own over the 128-wide tiles of tab (`fine_tables`): full as K1
    (its closest hit t_full); nocull every tile; nodots the epilogues of
    every tile a ray reaches (its best t stays T_MAX); cheapepi the dots of
    the tiles a ray reaches before its own running minimum of raw group-0
    dots, tile by tile in scan order."""
    import torch

    from raytracer_project_tpu_torch.ops import intersect

    if variant != "cheapepi":
        return k1_operations(od, t_full if variant == "full" else
                             torch.full_like(t_full, 1e30), tab,
                             dots=variant != "nodots", cull=variant != "nocull")
    width = intersect.MM_FINE
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


def k1_bytes(lanes: int, per_lane: int, scan) -> int:
    """Bytes a closest hit of `lanes` rays moves: `per_lane` a ray (its
    input and its hit) and the compact rows and tile AABBs once."""
    return lanes * per_lane + sum(4 * (r.numel() + b.numel())
                                  for r, b in zip(scan.rows, scan.bounds))


# --- the inputs of the paths ----------------------------------------------------

def _view(width=None, height=None):
    """The showcase's camera (W x H unless given) and sun on DEVICE."""
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv

    return (tcam.make_camera(image_width=width or W, image_height=height or H,
                             **CAM_KW).to(DEVICE),
            tenv.make_environment(**ENV_KW).to(DEVICE))


def _showcase(width=None, height=None, **scene_kw):
    from raytracer_project_tpu_torch.models import presets

    return (presets.showcase_scene(**scene_kw).to(DEVICE),
            *_view(width, height))


def _funnel():
    from raytracer_project_tpu_torch import bench
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.models import presets

    return (presets.bvh_stress_scene(**FUNNEL_KW).to(DEVICE),
            tcam.make_camera(image_width=W, image_height=H,
                             **bench.FUNNEL_CAM).to(DEVICE),
            tenv.make_environment(**ENV_KW).to(DEVICE))


def _scatter_rays(scene, cam):
    """The chunked path's bounce rays of the W x H frame, made by its own
    functions: one scatter of the camera rays (seed 0) at their first hits;
    (o, d) f32[W * H, 3] each, and what each lane left: (idx, type, hit)
    of its first hit."""
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.ops import intersect, shade

    pix = torch.arange(W * H, device=DEVICE)
    lr = rng.lane_rng(rng.seed_from_int(0), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, W)
    first = intersect.intersect(scene, o, d, 1e-3, intersect.hit_tables(scene))
    sc = shade.scatter(scene, intersect.make_record(scene, o, d, first), d, lr)
    return (sc.origin.contiguous(), sc.direction.contiguous(),
            (first.prim_idx, first.prim_type, first.hit))


def _step_params(n: int | None = None, spp: int = 32, **kw):
    """StepParams of a W-wide pool render of n pixels (W x H unless given)
    at spp samples (seed 0, depth 10, the sun); with split passes (kw) a
    spec lane for each beauty lane."""
    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.ops import fused_step as fs

    spec = kw.get("use_reflection") or kw.get("use_refraction")
    n = n or W * H
    return fs.StepParams(seed=rng.seed_from_int(0), sample_offset=0,
                         n_pixels=n, width=W,
                         total_work=n * spp * (2 if spec else 1),
                         max_depth=10, env_mode=tenv.PHYSICAL_SUN,
                         n_beauty=n * spp, **kw)


def _bounce_state(tables, cam, aparams, bparams, sp):
    """K3's inputs one step into the pool: the camera rays of its first
    P_MAIN work items (global pixel ids from sp.pixel_offset; with split
    passes every other lane a spec lane of the same pixel), one plain step
    on. Returns (state_f, state_i, next_work, segments) and K1's hits of
    the state's rays."""
    import torch

    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs

    w = torch.arange(P_MAIN, device=DEVICE)
    spec = sp.want_spec
    item = w // 2 if spec else w
    li = (sp.pixel_offset + item % sp.n_pixels).to(torch.int32)
    samp = (item // sp.n_pixels).to(torch.int32)
    o, d = tcam.generate_rays_soa(cam, rng.LaneRng(
        sp.seed, rng.u32(li), rng.u32(samp), 0), li, W)
    ones, zeros = torch.ones(P_MAIN, device=DEVICE), torch.zeros_like(li)
    rows_f = [*o, *d, ones, ones, ones, 0 * ones, 0 * ones, 0 * ones]
    rows_i = [torch.ones_like(li), zeros, samp, li]
    if spec:
        rows_f += [ones, ones, ones]
        rows_i += [(w % 2).to(torch.int32), zeros, zeros]
    state_f, state_i = (torch.stack(rows_f).contiguous(),
                        torch.stack(rows_i).contiguous())
    next_work = torch.tensor([P_MAIN], dtype=torch.int32, device=DEVICE)
    segments = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    rec = fs.decode_plain(tables, state_f[:6], *k1.closest_hit_plain(
        state_f[:6], 1e-3, tables.scan.coeffs, tables.scan.counts), aparams)
    step = fs.shade_advance_plain(tables, rec, state_f, state_i, next_work,
                                  segments, bparams, sp)
    state = (step[0].contiguous(), step[1].contiguous(), step[4], step[5])
    return state, k1.closest_hit(state[0][:6].contiguous(), 1e-3, tables.scan)


def _k3_fused_bytes(tables, hits, state, aparams, bparams, sp) -> tuple:
    """(bytes K3 fused must move, each input byte counted once: the state
    rows in and out, K1's t, idx and type, the table rows these hits read
    (packed primitive rows, material and texture-metadata tables, texel,
    bump-delta and HDR rows, volume rows) and 4 B per accumulator add; the
    adds: one per channel of each lane whose target in that channel is a
    pixel, from the unfused plain step)."""
    import torch

    from raytracer_project_tpu_torch.ops import fused_step as fs

    sf, si, nw, seg = state
    t, idx, typ = hits
    n_s, n_t, _ = tables.scan.counts
    base = torch.where(typ == 1, n_s, torch.where(typ == 2, n_s + n_t, 0))
    rows = torch.clamp(idx + base, 0, tables.rectab.shape[0] - 1)
    rec = fs.decode_plain(tables, sf[:6], *hits, aparams)
    tgt = fs.shade_advance_plain(tables, rec, sf, si, nw, seg, bparams, sp)[3]
    adds = sum(int((tgt[c] < sp.n_pixels).sum())
               for _, c in fs.acc_channels(sp))
    uniq = lambda x: int(torch.unique(x).numel())
    texel = uniq(torch.clamp(rec[fs._RO_TEXROW], min=0.0))
    bump = uniq(torch.clamp(rec[fs._RO_BUMPROW], min=0.0))
    env = uniq(rec[fs._RO_ENVROW]) if tables.env_hw is not None else 0
    table_bytes = 4 * (28 * uniq(rows) + tables.mattab.numel()
                       + tables.texmeta.numel() + 4 * texel + 2 * bump
                       + 4 * env + 16 * sp.n_volumes + 40 + 8)
    nf, ni = fs.state_rows(sp)
    return sf.shape[1] * (4 * 2 * (nf + ni) + 12) + table_bytes + 4 * adds, adds


def _entry(name, source, replaces, ms, plain_ms, nbytes, flops=0, *,
           max_abs_err, **kw):
    """One kernel entry of the JSON line, logged: max_abs_err is what the
    kernel's check against its plain version (tools/agree.py, raising
    over its budget) returned on the same inputs."""
    bound, by = bound_ms(nbytes, flops)
    log(f"  {name}: {ms:.5f} ms/launch, plain {plain_ms:.4f} ms, bound "
        f"{bound:.5f} ms ({by}), {ms / bound:.1f}x the bound; within its "
        f"budget of its plain version, max |d| {max_abs_err:.3g}")
    return dict(name=name, route="cuda",
                source=f"raytracer_project_tpu_torch/csrc/{source}",
                replaces=replaces, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, max_abs_err=max_abs_err,
                library_ms=kw.pop("library_ms", None), **kw)


# --- K1, K2, K3, K4, S ------------------------------------------------------------

def time_main_path(results: dict):
    """K1, K2, the unfused K3 and K3 fused on the showcase's bounce lanes;
    returns K1's rays there (f32[6, P_MAIN])."""
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.tools import agree

    scene, cam, env = _showcase()
    tables = fs.build_tables(scene, env, tenv.PHYSICAL_SUN)
    aparams, bparams = fs._aparams(env, DEVICE), fs._bparams(cam, env, DEVICE)
    sp = _step_params()
    state, hits = _bounce_state(tables, cam, aparams, bparams, sp)
    od = state[0][:6].contiguous()
    log(f"main path: {P_MAIN} lanes, {int((state[1][0] > 0).sum())} live "
        f"after one step")
    pkg = "raytracer_project_tpu/ops"

    err = agree.hit_budgets(hits, k1.closest_hit_plain(
        od, 1e-3, tables.scan.coeffs, tables.scan.counts), name="K1")
    ms = time_ms("K1", lambda: k1.closest_hit(od, 1e-3, tables.scan))
    plain = time_ms("K1 plain", lambda: k1.closest_hit_plain(
        od, 1e-3, tables.scan.coeffs, tables.scan.counts), n=5, rounds=3)
    flops = k1_operations(od, hits[0], fine_tables(scene, tables.scan))
    results["closest_hit"] = _entry(
        "closest_hit", "closest_hit.cu", f"{pkg}/pallas_intersect.py:272", ms,
        plain, k1_bytes(P_MAIN, 36, tables.scan), flops, max_abs_err=err,
        operations_per_ray=flops / P_MAIN)

    rec = fs.decode(tables, od, *hits, aparams)
    err = agree.rows_agree(rec, fs.decode_plain(tables, od, *hits, aparams),
                           agree.RECORD_INT_ROWS, "K2")
    ms = time_ms("K2", lambda: fs.decode(tables, od, *hits, aparams))
    plain = time_ms("K2 plain", lambda: fs.decode_plain(tables, od, *hits,
                                                        aparams), rounds=3)
    results["decode"] = _entry("decode", "decode.cu",
                               f"{pkg}/fused_step.py:326", ms, plain,
                               P_MAIN * (6 * 4 + 3 * 4 + 24 * 4),
                               max_abs_err=err)

    err = agree.rows_agree(fs.shade_advance(tables, rec, *state, bparams, sp),
                           fs.shade_advance_plain(tables, rec, *state,
                                                  bparams, sp),
                           name="K3 unfused")
    ms = time_ms("K3 unfused", lambda: fs.shade_advance(tables, rec, *state,
                                                        bparams, sp))
    plain = time_ms("K3 unfused plain", lambda: fs.shade_advance_plain(
        tables, rec, *state, bparams, sp), rounds=3)
    unfused = dict(unfused_ms=ms, unfused_plain_ms=plain, unfused_bound_ms=bound_ms(
        P_MAIN * (24 * 4 + 16 * 4 + (4 + 2) * 4 + 16 * 4 + 4 * 4))[0],
        unfused_max_abs_err=err)
    # K3 fused on the third of four pixel windows of the frame: 131,072
    # lanes over 90,000 pixels, so two lanes of a pixel may finish in one
    # step, their adds summed in either order (3e-4).
    n_local = W * H // 4
    wsp = _step_params(n_local, pixel_offset=2 * n_local)
    wstate, whits = _bounce_state(tables, cam, aparams, bparams, wsp)
    window = _time_fused("shade_advance window", tables, whits, wstate,
                         aparams, bparams, wsp, acc_tol=3e-4)
    results["shade_advance"] = _time_fused(
        "shade_advance", tables, hits, state, aparams, bparams, sp, **unfused,
        window_ms=window["ms"], window_plain_ms=window["plain_ms"],
        window_bound_ms=window["bound_ms"],
        window_max_abs_err=window["max_abs_err"])
    return od


def _time_fused(name, tables, hits, state, aparams, bparams, sp,
                lane_budget=0, acc_tol=1e-5, **kw):
    """K3 fused on these inputs, checked against its plain version
    (`agree.fused_step`, all but lane_budget lanes) and timed beside it,
    with its byte bound; acc and steps grow in place over the timed
    calls."""
    import torch

    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.tools import agree

    err, _ = agree.fused_step(tables, hits, state, aparams, bparams, sp,
                              lane_budget, name, acc_tol)
    acc = fs.new_accumulator(sp, DEVICE)
    steps = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    args = (tables, hits, *state, steps, aparams, bparams, sp, acc)
    ms = time_ms(name, lambda: fs.shade_accumulate(*args))
    plain = time_ms(f"{name} plain", lambda: fs.shade_accumulate_plain(*args),
                    rounds=3)
    nbytes, adds = _k3_fused_bytes(tables, hits, state, aparams, bparams, sp)
    return _entry(name, "shade_advance.cu",
                  "raytracer_project_tpu/ops/fused_step.py:669", ms, plain,
                  nbytes, variant="fused", bytes_per_lane=nbytes / P_MAIN,
                  adds=adds, max_abs_err=err, **kw)


def time_features(results: dict) -> None:
    """K3's variant with fog, the three AOVs and both split passes, unfused
    and fused, on the fog showcase's bounce lanes (every other lane a spec
    lane; a sample chunk of 23 spp, AOVs on the first 32)."""
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.tools import agree

    scene, cam, env = _showcase(use_fog=True)
    tables = fs.build_tables(scene, env, tenv.PHYSICAL_SUN)
    aparams, bparams = fs._aparams(env, DEVICE), fs._bparams(cam, env, DEVICE)
    sp = _step_params(spp=23, aux=32, z_max=50.0, aovs=fs.AOVS,
                      use_reflection=True, use_refraction=True,
                      n_volumes=scene.volumes.count)
    state, hits = _bounce_state(tables, cam, aparams, bparams, sp)
    rec = fs.decode(tables, state[0][:6].contiguous(), *hits, aparams)
    # A lane may flip a fog flight on an ulp of the card's logf: at most
    # 0.5% of the pool, as the card test holds it.
    out = fs.shade_advance(tables, rec, *state, bparams, sp)
    ref = fs.shade_advance_plain(tables, rec, *state, bparams, sp)
    differ = int(agree.differing_lanes(out[:4], ref[:4]).sum())
    agree.check(differ <= P_MAIN // 200 and int(out[5]) == int(ref[5]),
                f"K3 unfused features: {differ} lanes differ")
    ms = time_ms("K3 unfused features", lambda: fs.shade_advance(
        tables, rec, *state, bparams, sp))
    plain = time_ms("K3 unfused features plain", lambda: fs.shade_advance_plain(
        tables, rec, *state, bparams, sp), rounds=3)
    n_c, n_t = fs.output_rows(sp)
    nf, ni = fs.state_rows(sp)
    # Record rows, state in and out, texel words, contributions, targets.
    unfused = bound_ms(P_MAIN * 4 * (fs._RO_ROWS + 2 * (nf + ni) + 6 + n_c
                                     + n_t))[0]
    results["shade_advance_features"] = _time_fused(
        "shade_advance_features", tables, hits, state, aparams, bparams, sp,
        P_MAIN // 200, unfused_ms=ms, unfused_plain_ms=plain,
        unfused_bound_ms=unfused, unfused_lanes_differ=differ)


def time_start(results: dict) -> None:
    """The pool's start in one launch (start_kernel) at the main path's
    pool (800x450 @ 32 spp, 131,072 lanes) and the preview's (400x225 @ 1
    spp, 90,000 lanes), with the byte bound of what it writes."""
    from raytracer_project_tpu_torch.core import rng
    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.tools import agree

    out = {}
    for label, (w, h, spp) in (("main", (W, H, 32)),
                               ("preview", (W // 2, H // 2, 1))):
        cam, env = _view(w, h)
        n = w * h
        p = fs.pool_size(integrator.RenderConfig(
            width=w, height=h, samples_per_pixel=spp, max_depth=10,
            use_albedo=False, use_normal=False, use_z_depth=False), n * spp)
        sp = fs.StepParams(
            seed=rng.seed_from_int(1), sample_offset=0, n_pixels=n, width=w,
            total_work=n * spp, max_depth=10, env_mode=tenv.PHYSICAL_SUN,
            n_beauty=n * spp)
        bparams = fs._bparams(cam, env, DEVICE)
        got = fs.initial_state(cam, bparams, sp, p)
        err = agree.same_bits(got, fs.initial_state_plain(cam, sp, p, DEVICE),
                              f"start_kernel {label}")
        nbytes = sum(t.numel() * t.element_size() for t in got)
        out[label] = _entry(
            "start_kernel", "shade_advance.cu",
            "raytracer_project_tpu/ops/fused_step.py:1283",
            time_ms(f"start_kernel {label}",
                    lambda: fs.initial_state(cam, bparams, sp, p)),
            time_ms(f"start_kernel {label} plain",
                    lambda: fs.initial_state_plain(cam, sp, p, DEVICE)),
            nbytes, lanes=p, bytes=nbytes, max_abs_err=err)
    results["start_kernel"] = dict(
        out["main"], **{f"preview_{k}": v for k, v in out["preview"].items()
                        if k in ("ms", "plain_ms", "bound_ms", "lanes",
                                 "bytes", "max_abs_err")})


def time_k4(results: dict):
    """K4 on the 360,000 bounce lanes of the 800x450 showcase; returns the
    showcase's bounce rays (o, d)."""
    from raytracer_project_tpu_torch.ops import closest_hit as k1

    scene, cam, _ = _showcase()
    tables = k1.scan_tables(scene)
    o, d, left = _scatter_rays(scene, cam)
    results["closest_hit_feats"] = _time_k4(scene, tables, o, d, left, "")
    return o, d


def _time_k4(scene, tables, o, d, left, label, graze=False):
    """K4 on the bounce rays (o, d), checked against its plain version:
    the hit budgets, near-origin hits (and with `graze` grazing ones)
    held to the 3% budget only."""
    import torch

    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import intersect
    from raytracer_project_tpu_torch.tools import agree

    feats = intersect.ray_feature_rows(o, d).contiguous()
    odd = int((~torch.isfinite(feats[:13]).all(0)).sum())
    got = k1.closest_hit_feats(feats, 1e-3, tables)
    want = k1.closest_hit_feats_plain(feats, 1e-3, tables.coeffs,
                                      tables.counts)
    near = agree.near_origin(left, got, want[0])
    if graze:
        near |= agree.grazing(scene, o, d, *got)
    err = agree.hit_budgets(got, want, near, f"K4{label}")
    ms = time_ms(f"K4{label}", lambda: k1.closest_hit_feats(feats, 1e-3,
                                                            tables))
    plain = time_ms(f"K4{label} plain", lambda: k1.closest_hit_feats_plain(
        feats, 1e-3, tables.coeffs, tables.counts), n=1, rounds=2)
    od = torch.cat([o.T, d.T]).contiguous()
    flops = k1_operations(od, got[0], fine_tables(scene, tables))
    return _entry("closest_hit_feats", "closest_hit.cu",
                  "raytracer_project_tpu/ops/pallas_intersect.py:228", ms,
                  plain, k1_bytes(od.shape[1], 16 * 4 + 3 * 4, tables), flops,
                  max_abs_err=err, operations_per_ray=flops / od.shape[1],
                  non_finite_lanes=odd)


# --- the funnel: K1, K4 and B ---------------------------------------------------

def time_funnel(results: dict, showcase_rays) -> None:
    """K1's tile scan and K4 on the funnel's bounce lanes (K1 on the first
    131,072, the pool's width) and K1's split by P1 there; B, the BVH
    closest hit, on the same 131,072 lanes over the tree the pool builds,
    beside the tile scan, and on the showcase's bounce lanes with the
    threshold lowered; the walk at each leaf size on the funnel's lanes."""
    import torch

    from raytracer_project_tpu_torch.models import environment as tenv
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.ops import intersect
    from raytracer_project_tpu_torch.tools import agree, bench_bvh

    scene, cam, env = _funnel()
    tables = k1.scan_tables(scene)
    o, d, left = _scatter_rays(scene, cam)
    log(f"funnel: {scene.primitive_count} primitives {tables.counts}")
    k4 = _time_k4(scene, tables, o, d, left, " funnel", graze=True)
    results["closest_hit_feats"].update(
        {f"funnel_{k}": k4[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "operations_per_ray",
                                        "max_abs_err")})
    od = torch.cat([o.T, d.T])[:, :P_MAIN].contiguous()
    o1, d1 = o[:P_MAIN], d[:P_MAIN]
    left = tuple(x[:P_MAIN] for x in left)
    # K1 and the BVH kernel against their plain versions: near-origin and
    # grazing hits held to the 3% budget only.
    near = lambda got, t_ref: (agree.near_origin(left, got, t_ref)
                               | agree.grazing(scene, o1, d1, *got))
    got = k1.closest_hit(od, 1e-3, tables)
    want = k1.closest_hit_plain(od, 1e-3, tables.coeffs, tables.counts)
    k1_err = agree.hit_budgets(got, want, near(got, want[0]), "K1 funnel")
    ms = time_ms("K1 funnel", lambda: k1.closest_hit(od, 1e-3, tables))
    plain = time_ms("K1 funnel plain", lambda: k1.closest_hit_plain(
        od, 1e-3, tables.coeffs, tables.counts), n=1, rounds=2)
    flops = k1_operations(od, got[0], fine_tables(scene, tables))
    bound, by = bound_ms(k1_bytes(P_MAIN, 36, tables), flops)
    log(f"  K1 funnel: {ms:.4f} ms/launch, plain {plain:.2f} ms, bound "
        f"{bound:.4f} ms ({by}, {flops / P_MAIN:.0f} operations per ray)")
    results["closest_hit"].update(
        funnel_ms=ms, funnel_plain_ms=plain, funnel_bound_ms=bound,
        funnel_bound_by=by, funnel_operations_per_ray=flops / P_MAIN,
        funnel_max_abs_err=k1_err)
    results["closest_hit"]["split"]["funnel"] = _k1_split(
        "funnel bounce set", od, scene, tables)

    scan = fs.build_tables(scene, env, tenv.PHYSICAL_SUN).scan
    tree = scan.bvh
    log(f"bvh: {tree.node_count} nodes ({tree.nodes.shape[0]} records), "
        f"depth {tree.depth}, leaves of up to {tree.tree.leaf_size}, built "
        f"in {tree.build_ms:.1f} ms")
    walks_before = k1.closest_hit.bvh_launches
    got = k1.closest_hit(od, 1e-3, scan)
    agree.check(k1.closest_hit.bvh_launches == walks_before + 1,
                "B funnel: the BVH kernel was not launched")
    vs_k1 = agree.against_k1(got, k1.closest_hit(od, 1e-3, tables),
                             "B funnel vs K1")
    want = k1.bvh_closest_hit_plain(od, 1e-3, tree)
    err = agree.hit_budgets(got, want, near(got, want[0]), "B funnel")
    ms = time_ms("B funnel", lambda: k1.closest_hit(od, 1e-3, scan))
    plain = time_ms("B funnel plain", lambda: k1.bvh_closest_hit_plain(
        od, 1e-3, tree), n=1, rounds=2)
    entry = _entry("bvh_closest_hit", "bvh_hit.cu", None, ms, plain,
                   P_MAIN * 36 + sum(4 * r.numel() for r in scan.rows),
                   max_abs_err=err, vs_k1=vs_k1,
                   k1_ms=results["closest_hit"]["funnel_ms"],
                   nodes=tree.node_count, depth=tree.depth,
                   leaf_size=tree.tree.leaf_size, build_ms=tree.build_ms)
    walks = bench_bvh.walk_sweep(scene, od, scan)
    for row in walks:
        diff = row["vs_k1"]
        agree.check(diff["t_bits_differ"] == 0
                    and diff["hit_flips"] <= P_MAIN // 100
                    and diff["winner_flips"] <= P_MAIN // 40,
                    f"B's walk at leaf {row['leaf_size']}: {diff}")
        log(f"  walk at leaf {row['leaf_size']} ({row['nodes']} nodes, "
            f"{row['records']} records, depth {row['depth']}): "
            f"{row['ms']:.4f} ms, visits {row['visits']:.2f}, pushes "
            f"{row['pushes']:.2f}, culled pops {row['culled_pops']:.2f}, "
            f"slots {row['slots']:.2f}")
    entry["walks"] = walks

    show = _showcase(with_bvh=False)[0]
    orig = intersect.BVH_MIN_PRIMS
    intersect.BVH_MIN_PRIMS = show.primitive_count
    try:
        sscan = fs.build_tables(show, env, tenv.PHYSICAL_SUN).scan
    finally:
        intersect.BVH_MIN_PRIMS = orig
    sod = torch.cat([showcase_rays[0].T,
                     showcase_rays[1].T])[:, :P_MAIN].contiguous()
    agree.against_k1(k1.closest_hit(sod, 1e-3, sscan), k1.closest_hit(
        sod, 1e-3, sscan._replace(bvh=None)), "B showcase vs K1")
    entry["showcase"] = dict(
        ms=time_ms("B showcase", lambda: k1.closest_hit(sod, 1e-3, sscan)),
        k1_ms=time_ms("K1 showcase (tile scan)", lambda: k1.closest_hit(
            sod, 1e-3, sscan._replace(bvh=None))),
        nodes=sscan.bvh.node_count, depth=sscan.bvh.depth)
    results["bvh_closest_hit"] = entry


# --- the probes P1-P4 and the launch floor --------------------------------------

def _k1_split(label: str, od, scene, tables) -> dict:
    """K1's time split by P1's variants on rays od of a render path (tmin
    1e-3): full - cheapepi ~ the epilogues, full - nodots ~ the dots with
    their staging, nocull - full what the cull saves, each as a share of
    K1's ms."""
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.tools import agree
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa

    t_k1 = k1.closest_hit(od, 1e-3, tables)[0]
    for v in ("full", "nocull"):
        agree.check(agree.finite_t_equal(pa.ablate(od, 1e-3, tables, v)[0],
                                         t_k1, od),
                    f"P1 {v} differs from K1 on the {label}")
    fine = fine_tables(scene, tables)
    ms = {"K1": time_ms(f"K1 ({label})", lambda: k1.closest_hit(
        od, 1e-3, tables))}
    for v in pa.VARIANTS:
        ms[v] = time_ms(f"P1 {v} ({label})", lambda: pa.ablate(
            od, 1e-3, tables, v))
        log(f"  P1 {v} ({label}): {ms[v] / ms['K1']:.3f} of K1, "
            f"{p1_operations(od, t_k1, fine, v) / od.shape[1]:.0f} "
            f"operations per ray")
    f = ms["full"]
    shares = {"epilogues": (f - ms["cheapepi"]) / ms["K1"],
              "dots": (f - ms["nodots"]) / ms["K1"],
              "cull_saves": (ms["nocull"] - f) / ms["K1"]}
    log(f"  K1 split ({label}, {od.shape[1]} lanes, K1 {ms['K1']:.4f} ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    return dict(lanes=od.shape[1], ms=ms, shares=shares)


def time_probes(results: dict, main_rays) -> None:
    """P1's variants on the probe's rays and K1's split by them on the
    showcase's bounce lanes; P2/P4's fetch in each layout and P3's stages
    at 131,072 and 8,192 lanes; the launch floor under them."""
    import torch

    from raytracer_project_tpu_torch import tools
    from raytracer_project_tpu_torch.ops import closest_hit as k1
    from raytracer_project_tpu_torch.ops import fused_step as fs
    from raytracer_project_tpu_torch.tools import agree
    from raytracer_project_tpu_torch.tools import probe_a1_ablate as pa
    from raytracer_project_tpu_torch.tools import probe_decode as pd
    from raytracer_project_tpu_torch.tools import probe_onehot as po

    scene = _showcase(8, 8)[0]
    tables = k1.scan_tables(scene)
    od = pa.make_rays(P_PROBE, 0, DEVICE)
    t_full = pa.ablate(od, 0.0, tables, "full")[0]
    fine = fine_tables(scene, tables)
    rows = sum(4 * (r.numel() + b.numel())
               for r, b in zip(tables.rows, tables.bounds))
    t_k1 = k1.closest_hit(od, 0.0, tables)[0]
    for v in pa.VARIANTS:
        ops = p1_operations(od, t_full, fine, v)
        t = pa.ablate(od, 0.0, tables, v)[0]
        stats = pa.compare(v, t, pa.ablate_plain(
            od, 0.0, tables.coeffs, tables.bounds, tables.counts, v)[0])
        agree.check(stats["ok"], f"P1 {v} against its plain version: {stats}")
        agree.check(v not in ("full", "nocull")
                    or agree.finite_t_equal(t, t_k1, od),
                    f"P1 {v} differs from K1")
        results[f"P1.{v}"] = _entry(
            f"P1.{v}", "probe_a1_ablate.cu", "tools/probe_a1_ablate.py:43",
            time_ms(f"P1 {v}", lambda: pa.ablate(od, 0.0, tables, v)),
            time_ms(f"P1 {v} plain", lambda: pa.ablate_plain(
                od, 0.0, tables.coeffs, tables.bounds, tables.counts, v),
                n=3, rounds=3),
            P_PROBE * (6 * 4 + 3 * 4) + (0 if v == "nodots" else rows), ops,
            max_abs_err=stats["max_abs_err"], operations_per_ray=ops / P_PROBE)
    results["closest_hit"]["split"] = {"showcase": _k1_split(
        "showcase bounce set", main_rays, scene, tables)}

    n_rows, n_out = 1536, 24
    for name, mode in [("P2", "col")] + [(f"P4.{m}", m) for m in po.MODES]:
        plain, transposed, _ = po.MODES[mode]
        sizes = {}
        for p in (P_MAIN, P_SMALL):
            t, idx, table = po.make_inputs(n_rows, p, transposed, seed=1,
                                           device=DEVICE)
            fetch = lambda **kw: po.onehot_fetch(t, idx, table, n_out, mode,
                                                 **kw)
            ref = po.onehot_fetch_plain(t, idx, table, n_out, mode)
            for kw in [{}] + ([] if plain else [dict(staged=False),
                                                dict(staged=True)]):
                agree.same_bits(fetch(**kw), ref, f"{name} {kw} p={p}")
            # The library's fetch: index_select of the table with a zero
            # row appended, indices mapped beforehand (outside: that row),
            # then the add of t; it fetches all 28 columns.
            row = idx.to(torch.int32).long()
            row = torch.where((row >= 0) & (row < n_rows), row, n_rows)
            if plain:
                ks = torch.arange(n_out, device=DEVICE,
                                  dtype=torch.float32)[:, None]
                lib = lambda: torch.add(t, ks)
            elif transposed:
                tab1 = torch.cat([table, table.new_zeros(28, 1)], 1)
                lib = lambda: torch.index_select(tab1, 1, row).add_(t)
            else:
                tab1 = torch.cat([table, table.new_zeros(1, 28)])
                lib = lambda: torch.index_select(tab1, 0, row).add_(t[:, None])
            sizes[p] = dict(
                ms=time_ms(f"{name} p={p}", fetch),
                in_place_ms=None if plain else time_ms(
                    f"{name} in place p={p}", lambda: fetch(staged=False)),
                staged_ms=None if plain else time_ms(
                    f"{name} staged p={p}", lambda: fetch(staged=True)),
                plain_ms=time_ms(f"{name} plain p={p}", lambda: po.onehot_fetch_plain(
                    t, idx, table, n_out, mode), rounds=3),
                library_ms=time_ms(f"{name} library p={p}", lib),
                nbytes=p * (4 * (1 if plain else 2) + 4 * n_out)
                + (0 if plain else table.numel() * 4))
        r, r8 = sizes[P_MAIN], sizes[P_SMALL]
        results[name] = _entry(
            name, "probe_onehot.cu", "tools/probe_onehot.py:22" if name == "P2"
            else "tools/probe_onehot2.py:52", r["ms"], r["plain_ms"],
            r["nbytes"], max_abs_err=0.0, library_ms=r["library_ms"],
            in_place_ms=r["in_place_ms"], staged_ms=r["staged_ms"],
            ms_8192=r8["ms"], bound_ms_8192=bound_ms(r8["nbytes"])[0])

    inputs = {p: pd.camera_hits(p, DEVICE) for p in (P_MAIN, P_SMALL)}
    for v in ("d0", "d1", "d2", "d3"):
        if v in pd.STAGES:
            plain = lambda tables, od, hit, ap: pd.decode_stage_plain(
                pd.STAGES[v], tables, od, *hit)
            exact = agree.stage_exact_rows(pd.STAGES[v])
        else:
            plain = lambda tables, od, hit, ap: fs.decode_plain(
                tables, od, *hit, ap)
            exact = agree.RECORD_INT_ROWS
        err = max(agree.rows_agree(pd.variant_fn(v, *args)(), plain(*args),
                                   exact, f"P3 {v} p={p}")
                  for p, args in inputs.items())
        ms = {p: time_ms(f"P3 {v} p={p}", pd.variant_fn(v, *args))
              for p, args in inputs.items()}
        per_lane = (12 if v == "d0" else 36) + 4 * fs._RO_ROWS
        results[f"P3.{v}"] = _entry(
            f"P3.{v}", "probe_decode.cu" if v in pd.STAGES else "decode.cu",
            "tools/probe_decode.py:55", ms[P_MAIN],
            time_ms(f"P3 {v} plain", lambda: plain(*inputs[P_MAIN]),
                    rounds=3),
            P_MAIN * per_lane, max_abs_err=err, ms_8192=ms[P_SMALL],
            bound_ms_8192=bound_ms(P_SMALL * per_lane)[0])

    floor = {p: time_ms(f"empty kernel over {p} lanes",
                        lambda p=p: tools.launch_floor(p))
             for p in (P_MAIN, P_SMALL)}
    for key, r in results.items():
        if key in ("decode", "shade_advance", "P2") or key.startswith(
                ("P3.", "P4.")):
            less = r["bound_ms"] / max(r["ms"] - floor[P_MAIN], 1e-6)
            r.update(launch_floor_ms=floor[P_MAIN],
                     launch_floor_8192_ms=floor[P_SMALL],
                     share=r["bound_ms"] / r["ms"], share_less_floor=less)
            log(f"  {key}: {r['ms']:.5f} ms/launch, {r['share']:.3f} of it "
                f"the bound; less the floor {r['ms'] - floor[P_MAIN]:.5f} "
                f"ms, {less:.3f}")


# --- launches per frame ----------------------------------------------------------

def _device_kernels(fn) -> dict:
    """{kernel name: (device ms, launches)} over one call of fn, from a
    torch.profiler trace of the device (empty when the trace holds none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = out.get(ev.name, (0.0, 0))
            out[ev.name] = (ms + (ev.time_range.end - ev.time_range.start)
                            / 1e3, count + 1)
    return out


def _zero(counter) -> None:
    for fn, attr in counter.values():
        setattr(fn, attr, 0)


def _read(counter) -> dict:
    """Each counter's launches since `_zero`; closest_hit's are the tile
    scan's alone (its wrapper counts the BVH kernel's too)."""
    got = {k: getattr(*v) for k, v in counter.items()}
    got["closest_hit"] -= got["bvh_closest_hit"]
    return got


def count_launches(results: dict) -> dict:
    """The launches of each kernel in one frame of each path, read around
    the render with the counters zeroed just before it. For the kernels'
    entries, at 800x450 @ 32 spp with each kernel's device ms a launch
    there by the profiler, whose count of each kernel's launches must equal
    its counter's: the fused pool's beauty frame of the showcase
    (the start, K1, K3 fused; K2 and the unfused K3 none), its features
    frame (the fog showcase, every AOV, both split passes), the chunked
    path's frame with its AOVs (K4; untraced), and the funnel's beauty
    frame (B). Then, untraced, the paths around them (`_path_frames`).
    Returns {frame: {kernel: launches}} of every frame, kernels with none
    left out."""
    import dataclasses

    import torch

    from raytracer_project_tpu_torch.ops import integrator

    counter = _counters()
    beauty = integrator.RenderConfig(
        width=W, height=H, samples_per_pixel=SPP, max_depth=10,
        use_albedo=False, use_normal=False, use_z_depth=False)
    features = dataclasses.replace(
        beauty, use_albedo=True, use_normal=True, use_z_depth=True,
        use_reflection=True, use_refraction=True)
    frames = (
        ("fused beauty", _showcase(), beauty,
         {"start_kernel": "start_kernel", "closest_hit": "tile_scan_kernel",
          "shade_advance": "shade_kernel", "decode": None,
          "shade_advance_unfused": None}),
        ("fused features", _showcase(use_fog=True), features,
         {"shade_advance_features": "shade_kernel"}),
        ("chunked", _showcase(),
         dataclasses.replace(features, wavefront=False),
         {"closest_hit_feats": None}),
        ("funnel", _funnel(), beauty,
         {"bvh_closest_hit": "bvh_hit_kernel"}))
    paths = {}
    for label, (scene, cam, env), cfg, names in frames:
        _zero(counter)
        render = lambda: integrator.render(scene, cam, env, 1, cfg,
                                           device=DEVICE)["beauty"].cpu()
        # The chunked frame's ~10^5 small torch kernels would take minutes
        # to trace: its launches are counted untraced.
        kernels = (_device_kernels(render) if any(names.values())
                   else (render(), {})[1])
        launches = _read(counter)
        paths[label] = {k: v for k, v in launches.items() if v}
        log(f"{label} frame: launches {paths[label]}")
        for name, tag in names.items():
            key = "shade_advance" if name == "shade_advance_unfused" else name
            field = ("unfused_launches" if name == "shade_advance_unfused"
                     else "main_path_launches" if name == "decode"
                     else "launches")
            results[key][field] = launches[name]
            got = [v for k, v in kernels.items() if tag and tag in k]
            if got:
                ms, n = sum(v[0] for v in got), sum(v[1] for v in got)
                results[key]["frame_ms_per_launch"] = ms / n
                log(f"  {tag} in the frame: {ms / n:.4f} ms a launch over "
                    f"{n} launches (profiler)")
                if n != launches[name]:
                    # The fused pool's captured steps count a replay's
                    # launches from the capture: the trace holds the
                    # launches made.
                    raise RuntimeError(
                        f"{label} frame: {launches[name]} {name} launches "
                        f"counted, {n} {tag} launches in the trace")
    for label, render in _path_frames(beauty):
        _zero(counter)
        launches = render()
        torch.cuda.synchronize()
        launches = launches or _read(counter)
        paths[label] = {k: v for k, v in launches.items() if v}
        log(f"{label} frame: launches {paths[label]}")
    return paths


def _path_frames(beauty):
    """(label, render) of one frame of each path around the fused pool's
    frames, each a call that renders it (and returns the launches where
    they are counted in other processes): the showcase's 800x450 @ 32 spp
    frame over four pixel windows of the card, each in a thread of its
    own; as a process group of one NCCL rank with two windows; over a mesh
    of the machine's distinct cards (two or more); through the front end,
    `render` of cli.main in chunks of 4 spp; on the unfused pool; the
    chunked path's differentiable frame (64x36 @ 8 spp, tests/goldens'
    showcase); and two processes in a gloo group on one card, each
    rendering its window of a 256x144 @ 8 spp frame (`_gloo_rank`)."""
    import dataclasses
    import socket
    import tempfile

    import torch

    from raytracer_project_tpu_torch import cli, diff
    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.parallel import distributed
    from raytracer_project_tpu_torch.parallel import render as prender
    from raytracer_project_tpu_torch.tools import goldens

    scene, cam, env = _showcase()

    def port() -> int:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            return sock.getsockname()[1]

    def one_nccl_rank():
        torch.distributed.init_process_group(
            "nccl", init_method=f"tcp://localhost:{port()}", world_size=1,
            rank=0)
        try:
            distributed.render_distributed(scene, cam, env, 1, beauty,
                                           device=f"{DEVICE}:0",
                                           per_process=2)
        finally:
            torch.distributed.destroy_process_group()

    def front_end():
        with tempfile.TemporaryDirectory() as out:
            argv = ["render", "--preset", "showcase", "--width", str(W),
                    "--height", str(H), "--spp", str(SPP), "--max-depth",
                    "10", "--chunk", "4", "--device", DEVICE, "--out", out,
                    "--quiet"]
            if cli.main(argv) != 0:
                raise RuntimeError("cli render failed")

    def unfused_pool():
        old = os.environ.get("RAYTRACER_TPU_NO_FUSED")
        os.environ["RAYTRACER_TPU_NO_FUSED"] = "1"
        try:
            integrator.render(scene, cam, env, 1, beauty, device=DEVICE)
        finally:
            if old is None:
                os.environ.pop("RAYTRACER_TPU_NO_FUSED")
            else:
                os.environ["RAYTRACER_TPU_NO_FUSED"] = old

    def differentiable():
        gs, gc, ge, cfg = goldens.golden_config("showcase")
        diff.render_beauty(diff.RenderState(gs.to(DEVICE), gc, ge), 0,
                           dataclasses.replace(cfg, differentiable=True),
                           device=DEVICE)

    def two_processes() -> dict:
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as out:
            ctx = mp.start_processes(
                _gloo_rank, args=(2, f"tcp://localhost:{port()}", out),
                nprocs=2, join=False, start_method="spawn")
            deadline = time.perf_counter() + 300
            while not ctx.join(timeout=1):
                if time.perf_counter() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise RuntimeError("the two ranks did not finish")
            ranks = [json.load(open(os.path.join(out, f"{r}.json")))
                     for r in range(2)]
        return {k: sum(r[k] for r in ranks) for k in ranks[0]}

    def windows(mesh):
        prender.render_sharded(scene, cam, env, 1, beauty, mesh)

    frames = [("4 windows in threads",
               lambda: windows(prender.make_mesh(4, DEVICE))),
              ("one NCCL rank", one_nccl_rank)]
    if torch.cuda.device_count() > 1:
        frames.append(("distinct cards",
                       lambda: windows(prender.make_mesh())))
    else:
        log("distinct cards: one card here, so no frame of that path")
    return frames + [("front end (cli render)", front_end),
                     ("unfused pool", unfused_pool),
                     ("differentiable chunked", differentiable),
                     ("two processes (gloo)", two_processes)]


def _gloo_rank(rank: int, world: int, init: str, out: str) -> None:
    """One rank of a gloo group of `world` processes on cuda:0: its window
    of the 256x144 @ 8 spp showcase, gathered; writes its launches to
    out/<rank>.json."""
    import torch

    from raytracer_project_tpu_torch.ops import integrator
    from raytracer_project_tpu_torch.parallel import distributed

    if not distributed.init_distributed(num_processes=world,
                                        process_id=rank, init_method=init,
                                        backend="gloo"):
        raise RuntimeError("no process group")
    try:
        counter = _counters()
        _zero(counter)
        scene, cam, env = _showcase(256, 144)
        distributed.render_distributed(
            scene, cam, env, 6, integrator.RenderConfig(
                width=256, height=144, samples_per_pixel=8, max_depth=10,
                use_albedo=False, use_normal=False, use_z_depth=False),
            device=f"{DEVICE}:0")
        torch.cuda.synchronize()
        with open(os.path.join(out, f"{rank}.json"), "w") as f:
            json.dump(_read(counter), f)
    finally:
        torch.distributed.destroy_process_group()


# --- the build and the code ------------------------------------------------------

def log_code() -> None:
    """Each kernel's SASS in brief beside its registers, spills and stack
    frame."""
    from raytracer_project_tpu_torch import kernels, tools

    for source in kernels.SOURCES:
        for name, (ops, res) in sorted(tools.kernel_code(source, "").items()):
            log(f"  SASS {name[:90]}: {sum(ops.values())} instructions, "
                f"{res[0]} registers, {res[1]} B spilled, {res[2]} B stack; "
                + ", ".join(f"{op} {ops.get(op, 0)}" for op in (
                    "LDG", "STG", "LDL", "STL", "BRA", "FFMA", "MUFU",
                    "FSETP", "LDGSTS", "LDS", "BAR", "VOTE")))


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
    log_code()
    results: dict = {}
    main_rays = time_main_path(results)
    time_features(results)
    time_start(results)
    showcase_rays = time_k4(results)
    time_probes(results, main_rays)
    time_funnel(results, showcase_rays)
    paths = count_launches(results)
    print(json.dumps({"launches": paths}), flush=True)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
