"""Time the fused pool's step and its kernels at bench shapes (twin of the
repository's tools/prof_fused_step.py).

    python -m raytracer_project_tpu_torch.tools.prof_fused_step \
        [--device cpu] [--width 800] [--height 450] [--spp 23]

Starts a fused pool (ops/fused_step.py) on the showcase at 800x450, one
sample chunk of 23 spp, depth 10, beauty, and takes the state after two
warm steps; then times on that state with `tools.time_ms` (REPS calls a
round): the whole step (K1, then K3 fused with its respawn), K1 alone,
and K3 fused with its respawn. On the card the time is the device's, and
a profiler pass over the K3 calls splits that row into K3 fused's shade
kernel and the respawn kernel; on the CPU it is the host clock. Prints
the reference's `name  ms` lines on stderr.

Then `host_turns` reads the host's turn of the pool loop over TURN_CALLS
whole pool calls (render_pool_fused) of the same shape from the spans'
own records, in a trace of the host alone: the loop less its waits, per
turn; and counts the calls' steps and the graphs captured and replayed
over them (ops/step_graphs.py).

The reference's A2 (decode), seam (row gathers), B (shade-advance) and
scatter-add rows have no counterpart of their own: K3 fused does all four
in one kernel since its redesign, so they print as its one row.
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import time_ms


REPS = 10
# Traced pool calls whose host turns `host_turns` reads, after one warm.
TURN_CALLS = 20


def capture_step(scene, cam, env, config, device, warm: int = 2):
    """(tables, the K1 arguments, the K3 fused arguments) of the fused
    pool's step `warm` + 1 of a render of `config` on `device`: a pool
    call's set-up and start, and `warm` steps launched one by one."""
    from ..ops import closest_hit as k1
    from ..ops import fused_step as fs

    scene, cam, env = scene.to(device), cam.to(device), env.to(device)
    tables, aparams, bparams, sp, p = fs._pool_setup(
        scene, cam, env, 0, config, config.aux_samples)
    state_f, state_i, next_work, live, segments, steps = fs.initial_state(
        cam, bparams, sp, p)
    acc = fs.new_accumulator(sp, device)
    for _ in range(warm):
        hits = k1.closest_hit(state_f[:6], fs.T_MIN, tables.scan)
        state_f, state_i, next_work, segments, live, steps = (
            fs.shade_accumulate(tables, hits, state_f, state_i, next_work,
                                segments, steps, aparams, bparams, sp, acc))
    if int(live[0]) == 0:
        raise RuntimeError(f"the pool drained in {warm} steps")
    hits = k1.closest_hit(state_f[:6], fs.T_MIN, tables.scan)
    args = (tables, hits, state_f, state_i, next_work, segments, steps,
            aparams, bparams, sp, acc)
    return tables, (state_f[:6].contiguous(), fs.T_MIN, tables.scan), args


def host_turns(scene, cam, env, config, device,
               calls: int = TURN_CALLS) -> dict:
    """The pool loop's host time per turn over `calls` pool calls
    (render_pool_fused, one sample chunk each, seeds 1..calls) after one
    warm call, from the spans' records in a torch.profiler trace of the
    host: `pool.loop` less its `pool.wait`s, over the turns (`pool.launch`,
    the lag's no-op tail included). Also the calls' steps and the graphs
    captured and replayed over them."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import fused_step as fs
    from ..ops.step_graphs import cache as graphs

    scene, cam, env = scene.to(device), cam.to(device), env.to(device)
    render = lambda seed: fs.render_pool_fused(
        scene, cam, env, seed, config, aux=config.aux_samples,
        with_stats=True)[1]["steps"]
    render(0)
    before = (graphs.captured, graphs.replayed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps = sum(render(seed) for seed in range(1, calls + 1))
    ns = {"pool.loop": 0, "pool.wait": 0}
    turns = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in ns:
            ns[ev.name()] += int(ev.end_ns()) - int(ev.start_ns())
        turns += ev.name() == "pool.launch"
    out = {"calls": calls, "turns": turns, "steps": steps,
           "loop_ms": 1e-6 * ns["pool.loop"] / calls,
           "host_ms_per_turn": 1e-6 * (ns["pool.loop"]
                                       - ns["pool.wait"]) / turns,
           "captured": graphs.captured - before[0],
           "replayed": graphs.replayed - before[1]}
    return out


def _kernel_ms(fn, reps: int) -> dict:
    """Device ms per call by kernel name over `reps` calls of fn, from a
    torch.profiler trace (card only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            span = (ev.time_range.end - ev.time_range.start) / 1e3
            out[ev.name] = out.get(ev.name, 0.0) + span / reps
    return out


def main(argv=None) -> dict:
    """Print and return the rows {name: ms}."""
    from ..models import camera, environment, presets
    from ..ops import closest_hit as k1
    from ..ops import fused_step as fs
    from ..ops import integrator

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=450)
    ap.add_argument("--spp", type=int, default=23)
    args = ap.parse_args(argv)
    dev = integrator.resolve_device(args.device)
    w, h = args.width, args.height
    cfg = integrator.RenderConfig(
        width=w, height=h, samples_per_pixel=args.spp, max_depth=10,
        env_mode=environment.PHYSICAL_SUN, use_albedo=False,
        use_normal=False, use_z_depth=False, wavefront=True)
    scene = presets.showcase_scene(with_bvh=True, with_meshes=True)
    cam = camera.make_camera(image_width=w, image_height=h, vfov=30.0,
                             lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
    env = environment.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                       sun_intensity=6.0)
    _, k1_args, k3_args = capture_step(scene, cam, env, cfg, dev)
    print(f"lanes={k1_args[0].shape[1]}", file=sys.stderr)

    k1_fn = lambda: k1.closest_hit(*k1_args)
    k3_fn = lambda: fs.shade_accumulate(*k3_args)
    step = lambda: fs.shade_accumulate(k3_args[0], k1_fn(), *k3_args[2:])
    rows = {"full body step": time_ms(step, dev, REPS),
            "K1 closest_hit_od": time_ms(k1_fn, dev, REPS),
            "K3 fused + respawn": time_ms(k3_fn, dev, REPS)}
    if dev.type == "cuda":
        by_name = _kernel_ms(k3_fn, REPS)
        for label, tag in (("K3 fused shade_kernel (profiler)", "shade_kernel"),
                           ("respawn_kernel (profiler)", "respawn_kernel")):
            ms = [v for k, v in by_name.items() if tag in k]
            if ms:
                rows[label] = sum(ms)
            else:
                print(f"{label}: not measured (the trace holds no such "
                      f"kernel)", file=sys.stderr)
    for name, ms in rows.items():
        print(f"{name:34s} {ms:8.4f} ms", file=sys.stderr)
    turns = host_turns(scene, cam, env, cfg, dev, TURN_CALLS)
    rows["host per turn (spans)"] = turns["host_ms_per_turn"]
    print(f"{'host per turn (spans)':34s} "
          f"{turns['host_ms_per_turn']:8.4f} ms", file=sys.stderr)
    print("host turns " + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                                   else f"{k}={v}" for k, v in turns.items()),
          file=sys.stderr)
    print("(the reference's A2, seam, B and scatter-add rows are all K3 "
          "fused here)", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
