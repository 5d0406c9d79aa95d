"""Time the fused pool's step and its kernels at bench shapes (twin of the
repository's tools/prof_fused_step.py).

    python -m raytracer_project_tpu_torch.tools.prof_fused_step \
        [--device cpu] [--width 800] [--height 450] [--spp 23]

Runs the fused pool (ops/fused_step.py render_pool_fused) on the showcase
at 800x450, one sample chunk of 23 spp, depth 10, beauty, and takes the
state after two warm steps; then times on that state with `tools.time_ms`
(REPS calls a round): the whole step (K1, then K3 fused with its
respawn), K1 alone, and K3 fused with its respawn. On the card the time
is the device's, and a profiler pass over the K3 calls splits that row
into K3 fused's shade kernel and the respawn kernel; on the CPU it is the
host clock. Prints the reference's
`name  ms` lines on stderr.

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


class _Captured(Exception):
    pass


def capture_step(scene, cam, env, config, device, warm: int = 2):
    """(tables, the K1 arguments, the K3 fused arguments) of the fused
    pool's step `warm` + 1 of a render of `config` on `device`: the render
    runs `warm` steps and stops before the next."""
    from ..ops import fused_step as fs

    orig = fs.shade_accumulate
    seen = []

    def spy(*args):
        if len(seen) == warm:
            seen.append(args)
            raise _Captured
        seen.append(None)
        return orig(*args)

    # shade_accumulate counts its launches on the function its module
    # names: the spy while it stands in, handed back to it afterwards.
    spy.launches, spy.features_launches = orig.launches, orig.features_launches
    fs.shade_accumulate = spy
    try:
        fs.render_pool_fused(scene.to(device), cam.to(device),
                             env.to(device), 0, config,
                             aux=config.aux_samples)
    except _Captured:
        pass
    finally:
        fs.shade_accumulate = orig
        orig.launches, orig.features_launches = (spy.launches,
                                                 spy.features_launches)
    if len(seen) <= warm:
        raise RuntimeError(f"the pool drained in {len(seen)} steps")
    args = seen[warm]
    tables, state_f = args[0], args[2]
    return tables, (state_f[:6].contiguous(), fs.T_MIN, tables.scan), args


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
    print("(the reference's A2, seam, B and scatter-add rows are all K3 "
          "fused here)", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
