"""Command-line interface of the port: render / interactive / bench / info
(twin of raytracer_project_tpu/cli.py, with the same flags).

    python -m raytracer_project_tpu_torch render --preset showcase --spp 64
    python -m raytracer_project_tpu_torch render --scene-file scene.json \\
        --passes rgb,albedo,normals --out output/
    python -m raytracer_project_tpu_torch interactive
    python -m raytracer_project_tpu_torch bench
    python -m raytracer_project_tpu_torch info

Everything runs on the card (`--device cuda`, the default) and raises when
no CUDA device is present; `--device cpu` runs the kernels' plain PyTorch
versions on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

_PRESETS = ["showcase", "shirley", "cornell"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracer_project_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a scene to PNG passes")
    r.add_argument("--preset", default=None, choices=_PRESETS,
                   help="built-in scene (models/presets.py)")
    r.add_argument("--scene-file", default=None,
                   help="JSON scene document (models/sceneio.py schema)")
    r.add_argument("--width", type=int, default=None)
    r.add_argument("--height", type=int, default=None)
    r.add_argument("--spp", type=int, default=None,
                   help="samples per pixel (reference default 30)")
    r.add_argument("--max-depth", type=int, default=None)
    r.add_argument("--passes", default="rgb",
                   help="comma list: rgb,denoise,albedo,normals,"
                        "reflections,refractions,z_depth,all")
    r.add_argument("--out", default="output", help="output directory")
    r.add_argument("--checkpoint", default=None,
                   help="checkpoint file; written after the render and, with "
                        "--resume, restored before it")
    r.add_argument("--resume", action="store_true")
    r.add_argument("--chunk", type=int, default=4,
                   help="samples per progressive chunk")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card; "
                        "cpu runs the kernels' plain versions)")
    r.add_argument("--devices", type=int, default=None,
                   help="split pixel windows over this many devices "
                        "(default: 1; pass 0 for all visible CUDA devices; "
                        "under a process group, the cards of each process, "
                        "0 meaning 1)")
    r.add_argument("--quiet", action="store_true")
    r.add_argument("--watch", default=None, metavar="PNG",
                   help="progressive preview: rewrite this PNG with the "
                        "current post-processed beauty every ~150 ms of "
                        "render time and log a histogram line per update "
                        "(main.cpp:1538-1645 live-preview parity)")
    r.add_argument("--watch-interval", type=float, default=0.15,
                   help="minimum seconds between --watch updates "
                        "(reference cadence 150 ms, main.cpp:1556)")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render (CUDA "
                        "activity on the card, the port's spans as host "
                        "events of every thread: utils/spans.py) to "
                        "DIR/trace.json")
    r.add_argument("--check-numerics", action="store_true",
                   help="render one 1 spp chunked debug frame on the CPU "
                        "(the kernels' plain versions) under the NaN trap "
                        "before the real render (slow; small frames)")

    i = sub.add_parser(
        "interactive",
        help="adjust-while-rendering control loop (type `help` at the "
             "prompt; the reference's ImGui panel as a command channel)")
    i.add_argument("--preset", default="showcase", choices=_PRESETS)
    i.add_argument("--scene-file", default=None,
                   help="JSON scene; watched for edits between chunks")
    i.add_argument("--width", type=int, default=400)
    i.add_argument("--height", type=int, default=225)
    i.add_argument("--spp", type=int, default=30,
                   help="progressive target (camera.hpp:27 default)")
    i.add_argument("--chunk", type=int, default=2)
    i.add_argument("--seed", type=int, default=0)
    i.add_argument("--device", default="cuda")
    i.add_argument("--watch", default="output/preview.png", metavar="PNG",
                   help="live preview PNG (0.15 s cadence, main.cpp:1556)")

    b = sub.add_parser("bench", help="run the standard benchmark "
                                     "(raytracer_project_tpu_torch.bench)")
    b.add_argument("--spp", type=int,
                   help="BENCH_SPP for this run (bench's default: 32)")
    b.add_argument("--device",
                   help="BENCH_DEVICE for this run (bench's default: cuda)")

    sub.add_parser("info", help="torch, CUDA, devices, card, native library")
    return p


def _passes(arg: str):
    from .ops import post as post_mod
    from .utils.session import PASS_NAMES

    by_name = {v: k for k, v in PASS_NAMES.items()}
    if arg.strip() == "all":
        return [p for p in PASS_NAMES if p != post_mod.PASS_DENOISE]
    out = []
    for name in arg.split(","):
        name = name.strip()
        if name not in by_name:
            raise SystemExit(f"unknown pass '{name}'; "
                             f"choose from {sorted(by_name)} or 'all'")
        out.append(by_name[name])
    return out


def _preset(name: str):
    """(scene, camera keyword arguments) of a built-in scene."""
    from .models import presets

    if name == "shirley":
        return presets.shirley_final_scene(), dict(
            vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0))
    if name == "cornell":
        return presets.cornell_box_scene(), dict(
            vfov=40.0, lookfrom=(278.0, 278.0, -800.0),
            lookat=(278.0, 278.0, 0.0))
    return presets.showcase_scene(), dict(
        vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))


def _check_numerics(scene, cam, env, config, seed, log) -> None:
    """One 1 spp chunked frame under the NaN trap, on the CPU: the trap sees aten ops only, so the probe runs the kernels' plain
    versions, as the reference package's probe does."""
    import functools

    from .ops import integrator
    from .utils import debug as debug_mod

    log.debug("check-numerics: 1 spp chunked probe on the CPU (the "
              "kernels' plain versions) under the NaN trap")
    dbg_cfg = dataclasses.replace(config, samples_per_pixel=1, wavefront=False)
    debug_mod.checked(functools.partial(
        integrator.render, config=dbg_cfg, device="cpu"))(
            scene, cam, env, seed)
    log.debug("check-numerics pass clean (1 spp probe)")


def _cmd_render(args) -> int:
    from .models import camera as cam_mod
    from .models import environment as env_mod
    from .models import sceneio
    from .ops import integrator, post as post_mod
    from .utils import applog
    from .utils.session import PASS_NAMES, RenderSession

    log = applog.AppLog(echo=not args.quiet)
    dev = integrator.resolve_device(args.device)

    if args.scene_file:
        scene, cam, env, config = sceneio.load_scene_file(args.scene_file)
    else:
        scene, cam_kw = _preset(args.preset or "showcase")
        config = integrator.RenderConfig(env_mode=env_mod.PHYSICAL_SUN)
        env = env_mod.make_environment()
        cam = None  # built after config overrides below

    # CLI overrides.
    overrides = {}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.spp:
        overrides["samples_per_pixel"] = args.spp
    if args.max_depth:
        overrides["max_depth"] = args.max_depth
    pass_ids = _passes(args.passes)
    overrides["use_reflection"] = post_mod.PASS_REFLECTIONS in pass_ids
    overrides["use_refraction"] = post_mod.PASS_REFRACTIONS in pass_ids
    config = dataclasses.replace(config, **overrides)
    if cam is None:
        cam = cam_mod.make_camera(
            image_width=config.width, image_height=config.height,
            defocus_angle=0.0, focus_dist=10.0, **cam_kw)

    mesh = owners = None
    if args.devices is not None:
        from .parallel import distributed, render as prender

        # False for one process. Under a group each rank renders on cards
        # of its own (cuda:LOCAL_RANK, ...) unless --device names one.
        if distributed.init_distributed(device=dev):
            mesh, owners = distributed.make_global_mesh(
                distributed.local_devices(dev, args.devices or 1))
        elif dev.type == "cuda":
            mesh = prender.make_mesh(args.devices or None)
        else:
            mesh = prender.make_mesh(args.devices or 1, device=dev)
        log.system("Pixel windows split over %d device(s)", len(mesh))

    sess = RenderSession(scene, cam, env, config, log=log, key=args.seed,
                         chunk_samples=args.chunk, mesh=mesh, owners=owners,
                         device=dev)
    if args.resume and args.checkpoint:
        try:
            sess.restore(args.checkpoint)
        except (OSError, ValueError) as e:
            log.error("resume failed (%s); starting fresh", e)

    total = config.samples_per_pixel
    watch_state = {"last": 0.0}

    def progress(s):
        if args.watch and (time.perf_counter() - watch_state["last"]
                           >= args.watch_interval):
            # Throttled accumulator -> post -> file preview, the CLI twin
            # of the reference's 150 ms texture upload (main.cpp:1538-1645)
            # plus its histogram panel (main.cpp:1130-1165) as one line.
            from .utils import histview, image_io

            image_io.save_png(args.watch, s.display(post_mod.PASS_RGB))
            hist = histview.ascii_histogram(
                s.statistics(), target_luminance=float(
                    s.post_params.target_luminance))
            log.render("watch %s @ %d spp\n%s", args.watch, s.samples_done,
                       hist)
            watch_state["last"] = time.perf_counter()
        if args.quiet:
            return
        pct = 100.0 * s.progress(total)
        eta = s.eta_seconds(total)
        sys.stderr.write(
            f"\r[{pct:5.1f}%] {s.samples_done}/{total} spp  "
            f"ETA {eta:6.1f}s")
        sys.stderr.flush()

    if args.check_numerics:
        _check_numerics(scene, cam, env, config, args.seed, log)

    t0 = time.perf_counter()
    if args.profile:
        from torch.profiler import (
            ProfilerActivity, _ExperimentalConfig, profile)

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # Every thread's host events: a mesh renders its windows in
        # threads of their own (parallel/render.run_windows).
        every_thread = _ExperimentalConfig(profile_all_threads=True)
        with profile(activities=acts,
                     experimental_config=every_thread) as prof:
            sess.render_progressive(total, callback=progress)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        log.system("Profiler trace written to %s", trace)
    else:
        sess.render_progressive(total, callback=progress)
    if not args.quiet:
        sys.stderr.write("\n")
    dt = time.perf_counter() - t0
    log.render("Rendered %d spp in %.1fs (%.2f Mrays/s)", sess.samples_done,
               dt, applog.rays_per_second(config.width, config.height,
                                          sess.samples_done,
                                          config.max_depth, dt) / 1e6)

    if args.checkpoint:
        sess.checkpoint(args.checkpoint)
    for pid in pass_ids:
        path = os.path.join(args.out, f"render_{PASS_NAMES[pid]}.png")
        sess.save_render_pass(pid, path)
        print(path)
    return 0


def _cmd_bench(args) -> int:
    from . import bench

    # bench reads its settings from the environment, which its gate's
    # subprocess inherits: a flag given here wins, for this run only.
    flags = {"BENCH_SPP": args.spp, "BENCH_DEVICE": args.device}
    saved = {k: os.environ.get(k) for k in flags}
    os.environ.update({k: str(v) for k, v in flags.items() if v is not None})
    try:
        return bench.main()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _card_line() -> str | None:
    """`nvidia-smi`'s name and power limit of each card, or None."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip() or None


def _cmd_info() -> int:
    import torch

    from . import __version__, kernels, native

    cuda = torch.cuda.is_available()
    info = {
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "devices": (["cpu"] + [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                               for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
        "card": _card_line(),
        "native": native.available(),
        "kernels_build_dir": str(kernels.BUILD_DIR),
    }
    print(json.dumps(info, indent=2))
    return 0


def build_interactive(args):
    """The InteractiveLoop of `interactive`'s arguments."""
    from .models import environment as env_mod
    from .models import sceneio
    from .ops import integrator
    from .utils import applog
    from .utils.interactive import InteractiveLoop

    log = applog.AppLog(echo=True)
    camera_params = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0),
                         lookat=(0.0, 1.0, 0.0), defocus_angle=0.0,
                         focus_dist=10.0)
    if args.scene_file:
        scene, _, env, config = sceneio.load_scene_file(args.scene_file)
    else:
        scene, cam_kw = _preset(args.preset)
        camera_params.update(cam_kw)
        env = env_mod.make_environment()
        config = integrator.RenderConfig(env_mode=env_mod.PHYSICAL_SUN)
    config = dataclasses.replace(config, width=args.width,
                                 height=args.height,
                                 samples_per_pixel=args.spp)
    return InteractiveLoop(
        scene, env, config, camera_params, log=log, key=args.seed,
        chunk_samples=args.chunk, scene_file=args.scene_file,
        watch_png=args.watch, device=args.device)


def _cmd_interactive(args) -> int:
    loop = build_interactive(args)
    print(f"interactive: preview -> {args.watch}; type `help`",
          file=sys.stderr)
    loop.run()
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "render":
        return _cmd_render(args)
    if args.command == "interactive":
        return _cmd_interactive(args)
    if args.command == "bench":
        return _cmd_bench(args)
    return _cmd_info()


if __name__ == "__main__":
    sys.exit(main())
