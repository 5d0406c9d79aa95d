"""Two checkouts of the port timed in turns on one card.

    python -m raytracer_project_tpu_torch.tools.bench_turns PARENT_DIR [RUNS [CASE ...]]

PARENT_DIR is another checkout of the repository (for example the parent
commit unpacked with `git archive`); this checkout is the change. One
worker process per checkout imports its own package, builds its kernels
and renders each case once to warm up; the main process then asks them for
timed renders in turns, parent, change, change, parent, ..., RUNS of each
(5 by default), so that both see the same card, clocks and neighbours.
CASEs name the cases to time (all of them by default).

Cases (the port's render entry, `integrator.render`, on the card):
  showcase   the showcase, 800x450 @ 32 spp, depth 10, beauty (the fused
             main path of chip_smoke.py's phase full);
  full_fog   showcase_scene(use_fog=True), 800x450 @ 32 spp, depth 10,
             the three AOVs and both split passes (phase features full);
  config2    BASELINE config 2, the Cornell box with fog 0.002, 512x512 @
             64 spp, depth 8, solid black sky, beauty;
  f3_mesh    chip_smoke.py's frontend F3: a RenderSession over a mesh of
             cuda:0 listed 4 times, `render --preset showcase` at 800x450 @
             32 spp, depth 10, the AOVs on, in chunks of 4 spp.

A timed render is the wall of a synchronised `render(..., with_stats=True)`
(for f3_mesh, `render_progressive` and the session's buffers) whose beauty
is read back to the host. Prints one JSON line per render,
then one summary line (min, median, max wall per case and side), the
card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CASES = ("showcase", "full_fog", "config2", "f3_mesh")

_WORKER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from raytracer_project_tpu_torch import kernels
from raytracer_project_tpu_torch.models import camera, environment, presets
from raytracer_project_tpu_torch.ops import integrator

kernels.build_all()
CAM = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
           defocus_angle=0.0, focus_dist=10.0)
SUN = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)
OFF = dict(use_albedo=False, use_normal=False, use_z_depth=False)


def mesh_session():
    from raytracer_project_tpu_torch import cli
    from raytracer_project_tpu_torch.utils.session import RenderSession

    scene, cam_kw = cli._preset("showcase")
    cam = camera.make_camera(image_width=800, image_height=450,
                             defocus_angle=0.0, focus_dist=10.0, **cam_kw)
    cfg = integrator.RenderConfig(env_mode=environment.PHYSICAL_SUN, width=800,
                                  height=450, samples_per_pixel=32, max_depth=10)
    parts = (scene.to("cuda"), cam, environment.make_environment(), cfg)

    def run(seed):
        sess = RenderSession(*parts, key=seed, chunk_samples=4,
                             mesh=[torch.device("cuda", 0)] * 4, device="cuda")
        sess.render_progressive(cfg.samples_per_pixel)
        return sess.buffers()["beauty"], {"segments": sess.segments_traced,
                                          "steps": 0}
    return run


def case(name):
    dev = torch.device("cuda")
    if name == "f3_mesh":
        return mesh_session()
    if name == "config2":
        scene = presets.cornell_box_scene(with_fog=True, fog_density=0.002)
        cam = camera.make_camera(image_width=512, image_height=512, vfov=40.0,
                                 lookfrom=(278.0, 278.0, -800.0),
                                 lookat=(278.0, 278.0, 0.0))
        env = environment.make_environment(background_color=(0.0, 0.0, 0.0))
        cfg = integrator.RenderConfig(
            width=512, height=512, samples_per_pixel=64, max_depth=8,
            env_mode=environment.SOLID_COLOR, **OFF)
    else:
        fog = name == "full_fog"
        scene = presets.showcase_scene(use_fog=fog)
        cam = camera.make_camera(image_width=800, image_height=450, **CAM)
        env = environment.make_environment(**SUN)
        kw = (dict(use_reflection=True, use_refraction=True) if fog else OFF)
        cfg = integrator.RenderConfig(width=800, height=450,
                                      samples_per_pixel=32, max_depth=10, **kw)
    parts = (scene.to(dev), cam, env)

    def run(seed):
        out, stats = integrator.render(*parts, seed, cfg, with_stats=True)
        return out["beauty"], stats
    return run


runs = {}
for line in sys.stdin:
    name = line.strip()
    if name not in runs:
        runs[name] = case(name)
        runs[name](0)[0].cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beauty, stats = runs[name](1)
    beauty = beauty.cpu()
    wall = time.perf_counter() - t0
    print(json.dumps({"case": name, "wall_s": wall,
                      "segments": stats["segments"], "steps": stats["steps"],
                      "mean": float(beauty.mean())}), flush=True)
"""


def _worker(root: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", _WORKER, root], cwd=root,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)


def _ask(proc: subprocess.Popen, name: str) -> dict:
    proc.stdin.write(name + "\n")
    proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"worker ended without a result for {name}")
    return json.loads(line)


def main(parent: str, runs: int = 5, cases=CASES) -> dict:
    import torch

    if not set(cases) <= set(CASES):
        raise ValueError(f"unknown cases {sorted(set(cases) - set(CASES))}")
    if not torch.cuda.is_available():
        raise RuntimeError("bench_turns needs a CUDA device")
    change = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = {"parent": _worker(os.path.abspath(parent)),
             "change": _worker(change)}
    walls: dict = {}
    try:
        for name in cases:
            order = [("parent", "change", "change", "parent")[k % 4]
                     for k in range(2 * runs)]
            for side in order:
                r = _ask(procs[side], name)
                r["side"] = side
                print(json.dumps(r), flush=True)
                walls.setdefault(name, {}).setdefault(side, []).append(r)
    finally:
        for proc in procs.values():
            proc.stdin.close()
            proc.wait(timeout=120)
    summary = {}
    for name, sides in walls.items():
        summary[name] = {}
        for side, rs in sides.items():
            w = sorted(r["wall_s"] for r in rs)
            summary[name][side] = {
                "min_s": w[0], "median_s": w[len(w) // 2], "max_s": w[-1],
                "segments": sorted({r["segments"] for r in rs}),
                "steps": sorted({r["steps"] for r in rs})}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"summary": summary, "card": smi}), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:3]),
         *([sys.argv[3:]] if sys.argv[3:] else []))
