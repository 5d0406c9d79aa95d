"""One run of one benchmark cell: set-up, a closed loop of one user for the
window, the check against the plain reference, and the result line.

A cell is an entry of BENCHMARK.json's `workloads`. Everything about it is
found by name: its configuration `configs/<config>.json` with the scene
generator `configs/<config>.py`, its traffic mix `traffic/<traffic>.json`,
its correctness limits `limits/<workload>.json`, and each per-layer metric's
reader `layer_metrics/<metric>.py`. Adding a configuration, a mix, a cell or
a metric adds files and entries; no file here names one.

The user renders frames of a scene progressively. Each frame is a new camera
pose on a turntable orbit around the configuration's `lookat` (the pose
order and the render keys come from the seed) and starts from zero samples.
On one card a frame is a `RenderSession` (the port's interactive and CLI
path: session -> integrator.accumulate_samples -> the fused pool), stepped
`update_spp` samples at a time until `frame_spp`; an update ends when the
averaged beauty buffer is on the host. With `ranks` > 1 a frame is one
`parallel/distributed.render_distributed` call, a rank per card on NCCL, and
ends when rank 0 holds the gathered frame on the host.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import multiprocessing
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# Top-level module names a run must never load (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_project_tpu")
# The traced run profiles whole frames from this many seconds into the
# window until TRACE_SECONDS have been traced, or the window ends.
TRACE_SKIP_S = 1.0
TRACE_SECONDS = 5.0
# A rank that waits this long on another gives up (it has died).
GROUP_TIMEOUT_S = 60


class Cell(NamedTuple):
    name: str
    cfg: dict            # configs/<config>.json
    generator: object    # configs/<config>.py: build(builder, cfg)
    traffic: dict        # traffic/<traffic>.json
    chips: int
    limits: dict         # limits/<workload>.json
    end_to_end: list     # BENCHMARK.json metric entries of this cell
    per_layer: list


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench: dict | None = None,
              root: Path = ROOT, traffic: dict | None = None) -> Cell:
    """The cell named `workload`, from BENCHMARK.json and the files named
    after its parts. `traffic` replaces the mix's file (tests run a cell at
    a size the CPU holds)."""
    bench = bench if bench is not None else _read_json(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    cfg_path = root / "configs" / f"{w['config']}.json"
    return Cell(
        name=workload,
        cfg=_read_json(cfg_path),
        generator=_module(cfg_path.with_suffix(".py"),
                          f"bench_config_{w['config']}"),
        traffic=traffic or _read_json(root / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        limits=_read_json(root / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def load_reader(metric: str, root: Path = ROOT):
    """The per-layer metric's reader: `read(ctx) -> float | None`."""
    return _module(root / "layer_metrics" / f"{metric}.py",
                   "bench_metric_" + metric.replace(".", "_"))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# What a run renders, from its seed
# ---------------------------------------------------------------------------

class Plan:
    """Frame poses and render keys, the pixels the check reads, and the
    frames it checks, all drawn from the seed. Every seed renders the same
    set of poses (the orbit's), starting at another one."""

    def __init__(self, cfg: dict, traffic: dict, seed: int):
        self.cfg, self.traffic = cfg, traffic
        self.width, self.height = int(traffic["width"]), int(traffic["height"])
        self.frame_spp = int(traffic["frame_spp"])
        self.update_spp = int(traffic["update_spp"])
        if self.frame_spp % self.update_spp:
            raise ValueError("frame_spp must be a multiple of update_spp")
        self.updates = self.frame_spp // self.update_spp
        orbit = traffic["orbit"]
        self.span, self.poses = float(orbit["span_deg"]), int(orbit["poses"])
        rng = np.random.default_rng(seed)
        self.pose0 = int(rng.integers(self.poses))
        self.key0 = int(rng.integers(1 << 30))
        n = self.width * self.height
        k = min(int(traffic["check"]["pixels"]), n)
        self.check_ids = np.sort(rng.choice(n, size=k, replace=False))
        self.check_frames = int(traffic["check"]["frames"])
        self._rng = rng

    def angle(self, frame: int) -> float:
        i = (self.pose0 + frame) % self.poses
        if self.span >= 360.0:
            return i * 360.0 / self.poses
        return -0.5 * self.span + (i + 0.5) * self.span / self.poses

    def camera(self, frame: int) -> dict:
        """The configuration's camera turned by the frame's angle about the
        vertical axis through `lookat`."""
        cam = dict(self.cfg["camera"])
        at = np.asarray(cam["lookat"], np.float64)
        rel = np.asarray(cam["lookfrom"], np.float64) - at
        a = np.deg2rad(self.angle(frame))
        c, s = np.cos(a), np.sin(a)
        rel = np.array([c * rel[0] + s * rel[2], rel[1], -s * rel[0] + c * rel[2]])
        cam["lookfrom"] = tuple(float(x) for x in at + rel)
        cam["lookat"] = tuple(float(x) for x in at)
        return cam

    def key(self, frame: int) -> int:
        return self.key0 + frame

    def frames_to_check(self, completed: list) -> list:
        k = min(self.check_frames, len(completed))
        return sorted(self._rng.choice(completed, size=k, replace=False).tolist())


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------

class Port:
    """The system under test, set up for a cell on `device`."""

    def __init__(self, cell: Cell, plan: Plan, device):
        import torch

        from raytracer_project_tpu_torch.models import environment
        from raytracer_project_tpu_torch.models.scene import SceneBuilder
        from raytracer_project_tpu_torch.ops import integrator

        self.torch = torch
        self.device = torch.device(device)
        b = SceneBuilder()
        cell.generator.build(b, cell.cfg)
        host_scene = b.build(with_bvh=False)
        self.counts = (host_scene.spheres.count, host_scene.triangles.count,
                       host_scene.boxes.count if host_scene.boxes is not None
                       else 0)
        self.n_materials = int(host_scene.materials.mtype.shape[0])
        self.n_volumes = (host_scene.volumes.count
                          if host_scene.volumes is not None else 0)
        self.scene = host_scene.to(self.device)
        e = dict(cell.cfg["environment"])
        mode = getattr(environment, e.pop("mode"))
        self.env = environment.make_environment(**e).to(self.device)
        self.config = integrator.RenderConfig(
            width=plan.width, height=plan.height,
            samples_per_pixel=plan.frame_spp,
            max_depth=int(cell.cfg["render"]["max_depth"]), env_mode=mode,
            use_albedo=False, use_normal=False, use_z_depth=False)

    def camera(self, cam_kw: dict):
        from raytracer_project_tpu_torch.models import camera

        return camera.make_camera(image_width=self.config.width,
                                  image_height=self.config.height, **cam_kw)

    def pool_lanes(self, spp: int) -> int:
        from raytracer_project_tpu_torch.ops import fused_step

        return fused_step.pool_size(self.config, self.config.n_pixels * spp)

    @staticmethod
    def launches() -> tuple:
        """(K1 launches, K3 fused launches) so far in this process."""
        from raytracer_project_tpu_torch.ops import closest_hit, fused_step

        k3 = fused_step.shade_accumulate
        return (closest_hit.closest_hit.launches,
                k3.launches + k3.features_launches)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)


def _span(tracing: bool, name: str):
    if not tracing:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


class Recorder:
    """The window's updates and the checked pixels of each finished frame."""

    def __init__(self, plan: Plan):
        self.plan = plan
        self.updates = []    # (frame, index, t_request, t_done, traced)
        self.frames = {}     # frame -> f32 [check pixels, 3] of its image
        self.counters = {"segments": 0, "steps": 0}
        self.traced_frames = []

    def update(self, frame, index, t0, t1, traced) -> None:
        self.updates.append((frame, index, t0, t1, traced))

    def finished(self, frame: int, image: np.ndarray) -> None:
        self.frames[frame] = np.asarray(
            image.reshape(-1, 3)[self.plan.check_ids], np.float32)


def _one_card_frame(port: Port, plan: Plan, frame: int, rec: Recorder | None,
                    deadline: float, tracing: bool, stats_hook) -> bool:
    """Render frame `frame` update by update; stop before an update that
    would start after `deadline`. True when the frame finished."""
    from raytracer_project_tpu_torch.utils.session import RenderSession

    cam = port.camera(plan.camera(frame))
    sess, image = None, None
    for u in range(plan.updates):
        t0 = time.perf_counter()
        if t0 >= deadline:
            return False
        with _span(tracing, "bench.update"):
            if sess is None:
                with _span(tracing, "bench.session"):
                    sess = RenderSession(port.scene, cam, port.env,
                                         port.config, key=plan.key(frame),
                                         chunk_samples=plan.update_spp,
                                         device=port.device)
                    if stats_hook is not None:
                        stats_hook(sess)
            with _span(tracing, "bench.step"):
                sess.step(plan.update_spp)
            with _span(tracing, "bench.readback"):
                image = sess.buffers()["beauty"].cpu().numpy()
        t1 = time.perf_counter()
        if rec is not None:
            rec.update(frame, u, t0, t1, tracing)
    if rec is not None:
        rec.finished(frame, image)
    return True


def _counting(rec: Recorder):
    """A hook that counts the pool's segments and steps of a session's
    updates (the stats that accumulate_samples returns to the session)."""
    def hook(sess):
        inner = sess._accumulate

        def counted(cfg):
            out, stats = inner(cfg)
            rec.counters["segments"] += int(stats["segments"])
            rec.counters["steps"] += int(stats["steps"])
            return out, stats

        sess._accumulate = counted
    return hook


def _trace_skip(seconds: float) -> float:
    return min(TRACE_SKIP_S, 0.25 * seconds)


def _run_one_card(cell, plan, port, seconds, trace, t_start_process):
    from . import trace as trace_mod

    rec = Recorder(plan)
    # Warm-up: one whole frame of the cell's shapes, at a pose the window
    # renders too, under a key it does not use.
    _one_card_frame(port, plan, -1, None, float("inf"), False, None)
    if trace:
        trace_mod.warm(port.device)
    port.sync()
    t_start = time.perf_counter()
    setup_s = t_start - t_start_process
    deadline = t_start + seconds
    tracer, state, launches, traces = None, "before", [], []
    frame = 0
    while time.perf_counter() < deadline:
        if (trace and state == "before"
                and time.perf_counter() - t_start >= _trace_skip(seconds)):
            tracer = trace_mod.Trace(port.device)
            tracer.start()
            launches.append(port.launches())
            t_traced, state = time.perf_counter(), "on"
        on = state == "on"
        finished = _one_card_frame(port, plan, frame, rec, deadline, on,
                                   _counting(rec) if on else None)
        if on and finished:
            rec.traced_frames.append(frame)
        if on and time.perf_counter() - t_traced >= TRACE_SECONDS:
            tracer.stop()
            launches.append(port.launches())
            state = "done"
        frame += 1
    if state == "on":
        tracer.stop()
        launches.append(port.launches())
    if tracer is not None:
        traces.append(tracer.summary())
        rec.counters["k1_launches"] = launches[1][0] - launches[0][0]
        rec.counters["k3_launches"] = launches[1][1] - launches[0][1]
    return {"setup_s": setup_s, "window": _window(rec, t_start), "rec": rec,
            "traces": traces}


def _window(rec: Recorder, t_start: float) -> dict:
    ups = rec.updates
    if not ups:
        return {"updates": 0, "seconds": 0.0, "samples": 0, "times": []}
    plan = rec.plan
    per_update = plan.width * plan.height * plan.update_spp
    return {"updates": len(ups),
            "seconds": ups[-1][3] - t_start,
            "samples": per_update * len(ups),
            "times": [t1 - t0 for _, _, t0, t1, _ in ups]}


# ---------------------------------------------------------------------------
# Several ranks: one frame is one render_distributed call
# ---------------------------------------------------------------------------

_RENDER, _TRACE_ON, _TRACE_OFF = 1, 2, 4


def _rank_loop(cell, plan, port, rank, seconds, trace, t_start_process):
    """The closed loop of every rank; rank 0 decides, over a broadcast
    before each frame, whether the next frame runs and when the trace
    starts and stops. Returns rank 0's timings, every rank's trace, and the
    forbidden modules that any rank holds once the window has closed."""
    import torch
    import torch.distributed as dist

    from raytracer_project_tpu_torch.parallel import distributed

    from . import trace as trace_mod

    def frame_call(f):
        cam = port.camera(plan.camera(f))
        return distributed.render_distributed(
            port.scene, cam, port.env, plan.key(f), port.config,
            device=port.device)

    frame_call(-1)                     # warm-up: NCCL, the pools, the kernels
    if trace:
        trace_mod.warm(port.device)
    port.sync()
    dist.barrier()
    rec = Recorder(plan)
    flag = torch.zeros((1,), dtype=torch.int32, device=port.device)
    t_start = time.perf_counter()
    setup_s = t_start - t_start_process
    deadline = t_start + seconds
    tracer, traced_from, done_tracing = None, None, False
    frame = 0
    while True:
        if rank == 0:
            now = time.perf_counter()
            cmd = _RENDER if now < deadline else 0
            if trace and not done_tracing:
                if (tracer is None and cmd
                        and now - t_start >= _trace_skip(seconds)):
                    cmd |= _TRACE_ON
                elif tracer is not None and (
                        not cmd or now - traced_from >= TRACE_SECONDS):
                    cmd |= _TRACE_OFF
            flag.fill_(cmd)
        dist.broadcast(flag, 0)
        cmd = int(flag.item())
        if cmd & _TRACE_OFF:
            tracer.stop()
            done_tracing = True
        if cmd & _TRACE_ON:
            tracer = trace_mod.Trace(port.device)
            tracer.start()
            traced_from = time.perf_counter()
        if not cmd & _RENDER:
            break
        tracing = tracer is not None and not done_tracing
        t0 = time.perf_counter()
        with _span(tracing, "bench.update"):
            out = frame_call(frame)
        t1 = time.perf_counter()
        if rank == 0:
            rec.update(frame, 0, t0, t1, tracing)
            rec.finished(frame, out["beauty"])
            if tracing:
                rec.traced_frames.append(frame)
        frame += 1
    summ = tracer.summary() if tracer is not None else None
    mem = (int(torch.cuda.max_memory_allocated(port.device))
           if port.device.type == "cuda" else 0)
    parts = [None] * dist.get_world_size()
    with distributed._collective_device(port.device):
        dist.all_gather_object(parts, {"trace": summ, "memory": mem,
                                       "forbidden": forbidden_modules()})
    return {"setup_s": setup_s, "window": _window(rec, t_start), "rec": rec,
            "traces": [p["trace"] for p in parts if p["trace"] is not None],
            "memory": max(p["memory"] for p in parts),
            "forbidden": sorted({m for p in parts for m in p["forbidden"]})}


def _rank_setup(rank: int, world: int, store: str, device: str):
    """Join the group of `world` ranks through the file store `store`: NCCL
    between cards, gloo on the CPU (parallel/distributed.py's rule), with a
    timeout so that a rank that died cannot hang the others."""
    import datetime

    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=f"file://{store}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dev


def _rank_worker(rank, world, store, device, workload, bench, traffic,
                 seed, seconds, trace, fault):
    """A rank other than 0, in a process of its own."""
    import torch
    import torch.distributed as dist

    t_start_process = time.perf_counter()
    if device.startswith("cuda"):
        torch.set_num_threads(1)     # as the command's process (run.py)
    if fault:
        from . import faults
        faults.apply(fault)
    cell = load_cell(workload, bench, traffic=traffic)
    plan = Plan(cell.cfg, cell.traffic, seed)
    dev = _rank_setup(rank, world, store, device)
    port = Port(cell, plan, dev)
    try:
        _rank_loop(cell, plan, port, rank, seconds, trace, t_start_process)
    finally:
        dist.destroy_process_group()


def _run_ranks(cell, plan, seed, seconds, trace, t_start_process, devices,
               bench, fault):
    import torch.distributed as dist

    world = len(devices)
    ctx = multiprocessing.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="bench_store_")
    store = os.path.join(store_dir, "store")
    procs = [ctx.Process(
        target=_rank_worker,
        args=(r, world, store, str(devices[r]), cell.name, bench,
              cell.traffic, seed, seconds, trace, fault))
        for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        dev = _rank_setup(0, world, store, str(devices[0]))
        port = Port(cell, plan, dev)
        out = _rank_loop(cell, plan, port, 0, seconds, trace, t_start_process)
        dist.destroy_process_group()
    except BaseException:
        for p in procs:      # the others would wait on rank 0 until timeout
            p.kill()
        raise
    finally:
        for p in procs:
            p.join(timeout=GROUP_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
        for name in os.listdir(store_dir):
            os.unlink(os.path.join(store_dir, name))
        os.rmdir(store_dir)
    bad = [p.exitcode for p in procs if p.exitcode]
    if bad:
        raise RuntimeError(f"a rank process exited with {bad}")
    out["port"] = port
    return out


# ---------------------------------------------------------------------------
# The check against the reference
# ---------------------------------------------------------------------------

def check(cell: Cell, plan: Plan, frames: dict, device) -> dict:
    """Each checked frame's sampled pixels against the reference's, at the
    run's frame size, camera, key and samples. Returns the numbers compared
    with their limits (compare.py)."""
    from . import compare
    from .reference.render import Reference

    done = sorted(frames)
    chosen = plan.frames_to_check(done)
    if not chosen:
        return compare.verdict({}, cell.limits, frames_checked=0)
    ref = Reference(cell.generator, cell.cfg, device)
    prog, want = [], []
    for f in chosen:
        sums = ref.sums(plan.camera(f), plan.width, plan.height, plan.key(f),
                        plan.check_ids, plan.frame_spp)
        want.append((sums / plan.frame_spp).cpu().numpy())
        prog.append(frames[f])
    numbers = compare.numbers(np.concatenate(prog), np.concatenate(want))
    return compare.verdict(numbers, cell.limits, frames_checked=len(chosen))


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def end_to_end(window: dict, setup_s: float) -> dict:
    """The cell's user-facing numbers from the window's updates."""
    return {
        "samples_per_s": window["samples"] / window["seconds"],
        "update_p95_ms": 1e3 * _percentile(window["times"], 95.0),
        "setup_s": setup_s,
    }


def layer_context(cell, plan, port, out) -> dict:
    """What the per-layer readers read: the traced updates (benchmark
    spans), the pool's counters over them, every rank's trace summary."""
    rec = out["rec"]
    traced = [u for u in rec.updates if u[4]]
    return {
        "updates": traced,
        "frames": rec.traced_frames,
        "counters": dict(rec.counters),
        "traces": out.get("traces", []),
        "ranks": int(cell.traffic.get("ranks", 1)),
        "pool_lanes": port.pool_lanes(plan.update_spp),
        "samples_per_update": plan.width * plan.height * plan.update_spp,
        "counts": port.counts,
        "n_materials": port.n_materials,
        "n_volumes": port.n_volumes,
    }


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start_process: float, device=None, bench=None,
             fault: str | None = None) -> tuple:
    """Run the cell once: (the result line's object, the check's verdict,
    whose "forbidden" lists what the other ranks' processes loaded).
    `device` None means the card(s); tests pass "cpu" (the port's plain
    versions; ranks on gloo). `fault` (faults.py) is planted in every rank
    for the run."""
    undo = None
    if fault:
        from . import faults
        undo = faults.apply(fault)
    try:
        return _run_cell(cell, seed, seconds, trace, t_start_process, device,
                         bench, fault)
    finally:
        if undo is not None:
            undo()


def _run_cell(cell, seed, seconds, trace, t_start_process, device, bench,
              fault):
    import torch

    plan = Plan(cell.cfg, cell.traffic, seed)
    ranks = int(cell.traffic.get("ranks", 1))
    on_card = device is None
    if on_card:
        from raytracer_project_tpu_torch import kernels
        kernels.build_all()      # once per checkout: every rank loads it
    if ranks > 1:
        devices = ([torch.device("cuda", r) for r in range(ranks)] if on_card
                   else [torch.device(device)] * ranks)
        out = _run_ranks(cell, plan, seed, seconds, trace, t_start_process,
                         devices, bench, fault)
        port = out["port"]
        memory = out["memory"]
    else:
        port = Port(cell, plan, torch.device("cuda", 0) if on_card else device)
        out = _run_one_card(cell, plan, port, seconds, trace, t_start_process)
        memory = (int(torch.cuda.max_memory_allocated(port.device))
                  if on_card else 0)

    metrics = {}
    if trace:
        ctx = layer_context(cell, plan, port, out)
        for m in cell.per_layer:
            value = load_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(out["window"], out["setup_s"])
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    frames = out["rec"].frames
    attempted = out["window"]["updates"]
    traces = out.get("traces", [])
    forbidden = out.get("forbidden", [])
    dev = port.device
    del out, port
    if on_card:
        torch.cuda.empty_cache()
    verdict = check(cell, plan, frames, dev)

    info = device_info(on_card, cell.chips, memory)
    result = {"correct": verdict["correct"], "attempted": attempted,
              "failed": 0, "metrics": metrics, "device": info}
    if trace and traces:
        info["busy_s"] = statistics.fmean(t["busy_s"] for t in traces)
        info["window_s"] = traces[0]["window_s"]
        result["breakdown"] = {"device_ops": traces[0]["device_ops"],
                               "idle_gaps": traces[0]["idle_gaps"]}
    result["checks"] = verdict["checks"]
    verdict["forbidden"] = forbidden
    return result, verdict


def device_info(on_card: bool, chips: int, memory: int) -> dict:
    import torch

    if on_card:
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": memory}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": memory}
