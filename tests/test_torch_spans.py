"""The port's spans (utils/spans.py): without a profiler a span is one
shared no-op, under torch.profiler each span is a host event, a session's
update nests the fused pool's spans, window threads' spans fall inside the
caller's, and two gloo ranks trace the multi-card frame's spans."""

import json
import threading
import time

import pytest
import torch
import torch.multiprocessing as mp
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from raytracer_project_tpu_torch.models import camera, environment, presets
from raytracer_project_tpu_torch.models.scene import SceneBuilder
from raytracer_project_tpu_torch.ops import fused_step, integrator
from raytracer_project_tpu_torch.parallel import distributed
from raytracer_project_tpu_torch.parallel import render as prender
from raytracer_project_tpu_torch.utils import spans
from raytracer_project_tpu_torch.utils.session import RenderSession

torch.set_num_threads(2)

POOL = ("pool.call", "pool.setup", "tables.build", "pool.loop",
        "pool.launch", "pool.finish")
DIST = ("dist.mesh", "dist.render", "dist.gather", "dist.finalize",
        "dist.copy")
NAMES = {"session.create", "session.step", "session.buffers",
         "window.render", "dist.frame", *POOL, *DIST, "test.frame",
         "test.work"}


def _showcase(spp: int = 2):
    """The showcase world at 16x9, depth 3, beauty only."""
    cfg = integrator.RenderConfig(width=16, height=9, samples_per_pixel=spp,
                                  max_depth=3, use_albedo=False,
                                  use_normal=False, use_z_depth=False)
    cam = camera.make_camera(image_width=16, image_height=9, vfov=30.0,
                             lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
    env = environment.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                       sun_intensity=6.0)
    return presets.showcase_scene(), cam, env, cfg


def _profiled(fn, every_thread: bool = False):
    """fn() under torch.profiler (CPU): (its result, the spans' host events
    as dicts of name, start_ns, end_ns, thread)."""
    extra = ({"experimental_config": _ExperimentalConfig(
        profile_all_threads=True)} if every_thread else {})
    with profile(activities=[ProfilerActivity.CPU], **extra) as prof:
        out = fn()
    events = [{"name": e.name(), "start_ns": int(e.start_ns()),
               "end_ns": int(e.end_ns()), "thread": int(e.start_thread_id())}
              for e in prof.profiler.kineto_results.events()
              if e.name() in NAMES]
    return out, sorted(events, key=lambda e: e["start_ns"])


def _inside(events, outer, name=None):
    """The events of `name` (any) on outer's thread within outer's
    interval, outer itself left out."""
    return [e for e in events if e is not outer
            and (name is None or e["name"] == name)
            and e["thread"] == outer["thread"]
            and outer["start_ns"] <= e["start_ns"] <= e["end_ns"]
            <= outer["end_ns"]]


def _children(events, outer):
    """The events directly inside outer: inside it and inside no other
    event that is inside it."""
    within = _inside(events, outer)
    return [e for e in within
            if not any(o is not e and e in _inside(events, o)
                       for o in within)]


def test_off_returns_one_object_and_reads_no_clock(monkeypatch):
    """No profiler: every span is the one no-op, and a session's update
    reads no clock through the spans and builds no profiler event."""
    assert spans.span("a") is spans.span("b") is spans._OFF

    def no_clock():
        raise AssertionError("the off path read the clock")

    def no_event(name):
        raise AssertionError(f"the off path built the event {name}")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_event)
    scene, cam, env, cfg = _showcase(spp=1)
    sess = RenderSession(scene, cam, env, cfg, key=3, chunk_samples=1,
                         device="cpu")
    sess.step(1)
    sess.buffers()


def test_a_session_update_nests_the_pool_spans(monkeypatch):
    """One fused chunk of one sample each: a step of 2 samples holds two
    pool.call spans, each with one setup, one loop of one launch a step
    (the CPU waits on every step) and one finish; the first setup builds
    the scene's tables (one tables.build), the second reuses them."""
    monkeypatch.setattr(fused_step, "fused_spp_chunk", lambda *a, **k: 1)
    returned = []
    inner = fused_step.render_pool_fused

    def kept(*a, **k):
        out = inner(*a, **k)
        returned.append(out[1])
        return out

    monkeypatch.setattr(fused_step, "render_pool_fused", kept)
    scene, cam, env, cfg = _showcase()
    sess = RenderSession(scene, cam, env, cfg, key=3, device="cpu")
    _, events = _profiled(lambda: sess.step(2))

    step, = [e for e in events if e["name"] == "session.step"]
    assert _inside(events, step) == [e for e in events if e is not step]
    calls = _children(events, step)
    assert [e["name"] for e in calls] == ["pool.call"] * 2
    assert len(returned) == 2
    for k, (call, stats) in enumerate(zip(calls, returned)):
        kids = _children(events, call)
        assert [e["name"] for e in kids] == [
            "pool.setup", "pool.loop", "pool.finish"]
        setup, loop, _ = kids
        assert [e["name"] for e in _children(events, setup)] == (
            ["tables.build"] if k == 0 else [])
        launches = _children(events, loop)
        assert {e["name"] for e in launches} == {"pool.launch"}
        assert len(launches) == stats["steps"] > 0


def test_the_profiler_carries_every_span_nested_and_timed():
    """A session's create, step and buffers: each span is a host event
    whose time holds its children's, the pool's spans inside the step."""
    scene, cam, env, cfg = _showcase()

    def run():
        sess = RenderSession(scene, cam, env, cfg, key=3, chunk_samples=1,
                             device="cpu")
        sess.step(1)
        sess.buffers()

    _, events = _profiled(run)
    assert {e["name"] for e in events} == {
        "session.create", "session.step", "session.buffers", *POOL}
    tops = [e for e in events if not any(
        e in _inside(events, o) for o in events)]
    assert [e["name"] for e in tops] == [
        "session.create", "session.step", "session.buffers"]
    assert {e["name"] for e in _inside(events, tops[1])} == set(POOL)
    for e in events:
        kids = _children(events, e)
        assert e["end_ns"] > e["start_ns"]
        assert sum(k["end_ns"] - k["start_ns"] for k in kids) <= (
            e["end_ns"] - e["start_ns"]), e["name"]


def test_the_profiler_alone_carries_the_spans_and_records_nothing():
    """Spans follow the profiler: events while it runs, the no-op before
    and after it, and nothing kept in between."""
    scene, cam, env, cfg = _showcase(spp=1)
    assert spans.span("x") is spans._OFF
    seen = []

    def run():
        seen.append(spans.span("x"))
        sess = RenderSession(scene, cam, env, cfg, key=3, chunk_samples=1,
                             device="cpu")
        sess.step(1)

    _, events = _profiled(run)
    assert seen[0] is not spans._OFF
    assert {e["name"] for e in events} >= {"session.step", *POOL}
    assert spans.span("x") is spans._OFF
    assert _profiled(lambda: None)[1] == []


def test_window_threads_hang_under_the_callers_span():
    """A profiler of every thread: each window's `window.render` runs in a
    window thread, inside the caller's span, around the window's work."""
    def work():
        with spans.span("test.work"):
            return threading.get_ident()

    def frame():
        with spans.span("test.frame"):
            return prender.run_windows([work, work], ["cpu", "cpu"])

    idents, events = _profiled(frame, every_thread=True)
    top, = [e for e in events if e["name"] == "test.frame"]
    windows = [e for e in events if e["name"] == "window.render"]
    assert len(windows) == 2 and threading.get_ident() not in idents
    assert top["thread"] not in {w["thread"] for w in windows}
    for w in windows:
        assert top["start_ns"] <= w["start_ns"] <= w["end_ns"] <= top["end_ns"]
        assert [e["name"] for e in _children(events, w)] == ["test.work"]


def _tiny():
    """16x9 @ 1 spp of three spheres under a solid sky."""
    b = SceneBuilder()
    ground = b.materials.lambertian("g", (0.5, 0.5, 0.5))
    metal = b.materials.metal("m", (0.9, 0.8, 0.7), fuzz=0.2)
    b.geometry.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    b.geometry.add_sphere((-1.2, 0.5, 0.0), 0.5, metal)
    b.geometry.add_sphere((0.4, 0.5, 0.0), 0.5, ground)
    cfg = integrator.RenderConfig(width=16, height=9, samples_per_pixel=1,
                                  max_depth=3,
                                  env_mode=environment.SOLID_COLOR)
    cam = camera.make_camera(image_width=16, image_height=9, vfov=40.0,
                             lookfrom=(0.0, 1.5, 4.0), lookat=(0.0, 0.5, 0.0))
    env = environment.make_environment(background_color=(0.7, 0.8, 1.0))
    return b.build(), cam, env, cfg


def _rank_worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    assert distributed.init_distributed(num_processes=world, process_id=rank,
                                        init_method=f"file://{init_file}",
                                        device="cpu")
    try:
        scene, cam, env, cfg = _tiny()
        _, events = _profiled(lambda: distributed.render_distributed(
            scene, cam, env, 5, cfg, device="cpu"), every_thread=True)
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(events, f)
    finally:
        torch.distributed.destroy_process_group()


def test_two_ranks_record_the_frames_spans(tmp_path):
    """Two spawned gloo ranks: on each, one dist.frame holding dist.mesh,
    dist.render (its window thread's spans inside its time), dist.gather,
    dist.finalize and dist.copy, one each, in that order."""
    ctx = mp.start_processes(_rank_worker,
                             args=(2, str(tmp_path / "init"), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    for _ in range(120):
        if ctx.join(timeout=1):
            break
    else:
        for p in ctx.processes:
            p.kill()
        pytest.fail("the ranks did not finish within 120 s")
    for rank in range(2):
        events = json.loads((tmp_path / f"rank{rank}.json").read_text())
        frame, = [e for e in events if e["name"] == "dist.frame"]
        assert [e["name"] for e in _children(events, frame)] == list(DIST)
        render = _children(events, frame)[1]
        window, = [e for e in events if e["name"] == "window.render"]
        assert window["thread"] != frame["thread"]
        assert (render["start_ns"] <= window["start_ns"] <= window["end_ns"]
                <= render["end_ns"])
        assert [e["name"] for e in _children(events, window)] == [
            "pool.call"]
