"""The harness: discovery by name, the metric arithmetic, the readers, the
trace reduction, the seeded plan and the command line's refusals."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness, trace
from benchmark.tests import tiny

REPO = harness.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.cfg["name"] == next(w["config"] for w in BENCH["workloads"]
                                    if w["name"] == workload)
    assert callable(cell.generator.build)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.load_reader(m["name"]).read)
    assert 0.0 < cell.limits["px_off_share"]["limit"] < 1.0


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    """A configuration, a mix, a cell and a metric added as new files and
    entries are found without editing a file that is there."""
    root = tmp_path / "benchmark"
    shutil.copytree(harness.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "traffic" / "tiny.json").write_text(json.dumps(tiny.traffic()))
    shutil.copy(root / "configs" / "showcase.json",
                root / "configs" / "showcase_copy.json")
    shutil.copy(root / "configs" / "showcase.py",
                root / "configs" / "showcase_copy.py")
    (root / "limits" / "showcase_copy.tiny.json").write_text(
        json.dumps({"px_off_share": {"limit": 0.01}}))
    (root / "layer_metrics" / "extra.count.py").write_text(
        "def read(ctx):\n    return float(len(ctx['updates']))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "showcase_copy.tiny",
                               "config": "showcase_copy", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "extra.count", "unit": "1",
                               "better": "higher", "source": "program_span",
                               "layer": "session", "moves": "samples_per_s",
                               "workloads": ["showcase_copy.tiny"]})
    cell = harness.load_cell("showcase_copy.tiny", bench, root=root)
    assert cell.traffic["width"] == 32
    assert [m["name"] for m in cell.per_layer] == ["extra.count"]
    assert harness.load_reader("extra.count", root).read({"updates": [1]}) == 1.0


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no.such.cell")


def test_end_to_end_arithmetic():
    """samples_per_s: every update's samples over the window's seconds;
    update_p95_ms: the 95th percentile over every update."""
    cell = harness.load_cell("showcase.turntable", traffic=tiny.traffic())
    plan = harness.Plan(cell.cfg, cell.traffic, 7)
    rec = harness.Recorder(plan)
    times = [0.010, 0.020, 0.030, 0.040, 0.200] * 4
    t = 100.0
    for k, dt in enumerate(times):
        rec.update(k // 2, k % 2, t, t + dt, False)
        t += dt + 0.001
    w = harness._window(rec, 100.0)
    assert w["updates"] == 20
    assert w["samples"] == 20 * 32 * 18 * 2
    assert w["seconds"] == pytest.approx(t - 0.001 - 100.0)
    e2e = harness.end_to_end(w, 3.5)
    assert e2e["samples_per_s"] == pytest.approx(w["samples"] / w["seconds"])
    assert e2e["update_p95_ms"] == pytest.approx(
        1e3 * np.percentile(times, 95))
    assert e2e["setup_s"] == 3.5


def _ctx(**kw):
    ctx = {"updates": [(0, 0, 0.0, 0.030, True), (0, 1, 0.031, 0.051, True),
                       (1, 0, 0.052, 0.092, True), (1, 1, 0.093, 0.113, True)],
           "frames": [0, 1],
           "counters": {"segments": 3_000, "steps": 10, "k1_launches": 11,
                        "k3_launches": 11},
           "traces": [{"busy_s": 0.08, "work_busy_s": 0.08, "window_s": 0.1,
                       "kernel_s": {"void tile_scan_kernel<true>(float)": 0.05,
                                    "void shade_kernel<false, false, false, true>()": 0.01,
                                    "void respawn_kernel<true>()": 0.002,
                                    "Memcpy DtoH": 0.001}}],
           "ranks": 1, "pool_lanes": 1_000, "samples_per_update": 100,
           "counts": (2, 3, 4), "n_materials": 5, "n_volumes": 1}
    ctx.update(kw)
    return ctx


def test_layer_readers():
    from benchmark import roofline

    read = lambda name, ctx: harness.load_reader(name).read(ctx)
    ctx = _ctx()
    assert read("session.first_update_ms", ctx) == pytest.approx(35.0)
    assert read("pool.ms_per_step", ctx) == pytest.approx(1e3 * 0.110 / 10)
    assert read("pool.occupancy", ctx) == pytest.approx(30.0)
    assert read("device.idle_share", ctx) == pytest.approx(20.0)
    k1 = roofline.k1_bytes(3_000, 11, (2, 3, 4)) / roofline.PEAK_BYTES_PER_S
    assert read("k1.roofline_share", ctx) == pytest.approx(100 * k1 / 0.05)
    k3 = roofline.k3_bytes(3_000, 400, 11, (2, 3, 4), 5, 1) / roofline.PEAK_BYTES_PER_S
    assert read("k3.roofline_share", ctx) == pytest.approx(100 * k3 / 0.012)
    assert read("cards.idle_share_max", ctx) is None
    four = [{"busy_s": 0.95, "work_busy_s": b, "window_s": 1.0, "kernel_s": {}}
            for b in (0.9, 0.6, 0.8, 0.7)]
    assert read("cards.idle_share_max", _ctx(ranks=4, traces=four)) == pytest.approx(40.0)
    empty = _ctx(counters={}, traces=[], frames=[])
    for name in ("session.first_update_ms", "pool.ms_per_step", "pool.occupancy",
                 "k1.roofline_share", "k3.roofline_share", "device.idle_share"):
        assert read(name, empty) is None, name


def test_trace_summary_busy_and_gaps():
    dev = [("k1", 100, 200), ("k3", 150, 300), ("copy", 10_000, 10_500),
           ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
            250, 1_000)]
    host = [("bench.update", 0, 20_000), ("cudaEventSynchronize", 5_000, 9_000)]
    s = trace.summarize(dev, host, 0, 20_000)
    # The gather waits 300 -> 1_000 beyond the kernels: busy, but no work.
    assert s["busy_s"] == pytest.approx(1_400e-9)
    assert s["work_busy_s"] == pytest.approx(700e-9)
    assert s["window_s"] == pytest.approx(20_000e-9)
    assert s["device_ops"][0][1] == pytest.approx(750e-9)
    assert s["device_ops"][1] == ["copy", pytest.approx(500e-9)]
    gaps = dict((n, v) for n, v in s["idle_gaps"])
    # 1_000 -> 10_000 (mid 5_500, inside the synchronise) and 10_500 -> 20_000.
    assert gaps["cudaEventSynchronize"] == pytest.approx(9_000e-9)
    assert gaps["bench.update"] == pytest.approx(9_500e-9)
    assert trace.kernel_seconds(s, "k1", "k3") == pytest.approx(250e-9)


def test_plan_is_seeded_and_every_seed_renders_the_same_poses():
    cell = harness.load_cell("showcase.turntable")
    a = harness.Plan(cell.cfg, cell.traffic, 2**31 + 5)
    b = harness.Plan(cell.cfg, cell.traffic, 2**31 + 5)
    c = harness.Plan(cell.cfg, cell.traffic, 12)
    assert np.array_equal(a.check_ids, b.check_ids)
    assert a.camera(3) == b.camera(3) and a.key(3) == b.key(3)
    n = a.poses
    assert sorted(a.angle(f) for f in range(n)) == sorted(c.angle(f) for f in range(n))
    cam = a.camera(0)
    rel = np.subtract(cam["lookfrom"], cam["lookat"])
    base = np.subtract(cell.cfg["camera"]["lookfrom"], cell.cfg["camera"]["lookat"])
    assert np.linalg.norm(rel) == pytest.approx(np.linalg.norm(base))
    assert rel[1] == pytest.approx(base[1])
    cornell = tiny.load_cell("cornell_smoke.final")
    p = harness.Plan(cornell.cfg, cornell.traffic, 3)
    assert all(abs(p.angle(f)) <= cornell.traffic["orbit"]["span_deg"] / 2
               for f in range(p.poses))


def _run(args, cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=120)


def test_command_without_a_card_prints_no_result():
    proc = _run(["--workload", "showcase.turntable", "--seed", "1",
                 "--seconds", "1", "--trace", "0"], REPO)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_command_in_a_bare_directory_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(["--workload", "showcase.turntable", "--seed", "1",
                 "--seconds", "1", "--trace", "0"], tmp_path)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_a_run_loads_no_jax():
    """After a run's set-up and window (a CPU run of a tiny cell), no module
    whose whole top-level name is jax, jaxlib, flax or raytracer_project_tpu
    is loaded; the port's own name only begins with the last."""
    code = (
        "import json, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "cell = harness.load_cell('showcase.turntable', traffic=tiny.traffic())\n"
        "res, _ = harness.run_cell(cell, 3, 3.0, False, time.perf_counter(),"
        " device='cpu')\n"
        "import sys\n"
        "print(json.dumps({'bad': harness.forbidden_modules(),"
        " 'port': 'raytracer_project_tpu_torch' in sys.modules,"
        " 'correct': res['correct']}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "port": True, "correct": True}


def test_forbidden_names_compare_whole():
    sys.modules["raytracer_project_tpu_torch_x"] = sys.modules[__name__]
    try:
        assert "raytracer_project_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["raytracer_project_tpu_torch_x"]
