"""The port's bench entry point (python -m raytracer_project_tpu_torch.bench)
on the CPU: one JSON line with the keys of the repository's bench.py after
its gate (the smoke module's first stage, SMOKE_FAST=1) passes, and exit 1
with an `error` key when the gate fails."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from raytracer_project_tpu_torch.utils import smoke

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
DETAIL_KEYS = {"width", "height", "spp", "max_depth", "wall_s", "primitives",
               "devices", "intersector", "engine", "rays_per_s_upper_bound",
               "rays_per_s_measured", "segments_traced", "pool_steps",
               "north_star_1080p"}


def _run(**env):
    full = dict(os.environ, BENCH_DEVICE="cpu", OMP_NUM_THREADS="2",
                SMOKE_FAST="1", **env)
    return subprocess.run([sys.executable, "-m",
                           "raytracer_project_tpu_torch.bench"], cwd=REPO,
                          env=full, capture_output=True, text=True, timeout=300)


def test_keys_are_bench_py_keys():
    """The keys checked below are those bench.py prints."""
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    printed = src[src.rindex("print(json.dumps({"):]
    printed = printed[:printed.index("}))")]
    assert set(re.findall(r'"(\w+)":', printed)) == TOP_KEYS | DETAIL_KEYS


def test_bench_prints_one_json_line():
    """32x18 @ 2 spp (depth 3) on the CPU after the gate (the smoke
    module's fused-fast stage: the 64x36 fused render against its golden):
    one line, bench.py's keys."""
    proc = _run(BENCH_WIDTH="32", BENCH_HEIGHT="18", BENCH_SPP="2",
                BENCH_DEPTH="3", BENCH_SKIP_1080P="1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    row = json.loads(lines[0])
    assert set(row) == TOP_KEYS and set(row["detail"]) == DETAIL_KEYS
    det = row["detail"]
    assert det["devices"] == ["cpu"] and det["engine"] == "fused"
    assert det["intersector"] == "k4" and det["primitives"] == 1454
    assert det["north_star_1080p"] is None
    assert row["value"] == det["rays_per_s_measured"] > 0
    assert det["segments_traced"] >= 32 * 18 * 2 and det["pool_steps"] > 0


def test_failing_gate_exits_1_with_error():
    """A gate that does not finish in time fails the bench: exit 1, one
    JSON line with an `error` key, nothing timed; and the gate's image
    check (smoke._check_image on the CPU) refuses a wrong image."""
    proc = _run(BENCH_SMOKE_TIMEOUT="0")
    assert proc.returncode == 1
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "gate timed out" in row["error"] and row["value"] == 0.0
    golden = np.load(smoke._golden_path("smoke_fused_64x36"))["beauty"]
    check = lambda img: smoke._check_image(img, "smoke_fused_64x36", "gate")
    assert check(golden) is None
    assert "disagrees" in check(golden * 0.5)
    assert "non-finite" in check(golden * np.nan)
