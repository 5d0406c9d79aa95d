"""The port's command line (cli.py) and its small utilities on the CPU:
`render --device cpu` writes its passes and checkpoint, `--resume` restores
it, `--profile`'s trace carries the port's spans (window threads' too),
the default device raises without a card, `info` names no JAX,
`--check-numerics` is clean on the tiny showcase and the NaN trap
(utils/debug.py) raises and names the op, and applog and histview give the
reference's strings."""

import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_project_tpu.ops import post as jpost
from raytracer_project_tpu.utils import applog as japplog
from raytracer_project_tpu.utils import histview as jhist
from raytracer_project_tpu_torch import cli
from raytracer_project_tpu_torch.ops import post as tpost
from raytracer_project_tpu_torch.utils import applog, debug, histview, image_io

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--width", "32", "--height", "18", "--spp", "4",
        "--chunk", "2", "--max-depth", "4", "--quiet"]


def test_render_writes_passes_and_resume_restores(tmp_path, capsys):
    out = tmp_path / "out"
    ck = str(tmp_path / "ck.npz")
    argv = ["render", *TINY, "--passes", "rgb,albedo,normals,z_depth",
            "--out", str(out), "--checkpoint", ck]
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out.split()
    names = ["rgb", "albedo", "normals", "z_depth"]
    assert printed == [str(out / f"render_{n}.png") for n in names]
    first = {n: image_io.read_png(str(out / f"render_{n}.png")) for n in names}
    for img in first.values():
        assert img.shape == (18, 32, 3) and img.dtype == np.uint8
    assert first["rgb"].max() > 0
    with np.load(ck) as data:
        assert int(data["samples_done"]) == 4

    # --resume restores the 4 spp and renders nothing more: same images.
    out2 = tmp_path / "out2"
    argv = ["render", *TINY[:-1], "--passes", "rgb", "--out", str(out2),
            "--checkpoint", ck, "--resume"]
    assert cli.main(argv) == 0
    err = capsys.readouterr()
    assert "Restored 4 samples" in err.out
    np.testing.assert_array_equal(
        image_io.read_png(str(out2 / "render_rgb.png")), first["rgb"])


def _profiled_names(tmp_path, *extra) -> list:
    """Names of the events in `render --profile`'s trace.json of a 16x9
    render of 2 spp in chunks of 1."""
    argv = ["render", "--device", "cpu", "--width", "16", "--height", "9",
            "--spp", "2", "--chunk", "1", "--max-depth", "3", "--quiet",
            "--passes", "rgb", "--out", str(tmp_path / "out"),
            "--profile", str(tmp_path / "prof"), *extra]
    assert cli.main(argv) == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    return [e.get("name") for e in trace["traceEvents"]]


def test_profile_trace_carries_the_spans(tmp_path):
    """`--profile DIR`: DIR/trace.json holds the session's and the pool's
    spans as host events."""
    names = _profiled_names(tmp_path)
    assert names.count("session.step") == 2
    assert names.count("pool.call") == 2
    assert names.count("window.render") == 0


def test_profile_trace_carries_the_window_threads_spans(tmp_path):
    """Under `--devices 2` each chunk renders two windows, each in a thread
    of its own: the trace holds every thread's `window.render` and pool."""
    names = _profiled_names(tmp_path, "--devices", "2")
    assert names.count("session.step") == 2
    assert names.count("window.render") == 4
    assert names.count("pool.call") == 4


def test_bench_flags_win_over_the_environment_for_one_run(monkeypatch):
    """`bench --spp/--device` override BENCH_SPP/BENCH_DEVICE for the run
    and leave the environment as it was; without flags bench reads it."""
    from raytracer_project_tpu_torch import bench

    seen = []
    monkeypatch.setattr(bench, "main", lambda: seen.append(
        (os.environ.get("BENCH_SPP"), os.environ.get("BENCH_DEVICE"))) or 0)
    monkeypatch.setenv("BENCH_SPP", "64")
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    assert cli.main(["bench", "--spp", "8", "--device", "cpu"]) == 0
    assert cli.main(["bench"]) == 0
    assert seen == [("8", "cpu"), ("64", None)]
    assert os.environ["BENCH_SPP"] == "64" and "BENCH_DEVICE" not in os.environ


def test_render_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["render", "--width", "8", "--height", "8", "--spp", "1"])


def test_info_names_no_jax():
    res = subprocess.run([sys.executable, "-m", "raytracer_project_tpu_torch",
                          "info"], capture_output=True, text=True, cwd=REPO,
                         timeout=120, check=True)
    info = json.loads(res.stdout)
    assert info["torch"] == torch.__version__
    assert info["devices"][0] == "cpu"
    assert "jax" not in res.stdout.lower()


def test_check_numerics_is_clean_on_the_tiny_showcase(tmp_path, capsys):
    argv = ["render", "--device", "cpu", "--width", "16", "--height", "9",
            "--spp", "1", "--out", str(tmp_path), "--check-numerics"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "the kernels' plain versions" in out
    assert "check-numerics pass clean" in out


def test_checked_raises_on_a_nan_and_names_the_op():
    def make_nan(x):
        y = torch.sqrt(x - 2.0)          # NaN where x < 2
        return torch.where(x < 2.0, 0.0, y)

    x = torch.linspace(0.0, 4.0, 9)
    assert torch.isfinite(make_nan(x)).all()   # masked without the trap
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        debug.checked(make_nan)(x)
    assert torch.equal(debug.checked(lambda v: v * 2.0)(x), x * 2.0)
    assert debug.audit_buffers({"a": torch.tensor([1.0, float("nan")]),
                                "b": torch.ones(3)}) == {"a": 1}


def _stats():
    img = np.random.default_rng(3).gamma(0.7, 0.4, (24, 40, 3)).astype(
        np.float32)
    return (jpost.analyze_framebuffer(img),
            tpost.analyze_framebuffer(torch.tensor(img)))


def test_histview_matches_reference():
    ref, port = _stats()
    np.testing.assert_array_equal(port.histogram.numpy(),
                                  np.asarray(ref.histogram))
    for kw in ({}, {"target_luminance": 0.12}, {"width": 40}):
        assert histview.ascii_histogram(port, **kw) == jhist.ascii_histogram(
            ref, **kw)
    assert histview.luminance_legend() == jhist.luminance_legend()
    assert histview.bvh_legend(5) == jhist.bvh_legend(5)


def test_applog_matches_reference():
    logs = [mod.AppLog(capacity=3) for mod in (applog, japplog)]
    for log in logs:
        log.error("boom %d", 1)
        log.render("go")
        log.system("a %s", "b")
        log.debug("c")
    strip = lambda e: re.sub(r"^\[\d\d:\d\d:\d\d\] ", "", e)
    assert [strip(e) for e in logs[0].entries] == [strip(e) for e in
                                                   logs[1].entries]
    assert len(logs[0].entries) == 3
    assert applog.AppLog.severity_of(logs[0].entries[0]) == "Render"
    for args in ((100, 100, 10, 8, 2.0), (3, 4, 1, 2, 0.0)):
        assert applog.rays_per_second(*args) == japplog.rays_per_second(*args)
    assert applog.measured_rays_per_second(5e6, 0.5) == 1e7
    buf = io.StringIO()
    echo = applog.AppLog(echo=True)
    sys.stdout, saved = buf, sys.stdout
    try:
        echo.config("x=%d", 3)
    finally:
        sys.stdout = saved
    assert buf.getvalue().strip().endswith("[Config] x=3")
