"""The readers of the `cornell_smoke.final` cell: `fog.scatter_share` on a
run at a size the CPU holds, `k3.fog_roofline_share` on trace summaries
with and without K3 fused's fog variant, and a traced run on the card
that reads both."""

import time

import pytest
import torch

from benchmark import harness, roofline
from benchmark.tests import tiny

CELL = "cornell_smoke.final"
FOG = ("void shade_kernel<false, false, true, true>(float const*, float "
       "const*, int const*, int, float const*, float const*)")
BEAUTY = ("void shade_kernel<false, false, false, true>(float const*, float "
          "const*, int const*, int, float const*, float const*)")
RESPAWN = "void respawn_kernel<false>(int, float const*, unsigned int, int)"


def _pool():
    from raytracer_project_tpu_torch.ops import fused_step

    return fused_step.render_pool_fused


def test_the_scatter_share_reads_a_tiny_run(monkeypatch):
    """A traced run of the cell on the CPU (32x18, 4 spp in updates of 2):
    `correct`, and `fog.scatter_share` in (0, 100), the port's totals of
    this run; `k3.fog_roofline_share` reads nothing without device
    kernels."""
    pool = _pool()
    monkeypatch.setattr(pool, "segments", 0)
    monkeypatch.setattr(pool, "scatters", 0)
    cell = tiny.load_cell(CELL, traffic=tiny.traffic())
    result, verdict = harness.run_cell(cell, 2**31 + 29, 3.0, True,
                                       time.perf_counter(), device="cpu")
    assert result["correct"], verdict
    share = result["metrics"]["fog.scatter_share"]
    assert share["unit"] == "%" and 0.0 < share["value"] < 100.0
    assert share["value"] == pytest.approx(
        100.0 * pool.scatters / pool.segments)
    assert "k3.fog_roofline_share" not in result["metrics"]


def test_the_scatter_share_is_none_without_the_totals(monkeypatch):
    """A program without the totals (the parent of the counter) or before
    any segment reads None."""
    read = harness.load_reader("fog.scatter_share").read
    pool = _pool()
    monkeypatch.setattr(pool, "segments", 0)
    monkeypatch.setattr(pool, "scatters", 0)
    assert read({}) is None
    monkeypatch.setattr(pool, "segments", 400)
    monkeypatch.setattr(pool, "scatters", 100)
    assert read({}) == pytest.approx(25.0)
    monkeypatch.delattr(pool, "scatters")
    assert read({}) is None
    monkeypatch.delattr(pool, "segments")
    assert read({}) is None


def _ctx(kernel_s):
    return {"counters": {"segments": 3_000, "steps": 10, "k3_launches": 11},
            "traces": [{"kernel_s": kernel_s}], "updates": [0] * 4,
            "samples_per_update": 100, "counts": (0, 0, 6),
            "n_materials": 4, "n_volumes": 2}


def test_the_fog_roofline_reads_the_fog_variant_alone():
    """k3.fog_roofline_share: k3_bytes with the fog volumes over the fog
    instantiation's time and the respawn's, whatever else ran; None
    without the fog variant, without a trace or without segments."""
    read = harness.load_reader("k3.fog_roofline_share").read
    nbytes = roofline.k3_bytes(3_000, 400, 11, (0, 0, 6), 4, 2)
    want = 100 * roofline.bound_seconds(nbytes) / 0.012
    ctx = _ctx({FOG: 0.010, RESPAWN: 0.002, BEAUTY: 0.5,
                "Memcpy DtoH (Device -> Pageable)": 0.3})
    assert read(ctx) == pytest.approx(want)
    assert read(_ctx({BEAUTY: 0.010, RESPAWN: 0.002})) is None
    assert read(_ctx({})) is None
    assert read(dict(_ctx({FOG: 0.01}), traces=[])) is None
    assert read(dict(_ctx({FOG: 0.01}), counters={})) is None


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_both_metrics():
    """A short traced run of the cell at its own size on the card: both
    metrics read, each a share in (0, 100]."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cell = harness.load_cell(CELL)
    result, verdict = harness.run_cell(cell, 2**31 + 31, 4.0, True,
                                       time.perf_counter())
    assert result["correct"], verdict
    for name in ("fog.scatter_share", "k3.fog_roofline_share"):
        assert 0.0 < result["metrics"][name]["value"] <= 100.0, (
            name, result["metrics"])
