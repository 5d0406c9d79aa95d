"""The check decides `correct`: a sound run passes; the control (the
reference in bfloat16 in the program's place) and each fault a cell can
have under its timed path fail."""

import time

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.reference import render
from benchmark.tests import tiny


def _run(workload, traffic, fault=None, seed=21):
    cell = tiny.load_cell(workload, traffic=traffic)
    return harness.run_cell(cell, seed, 3.0, False, time.perf_counter(),
                            device="cpu", fault=fault)


@pytest.mark.parametrize("workload", ["showcase.turntable", "cornell_smoke.final"])
def test_sound_run_is_correct(workload):
    result, verdict = _run(workload, tiny.traffic())
    assert result["correct"] and verdict["checks"]["px_off_share"]["value"] == 0.0
    assert list(result["checks"]) == ["frames_checked", "px_off_share",
                                      "nonfinite_px"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_fault_under_one_card_fails(fault):
    result, verdict = _run("showcase.turntable", tiny.traffic(), fault)
    assert not result["correct"], verdict


def test_the_exchange_left_out_fails():
    traffic = tiny.traffic(ranks=2, spp=2, update_spp=2)
    result, verdict = _run("showcase.4card", traffic)
    assert result["correct"] and verdict["forbidden"] == []
    result, verdict = _run("showcase.4card", traffic, "exchange_left_out")
    assert not result["correct"], verdict


def test_a_forbidden_module_in_another_rank_refuses_the_run(monkeypatch, capsys):
    """Rank 1 (a gloo rank in a process of its own) holds a module with
    the JAX package's name: the command prints no result and fails."""
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)    # run.py sets them
    from benchmark import run

    traffic = tiny.traffic(ranks=2, spp=2, update_spp=2)
    result, verdict = _run("showcase.4card", traffic, "jax_in_a_rank")
    assert verdict["forbidden"] == ["raytracer_project_tpu"]
    assert "raytracer_project_tpu" not in harness.forbidden_modules()
    capsys.readouterr()
    assert run.finish(result, verdict) != 0
    out = capsys.readouterr()
    assert "{" not in out.out and "raytracer_project_tpu" in out.err


@pytest.mark.parametrize("workload", ["showcase.turntable", "cornell_smoke.final",
                                      "showcase.4card", "showcase.preview"])
def test_the_control_fails_each_cells_limit(workload):
    """The reference with its state in bfloat16, in the program's place,
    at a size the CPU holds, reads above the cell's limit."""
    cell = tiny.load_cell(workload)
    ref = render.Reference(cell.generator, cell.cfg, "cpu")
    ids = np.arange(0, 40 * 24, 3)
    spp = 4
    want = ref.sums(cell.cfg["camera"], 40, 24, 9, ids, spp).numpy() / spp
    got = ref.sums(cell.cfg["camera"], 40, 24, 9, ids, spp,
                   round_to=torch.bfloat16).numpy() / spp
    nums = compare.numbers(got, want)
    assert nums["px_off_share"] > cell.limits["px_off_share"]["limit"]
    assert not compare.verdict(nums, cell.limits, 1)["correct"]


def test_non_finite_pixels_fail():
    nums = compare.numbers(np.array([[np.nan, 0, 0], [1, 1, 1]]),
                           np.array([[0.0, 0, 0], [1, 1, 1]]))
    assert nums == {"px_off_share": 0.5, "nonfinite_px": 1}
    assert not compare.verdict(nums, {"px_off_share": {"limit": 0.9}}, 1)["correct"]
    assert not compare.verdict({}, {"px_off_share": {"limit": 0.9}}, 0)["correct"]
