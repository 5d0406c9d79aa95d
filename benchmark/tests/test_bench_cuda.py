"""On the card: one short run of each one-card cell at its own size, and
the reference against the program there. Skips without a card."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["showcase.turntable", "cornell_smoke.final",
                                      "showcase.preview"])
def test_a_short_run_on_the_card_is_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    cell = tiny.load_cell(workload)
    result, verdict = harness.run_cell(cell, 2**31 + 3, 4.0, False,
                                       time.perf_counter())
    assert result["device"]["platform"] == "gpu"
    assert result["correct"], verdict
