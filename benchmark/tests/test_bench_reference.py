"""The reference against the port's render on the CPU (the port's plain
versions) at a tiny size: every pixel equal, on both configurations."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference import render
from benchmark.tests import tiny


@pytest.mark.parametrize("workload,size", [("showcase.turntable", (40, 24, 2)),
                                           ("cornell_smoke.final", (24, 24, 4))])
def test_reference_equals_the_ports_render(workload, size):
    from raytracer_project_tpu_torch.ops import integrator

    w, h, spp = size
    cell = tiny.load_cell(workload, traffic=tiny.traffic(
        spp=spp, update_spp=spp, width=w, height=h))
    plan = harness.Plan(cell.cfg, cell.traffic, 11)
    port = harness.Port(cell, plan, "cpu")
    cam = port.camera(plan.camera(1))
    out = integrator.render(port.scene, cam, port.env, plan.key(1),
                            port.config, device="cpu")
    img = out["beauty"].reshape(-1, 3).numpy()
    ref = render.Reference(cell.generator, cell.cfg, "cpu")
    ids = np.arange(w * h)
    sums = ref.sums(plan.camera(1), w, h, plan.key(1), ids, spp).numpy()
    np.testing.assert_array_equal(img, sums / spp)
    assert img.mean() > 0.01


def test_reference_blocks_add_up(monkeypatch):
    cell = harness.load_cell("showcase.turntable")
    ref = render.Reference(cell.generator, cell.cfg, "cpu")
    ids = np.arange(0, 16 * 9, 5)
    whole = ref.sums(cell.cfg["camera"], 16, 9, 4, ids, 3)
    monkeypatch.setattr(render, "BLOCK_LANES", 7)
    # Blocks change only the order in which a pixel's samples are summed.
    np.testing.assert_allclose(
        ref.sums(cell.cfg["camera"], 16, 9, 4, ids, 3).numpy(), whole.numpy(),
        rtol=1e-6, atol=1e-6)
