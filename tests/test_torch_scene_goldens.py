"""The reference's golden configurations past the showcase
(tests/test_goldens.py: Shirley, the foggy Cornell box, the HDRI scene),
rendered by the port on the CPU on both engines and held against the
reference's CPU goldens within its CPU budget: mean |d| <= 0.01 and at
most 1% of pixels with a channel over 0.05."""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.tools import goldens

torch.set_num_threads(2)


def test_procedural_hdr_matches_reference():
    from tests.test_goldens import _procedural_hdr

    np.testing.assert_array_equal(goldens.procedural_hdr(), _procedural_hdr())


@pytest.mark.parametrize("engine", ["chunked", "fused"])
@pytest.mark.parametrize("name", goldens.NAMES)
def test_golden_config(name, engine):
    scene, cam, env, cfg = goldens.golden_config(name)
    cfg = dataclasses.replace(cfg, wavefront=engine == "fused")
    img = tint.render(scene, cam, env, 0, cfg, device="cpu")["beauty"].numpy()
    assert np.isfinite(img).all() and img.max() > 0
    mean, frac = goldens.golden_diff(img, name)
    assert mean <= 0.01, mean
    assert frac <= 0.01, frac
