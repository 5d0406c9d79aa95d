"""The sort_rays option of the chunked path's closest hit
(intersect.intersect on the "k4" route): the coherence permutation against
the reference's (pallas_intersect._sort_key, _radix_order) bit for bit,
and the same hits as the unsorted route."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.ops import pallas_intersect as jpi
from raytracer_project_tpu_torch.core.constants import T_MIN
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.ops import intersect as tis

torch.set_num_threads(2)


def _rays(n=6000, seed=0):
    """Rays from points in and around the showcase, in every direction,
    some along an axis (zero direction components)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8.0, 8.0, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.0, 4.0, size=n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:50, 1:] = 0.0
    return o, d


@pytest.fixture(scope="module")
def scenes():
    return jpresets.showcase_scene(with_bvh=False), tpresets.showcase_scene()


def test_permutation_matches_reference(scenes):
    jsc, tsc = scenes
    o, d = _rays()
    mm = jsc.mm
    bounds = jnp.concatenate([jpi._coarsen_bounds(b) for b in (
        mm.sphere_bounds, mm.tri_bounds, mm.box_bounds)], axis=0)
    major, minor, n_major = jpi._sort_key(jnp.asarray(o), jnp.asarray(d), bounds)
    ref_order, ref_dest = jpi._radix_order(minor, major, n_major)
    order, dest = tis.sort_order(tsc, torch.as_tensor(o), torch.as_tensor(d))
    assert len(set(np.asarray(major).tolist())) >= 2
    np.testing.assert_array_equal(order.numpy(), np.asarray(ref_order))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(ref_dest))


def test_sorted_hits_equal_unsorted(scenes):
    _, tsc = scenes
    o, d = (torch.as_tensor(x) for x in _rays(seed=1))
    tables = tis.hit_tables(tsc)
    assert tis.intersect_dispatch(tsc, o.device) == "k4"
    plain = tis.intersect(tsc, o, d, T_MIN, tables)
    srt = tis.intersect(tsc, o, d, T_MIN, tables, sort_rays=True)
    assert bool(plain.hit.any())
    for a, b in zip(plain, srt):
        assert torch.equal(a, b)
