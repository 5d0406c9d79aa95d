"""The port's closest hit (plain version of K1) against the reference's
Pallas kernel in interpret mode and against the exact brute-force oracle,
on showcase camera rays and bounce-like rays, under the reference's
hit-agree budgets (utils/smoke.py:351-359)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer_project_tpu.core import rng as jrng
from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.ops import intersect as jisect
from raytracer_project_tpu.ops import pallas_intersect
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.ops import closest_hit as k1
from raytracer_project_tpu_torch.ops import intersect as tisect

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    js = jpresets.showcase_scene(with_bvh=False)
    ts = tpresets.showcase_scene()
    cam = jcam.make_camera(image_width=128, image_height=72, vfov=30.0,
                           lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
    r = np.random.default_rng(8)
    n = 512
    px = jnp.asarray(r.integers(0, 128 * 72, n), jnp.int32)
    o, d = jcam.generate_rays(cam, jrng.lane_rng(jax.random.PRNGKey(8), px),
                              px, width=128)
    # Bounce-like rays: random points above the ground, random directions.
    o2 = np.stack([r.uniform(-8, 8, n), r.uniform(0.05, 3, n),
                   r.uniform(-8, 8, n)], 1).astype(np.float32)
    d2 = r.normal(size=(n, 3)).astype(np.float32)
    o = np.concatenate([np.asarray(o), o2])
    d = np.concatenate([np.asarray(d), d2])
    return js, ts, o, d


def _budgets(t_a, i_a, y_a, t_b, i_b, y_b):
    n = t_a.shape[0]
    ha, hb = t_a < 1e30, t_b < 1e30
    assert (ha != hb).sum() <= max(2, n // 100)
    both = ha & hb
    same = both & (i_a == i_b) & (y_a == y_b)
    assert (both & ~same).sum() <= max(2, n // 40)
    rel = np.abs(t_a - t_b)[same] / np.maximum(np.abs(t_b[same]), 1e-3)
    assert (rel > 5e-3).mean() <= 0.03
    assert rel.max() <= 5e-2
    return both.mean()


def _port(ts, o, d):
    od = torch.as_tensor(np.concatenate([o.T, d.T]))
    mm = ts.mm
    t, i, y = k1.closest_hit(od, 1e-3, (mm.sphere_coeff, mm.tri_coeff,
                                        mm.box_coeff), None,
                             (ts.spheres.count, ts.triangles.count,
                              ts.boxes.count))
    return t.numpy(), i.numpy(), y.numpy()


def test_plain_k1_matches_pallas_interpret(setup):
    js, ts, o, d = setup
    h = pallas_intersect.intersect_brute_pallas_od(
        js, tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)), 1e-3, interpret=True)
    ref = (np.asarray(h.t), np.asarray(h.prim_idx), np.asarray(h.prim_type))
    out = _port(ts, o, d)
    assert _budgets(*out, *ref) > 0.3
    # Same arithmetic (digit split, dot order, fused multiply-adds): the
    # winners agree everywhere and t almost always to the bit.
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[2], ref[2])
    assert (out[0] == ref[0]).mean() > 0.99


def test_plain_k1_matches_brute_oracle(setup):
    js, ts, o, d = setup
    h = jisect.intersect_brute(js, jnp.asarray(o), jnp.asarray(d), 1e-3)
    ref = (np.asarray(h.t), np.asarray(h.prim_idx), np.asarray(h.prim_type))
    _budgets(*_port(ts, o, d), *ref)
    # The port's own oracle is the same exact scan.
    b = tisect.intersect_brute(ts, torch.as_tensor(o), torch.as_tensor(d), 1e-3)
    _budgets(b.t.numpy(), b.prim_idx.numpy(), b.prim_type.numpy(), *ref)
    np.testing.assert_array_equal(b.prim_idx.numpy(), ref[1])


def test_coarsened_bounds_cover_every_primitive(setup):
    """The 512-wide chunk AABBs the kernel culls with contain each chunk's
    primitives, so culling cannot drop a hit."""
    _, ts, _, _ = setup
    b = k1.coarsen_bounds(ts.mm.sphere_bounds).numpy()
    c = ts.spheres.center.numpy()
    r = ts.spheres.radius.numpy()[:, None]
    for k in range(-(-ts.spheres.count // 512)):
        s = slice(512 * k, 512 * (k + 1))
        assert (c[s] - r[s] >= b[k, :3] - 1e-3).all()
        assert (c[s] + r[s] <= b[k, 3:] + 1e-3).all()
