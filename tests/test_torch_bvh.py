"""The port's BVH (ops/bvh.py), its traversal (ops/traverse.py) and the
closest-hit route (ops/intersect.py intersect_dispatch) against the
reference package on the CPU: the Python builds in both modes and the
native SAH build give the reference's arrays bit for bit; the traversal
finds the jitted reference traversal's hits on the reference's own tree;
the SAH and median trees resolve the same hits; the route table; and a
chunked render on the "bvh" route against the jitted reference render."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.ops import bvh as jbvh
from raytracer_project_tpu.ops import integrator as jint
from raytracer_project_tpu.ops import traverse as jtraverse
from raytracer_project_tpu_torch import native
from raytracer_project_tpu_torch.bench import FUNNEL_CAM
from raytracer_project_tpu_torch.core import rng as trng
from raytracer_project_tpu_torch.core.constants import T_MIN
from raytracer_project_tpu_torch.core.tree import flatten
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.models.scene import scene_from_numpy
from raytracer_project_tpu_torch.ops import bvh as tbvh
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import intersect as tis
from raytracer_project_tpu_torch.ops import traverse as ttraverse

torch.set_num_threads(2)

ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)


def _jax_bvh_flat(b) -> dict:
    """{field: numpy} of a reference FlatBVH (a dataclass)."""
    return {f.name: np.asarray(getattr(b, f.name))
            for f in dataclasses.fields(b)}


def _jax_scene_flat(scene) -> dict:
    """{dotted path: numpy} of a reference scene, the BVH included."""
    out = {}

    def walk(obj, prefix):
        if obj is None:
            return
        if hasattr(obj, "_fields"):
            for name, val in zip(obj._fields, obj):
                walk(val, f"{prefix}.{name}" if prefix else name)
        elif dataclasses.is_dataclass(obj):
            for k, v in _jax_bvh_flat(obj).items():
                out[f"{prefix}.{k}"] = v
        else:
            out[prefix] = np.asarray(obj)

    walk(scene, "")
    return out


def _assert_bvh_equal(ref: dict, got):
    for name, a in ref.items():
        b = getattr(got, name)
        if isinstance(b, int):
            assert int(a) == b, name
            continue
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)


@pytest.fixture(scope="module")
def small_scenes():
    """Shirley grid 4 (spheres) and the showcase grid 3 (spheres, mesh
    triangles, boxes), without a BVH, from both packages."""
    return {
        "shirley": (jpresets.shirley_final_scene(grid=4, with_bvh=False),
                    tpresets.shirley_final_scene(grid=4, with_bvh=False)),
        "showcase": (jpresets.showcase_scene(grid=3, with_bvh=False),
                     tpresets.showcase_scene(grid=3, with_bvh=False)),
    }


@pytest.mark.parametrize("mode", ["sah", "median_random_axis"])
@pytest.mark.parametrize("name", ["shirley", "showcase"])
def test_python_build_bit_equal(small_scenes, name, mode):
    jsc, tsc = small_scenes[name]
    ref = jbvh.build_bvh(jsc, mode=mode, seed=9, use_native=False,
                         as_numpy=True)
    got = tbvh.build_bvh(tsc, mode=mode, seed=9, use_native=False)
    _assert_bvh_equal(_jax_bvh_flat(ref), got)


def test_native_build_bit_equal(small_scenes):
    """Both packages compile the same source with the same flags: the
    native SAH trees agree bit for bit, here and on an 8,963-primitive
    funnel."""
    assert native.available()
    funnel = (jpresets.bvh_stress_scene(n_spheres=512, mesh_detail=1,
                                        with_bvh=False),
              tpresets.bvh_stress_scene(n_spheres=512, mesh_detail=1,
                                        with_bvh=False))
    for jsc, tsc in (small_scenes["showcase"], funnel):
        ref = jbvh.build_bvh(jsc, use_native=True, as_numpy=True)
        got = tbvh.build_bvh(tsc, use_native=True)
        _assert_bvh_equal(_jax_bvh_flat(ref), got)


def test_builder_attaches_bvh():
    """SceneBuilder.build(with_bvh=True) carries the tree, numpy hand-over
    keeps it, and Scene.to moves it."""
    sc = tpresets.shirley_final_scene(grid=2)
    assert isinstance(sc.bvh, tbvh.FlatBVH) and sc.bvh.node_count > 1
    again = scene_from_numpy(flatten(sc))
    _assert_bvh_equal({k: v.numpy() if isinstance(v, torch.Tensor) else v
                       for k, v in sc.bvh._asdict().items()}, again.bvh)
    assert sc.to("cpu").bvh.leaf_size == sc.bvh.leaf_size


def test_traversal_matches_jitted_reference():
    """512 camera rays of the funnel camera (128x72) on
    bvh_stress_scene(n_spheres=9000), the reference's own tree handed over
    through scene_from_numpy: the same hit set, primitive types and rows,
    t within rtol/atol 2e-4 (the reference's bvh-traverse gate)."""
    jsc = jpresets.bvh_stress_scene(n_spheres=9000)
    tsc = scene_from_numpy(_jax_scene_flat(jsc))
    assert tsc.bvh.node_count == jsc.bvh.node_count
    r = np.random.default_rng(7)
    px = torch.as_tensor(r.integers(0, 128 * 72, 512))
    cam = tcam.make_camera(image_width=128, image_height=72, **FUNNEL_CAM)
    lr = trng.lane_rng(trng.seed_from_int(8), px, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, px, 128)
    ref = jax.jit(lambda o, d: jtraverse.intersect_bvh(jsc, o, d, 1e-3))(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    stats = {}
    got = ttraverse.intersect_bvh(tsc, o, d, 1e-3, stats)
    hit = np.asarray(ref.hit)
    assert 100 < hit.sum() < 512 and stats["iterations"] > 10
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.prim_type.numpy()[hit],
                                  np.asarray(ref.prim_type)[hit])
    np.testing.assert_array_equal(got.prim_idx.numpy()[hit],
                                  np.asarray(ref.prim_idx)[hit])
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=2e-4, atol=2e-4)
    brute = tis.intersect_brute(tsc, o, d, 1e-3)
    assert torch.equal(brute.hit, got.hit)
    assert torch.equal(brute.prim_idx[got.hit], got.prim_idx[got.hit])


def test_bvh_mode_hit_invariant():
    """The reference engine's median/random-axis build (bvh.hpp:15-42) and
    the default binned-SAH build resolve the same closest hits (port of
    tests/test_goldens.py test_bvh_mode_hit_invariant)."""
    scene = tpresets.shirley_final_scene(grid=4, with_bvh=False)
    r = np.random.default_rng(5)
    n = 512
    o = torch.as_tensor(r.uniform(-14, 14, (n, 3)).astype(np.float32))
    d = torch.as_tensor(r.normal(size=(n, 3)).astype(np.float32))
    hits = {}
    for mode in ("sah", "median_random_axis"):
        s = scene._replace(bvh=tbvh.build_bvh(scene, mode=mode, seed=9))
        hits[mode] = ttraverse.intersect_bvh(s, o, d, T_MIN)
    for a, b in zip(hits["sah"], hits["median_random_axis"]):
        assert torch.equal(a, b)
    assert hits["sah"].hit.any()


@pytest.mark.parametrize("device,above,with_bvh,with_mm,route", [
    ("cpu", True, True, True, "bvh"),
    ("cpu", False, True, True, "k4"),
    ("cpu", True, False, True, "k4"),
    ("cpu", True, True, False, "bvh"),
    ("cpu", False, True, False, "brute"),
    ("cpu", True, False, False, "brute"),
    ("cuda", True, True, True, "k4"),
    ("cuda", False, True, True, "k4"),
    ("cuda", True, False, True, "k4"),
    ("cuda", True, True, False, "bvh"),
    ("cuda", False, False, False, "brute"),
])
def test_route_table(small_scenes, monkeypatch, device, above, with_bvh,
                     with_mm, route):
    """The route by the rays' device, below and above BVH_MIN_PRIMS, with
    and without a BVH and coefficient tables: the card takes K4 whenever
    the scene has tables; elsewhere the reference's order, BVH first."""
    tsc = small_scenes["shirley"][1]
    sc = tsc._replace(bvh=tbvh.build_bvh(tsc) if with_bvh else None,
                      mm=tsc.mm if with_mm else None)
    n = sc.primitive_count
    monkeypatch.setattr(tis, "BVH_MIN_PRIMS", n if above else n + 1)
    assert tis.intersect_dispatch(sc, torch.device(device)) == route


def test_chunked_render_on_bvh_route():
    """bvh_stress_scene(n_spheres=8192) (8,196 primitives, past
    BVH_MIN_PRIMS) at 16x9 @ 2 spp, depth 3: the chunked render takes the
    "bvh" route on the CPU and matches the jitted reference render under
    the tie-robust rule of tests/test_torch_chunked.py (mean |d| < 1e-3,
    < 0.5% of values over 3e-3)."""
    tsc = tpresets.bvh_stress_scene(n_spheres=8192)
    assert tis.intersect_dispatch(tsc, torch.device("cpu")) == "bvh"
    assert tis.hit_tables(tsc) is None
    jsc = jpresets.bvh_stress_scene(n_spheres=8192)
    kw = dict(width=16, height=9, samples_per_pixel=2, max_depth=3,
              wavefront=False)
    ref = jax.jit(jint.render, static_argnames="config")(
        jsc, jcam.make_camera(image_width=16, image_height=9, **FUNNEL_CAM),
        jenv.make_environment(**ENV_KW), jax.random.PRNGKey(4),
        jint.RenderConfig(**kw))
    out = tint.render(tsc, tcam.make_camera(image_width=16, image_height=9,
                                            **FUNNEL_CAM),
                      tenv.make_environment(**ENV_KW), 4,
                      tint.RenderConfig(**kw), device="cpu")
    for name in ("beauty", "albedo", "normal", "z_depth"):
        d = np.abs(out[name].numpy() - np.asarray(ref[name]))
        assert d.mean() < 1e-3, (name, d.mean())
        assert (d > 3e-3).mean() < 0.005, (name, (d > 3e-3).mean())
    assert out["beauty"].numpy().max() > 0
