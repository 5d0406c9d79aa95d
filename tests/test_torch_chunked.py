"""The port's chunked integrator (RenderConfig(wavefront=False)) and K4,
its prebuilt-feature closest hit, on the CPU: K4's plain version against
the reference's Pallas kernel in interpret mode, ties included; the
chunked render against the reference's chunked render (all six buffers)
and against the reference's CPU golden."""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.ops import intersect as jis
from raytracer_project_tpu.ops import integrator as jint
from raytracer_project_tpu.ops import pallas_intersect as jpi
from raytracer_project_tpu_torch.core import rng as trng
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.ops import closest_hit as k4
from raytracer_project_tpu_torch.ops import intersect as tis
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import shade as tsh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)
HDR = np.linspace(0, 2, 8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
HDR_KW = dict(hdr_image=HDR, hdri_rotation=0.5, hdri_tilt=0.2, hdri_roll=0.1,
              intensity=0.8)
BUFFERS = ("beauty", "albedo", "normal", "z_depth", "reflection", "refraction")


@pytest.fixture(scope="module")
def scenes():
    return jpresets.showcase_scene(with_bvh=False), tpresets.showcase_scene()


@pytest.fixture(scope="module")
def rays(scenes):
    """4,096 showcase rays: 64x32 camera rays (seed 3) and one scatter of
    each, as numpy."""
    _, tsc = scenes
    cam = tcam.make_camera(image_width=64, image_height=32, **CAM_KW)
    pix = torch.arange(64 * 32)
    lr = trng.lane_rng(trng.seed_from_int(3), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 64)
    rec = tis.make_record(tsc, o, d, tis.intersect(tsc, o, d, 1e-3,
                                                   tis.hit_tables(tsc)))
    sc = tsh.scatter(tsc, rec, d, lr)
    return (torch.cat([o, sc.origin]).numpy(),
            torch.cat([d, sc.direction]).numpy())


def test_feature_rows_match_compiled_reference(rays):
    """The chunked path's features equal, bit for bit, the reference's
    ray_features as its compiled render computes them."""
    o, d = rays
    ref = jax.jit(jis.ray_features)(jnp.asarray(o), jnp.asarray(d))
    out = tis.ray_feature_rows(torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(np.asarray(ref).T, out.numpy())


def test_k4_plain_matches_pallas_interpret(scenes, rays):
    """K4's plain version against the reference's _closest_hit_kernel in
    interpret mode on the same rays: identical idx and type, t within 1e-6
    relative; and the same hits as intersect.intersect gives."""
    jsc, tsc = scenes
    o, d = rays
    ref = jax.jit(lambda o, d: jpi.intersect_brute_pallas(
        jsc, o, d, 1e-3, interpret=True))(jnp.asarray(o), jnp.asarray(d))
    feats = tis.ray_feature_rows(torch.as_tensor(o), torch.as_tensor(d))
    t, idx, typ = k4.closest_hit_feats(feats, 1e-3, k4.scan_tables(tsc))
    hits = np.asarray(ref.hit)
    assert 1000 < hits.sum() < len(hits)
    np.testing.assert_array_equal(np.asarray(ref.prim_idx), idx.numpy())
    np.testing.assert_array_equal(np.asarray(ref.prim_type), typ.numpy())
    np.testing.assert_allclose(np.asarray(ref.t), t.numpy(), rtol=1e-6, atol=0)
    h = tis.intersect(tsc, torch.as_tensor(o), torch.as_tensor(d), 1e-3,
                      tis.hit_tables(tsc))
    assert torch.equal(h.t, t) and torch.equal(h.prim_idx, idx)
    assert torch.equal(h.hit, t < 1e30)


def test_k4_plain_tie_order():
    """Two identical triangles at rows 5 and 200 (different 128-wide chunks
    of one 512-wide chunk): the reference's 128-wide argmin scan and its
    Pallas kernel keep row 5, and so does K4's plain version."""
    r = np.random.default_rng(0)
    nt = 300
    v0 = np.stack([r.uniform(-50, 50, nt), r.uniform(-50, 50, nt),
                   np.full(nt, -100.0)], 1).astype(np.float32)
    e1 = np.tile(np.float32([0.5, 0.0, 0.0]), (nt, 1))
    e2 = np.tile(np.float32([0.0, 0.5, 0.0]), (nt, 1))
    for row in (5, 200):
        v0[row] = (-2.0, -2.0, 0.0)
        e1[row] = (6.0, 0.0, 0.0)
        e2[row] = (0.0, 6.0, 0.0)
    sph = types.SimpleNamespace(center=np.float32([[0.0, 0.0, 50.0]]),
                                radius=np.float32([1.0]), count=1)
    tri = types.SimpleNamespace(v0=v0, e1=e1, e2=e2, count=nt)
    n = 256
    o = np.stack([r.uniform(-0.5, 0.5, n), r.uniform(-0.5, 0.5, n),
                  np.full(n, 5.0)], 1).astype(np.float32)
    d = np.stack([r.uniform(-0.05, 0.05, n), r.uniform(-0.05, 0.05, n),
                  np.full(n, -1.0)], 1).astype(np.float32)

    jmm = jis.build_mm_tables(sph, tri)
    jscene = types.SimpleNamespace(mm=jmm, spheres=sph, triangles=tri,
                                   boxes=None)
    ref_mm = jis.intersect_brute_mm(jscene, jnp.asarray(o), jnp.asarray(d), 1e-3)
    ref_pl = jpi.intersect_brute_pallas(jscene, jnp.asarray(o), jnp.asarray(d),
                                        1e-3, interpret=True)
    tscene = types.SimpleNamespace(mm=tis.build_mm_tables(sph, tri).to("cpu"),
                                   spheres=sph, triangles=tri, boxes=None)
    feats = tis.ray_feature_rows(torch.as_tensor(o), torch.as_tensor(d))
    t, idx, typ = k4.closest_hit_feats(feats, 1e-3, k4.scan_tables(tscene))
    assert (idx.numpy() == 5).all() and (typ.numpy() == 1).all()
    for ref in (ref_mm, ref_pl):
        np.testing.assert_array_equal(np.asarray(ref.prim_idx), idx.numpy())
        np.testing.assert_array_equal(np.asarray(ref.prim_type), typ.numpy())


def test_dispatch_routes(scenes, monkeypatch):
    """Off the card: the BVH from BVH_MIN_PRIMS primitives on, else
    coefficient tables -> K4's plain version, else the brute-force oracle,
    all with the same hits here; on the card K4 whenever the scene has
    coefficient tables."""
    _, tsc = scenes
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tis.intersect_dispatch(tsc, cpu) == "k4"
    bare = tsc._replace(mm=None)
    assert tis.intersect_dispatch(bare, cpu) == "brute"
    r = np.random.default_rng(1)
    o = torch.as_tensor(np.tile(np.float32([12.0, 2.5, 6.0]), (512, 1)))
    d = torch.as_tensor(np.stack([r.uniform(-16, -8, 512), r.uniform(-3, 0, 512),
                                  r.uniform(-10, -2, 512)], 1).astype(np.float32))
    a = tis.intersect(tsc, o, d, 1e-3, tis.hit_tables(tsc))
    b = tis.intersect(bare, o, d, 1e-3, tis.hit_tables(bare))
    assert torch.equal(a.hit, b.hit) and torch.equal(a.prim_idx, b.prim_idx)
    monkeypatch.setattr(tis, "BVH_MIN_PRIMS", 100)
    assert tis.intersect_dispatch(tsc, cpu) == "bvh"
    assert tis.intersect_dispatch(tsc, cuda) == "k4"
    assert tis.hit_tables(tsc) is None
    c = tis.intersect(tsc, o, d, 1e-3, None)
    assert torch.equal(a.hit, c.hit) and torch.equal(a.prim_idx, c.prim_idx)


@pytest.mark.parametrize("env_mode", [tenv.PHYSICAL_SUN, tenv.HDR_MAP])
def test_chunked_render_matches_reference(scenes, env_mode):
    """32x18 @ 2 spp, all six buffers on, against the reference's compiled
    chunked render (PRNGKey(5)): on every buffer the tie-robust rule of
    tests/test_torch_render.py (mean |d| < 1e-3, < 0.5% of values over
    3e-3)."""
    jsc, tsc = scenes
    w, h = 32, 18
    env_kw = dict(ENV_KW, **HDR_KW) if env_mode == tenv.HDR_MAP else ENV_KW
    kw = dict(width=w, height=h, samples_per_pixel=2, max_depth=10,
              env_mode=env_mode, use_reflection=True, use_refraction=True,
              wavefront=False)
    ref = jax.jit(jint.render, static_argnames="config")(
        jsc, jcam.make_camera(image_width=w, image_height=h, **CAM_KW),
        jenv.make_environment(**env_kw), jax.random.PRNGKey(5),
        jint.RenderConfig(**kw))
    out, stats = tint.render(
        tsc, tcam.make_camera(image_width=w, image_height=h, **CAM_KW),
        tenv.make_environment(**env_kw), 5, tint.RenderConfig(**kw),
        device="cpu", with_stats=True)
    assert stats["steps"] == 1 and stats["segments"] > 2 * w * h
    assert sorted(out) == sorted(BUFFERS)
    for name in BUFFERS:
        d = np.abs(out[name].numpy() - np.asarray(ref[name]))
        assert d.mean() < 1e-3, (name, d.mean())
        assert (d > 3e-3).mean() < 0.005, (name, (d > 3e-3).mean())
    assert out["normal"].numpy().min() >= 0.0
    assert float(out["z_depth"].max()) > 0.0


def test_chunked_render_matches_cpu_golden(scenes):
    """tests/goldens/showcase.npz (64x36 @ 8 spp, depth 6, seed 0, the
    reference's chunked render) under the reference's CPU budget: mean |d|
    <= 0.01, <= 1% of pixels over 0.05."""
    cfg = tint.RenderConfig(width=64, height=36, samples_per_pixel=8,
                            max_depth=6, use_albedo=False, use_normal=False,
                            use_z_depth=False, wavefront=False)
    out = tint.render(tpresets.showcase_scene(grid=6),
                      tcam.make_camera(image_width=64, image_height=36, **CAM_KW),
                      tenv.make_environment(**ENV_KW), 0, cfg, device="cpu")
    img = out["beauty"].numpy()
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "showcase.npz"))["beauty"]
    d = np.abs(img - golden)
    assert np.isfinite(img).all() and img.max() > 0
    assert d.mean() <= 0.01, d.mean()
    assert (d.max(axis=-1) > 0.05).mean() <= 0.01


def test_chunked_render_defaults_to_cuda(scenes):
    """The chunked integrator with no device runs on the card, and without
    a CUDA device it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg = tint.RenderConfig(width=8, height=4, samples_per_pixel=1,
                            wavefront=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tint.render(scenes[1], tcam.make_camera(image_width=8, image_height=4,
                                                **CAM_KW),
                    tenv.make_environment(**ENV_KW), 0, cfg)


def test_aux_budget_and_sample_batches(scenes):
    """Samples split over chunks sum as one chunk does (lane streams are
    (pixel, sample)-keyed), and the AOVs average over the aux budget
    min(clamp(spp/8, 64, 1024), spp)."""
    _, tsc = scenes
    cam = tcam.make_camera(image_width=12, image_height=8, **CAM_KW)
    env = tenv.make_environment(**ENV_KW)
    cfg = tint.RenderConfig(width=12, height=8, samples_per_pixel=3,
                            max_depth=4, use_reflection=True, wavefront=False)
    one = tint.accumulate_samples(tsc, cam, env, 2, cfg)
    split, st = tint.accumulate_samples(
        tsc, cam, env, 2, dataclasses.replace(cfg, samples_per_batch=2),
        with_stats=True)
    assert st["steps"] == 2
    for a, b in zip(one, split):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    assert cfg.aux_samples == 64
    img = tint.finalize_buffers(one, cfg)
    torch.testing.assert_close(img["albedo"].reshape(-1, 3),
                               one.albedo / 3.0)
