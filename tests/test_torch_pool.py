"""The port's unfused pool on the CPU against the reference's
(wavefront.render_pool, which runs the unfused pool off the TPU): all six
buffers, sorted lanes, fog with a textured phase material, a pool bigger
than the work, progressive sample offsets and the engine routing. The
reference's pool-render golden (smoke_pool_128x72.npz) takes over a
minute on two CPU threads; the card's pool smoke (chip_smoke.py,
tests/test_torch_cuda.py) holds it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.models.scene import SceneBuilder as JBuilder
from raytracer_project_tpu.ops import integrator as jint
from raytracer_project_tpu.ops import wavefront as jwf
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import wavefront as twf

torch.set_num_threads(2)

CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
              defocus_angle=0.0, focus_dist=10.0)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)
ALL_BUFFERS = dict(use_albedo=True, use_normal=True, use_z_depth=True,
                   use_reflection=True, use_refraction=True)


@pytest.fixture(scope="module")
def scenes():
    return jpresets.showcase_scene(with_bvh=False), tpresets.showcase_scene()


def _reference(jscene, cfg_kw, seed, pixel_ids, sample_offset=0, cam_kw=CAM_KW,
               env_kw=ENV_KW):
    """The reference's unfused pool, jitted: (SampleBuffers, stats)."""
    cfg = jint.RenderConfig(**cfg_kw)
    cam = jcam.make_camera(image_width=cfg.width, image_height=cfg.height,
                           **cam_kw)
    fn = jax.jit(lambda sc, c, e, k, ids: jwf.render_pool(
        sc, c, e, k, cfg, ids, sample_offset, pool_lanes=cfg.pool_lanes,
        with_stats=True))
    out, st = fn(jscene, cam, jenv.make_environment(**env_kw),
                 jax.random.PRNGKey(seed), jnp.asarray(pixel_ids, jnp.int32))
    return out, {k: int(v) for k, v in st.items()}


def _port(tscene, cfg_kw, seed, pixel_ids, sample_offset=0, cam_kw=CAM_KW,
          env_kw=ENV_KW):
    cfg = tint.RenderConfig(**cfg_kw)
    cam = tcam.make_camera(image_width=cfg.width, image_height=cfg.height,
                           **cam_kw)
    return twf.render_pool(tscene, cam, tenv.make_environment(**env_kw), seed,
                           cfg, torch.as_tensor(pixel_ids), sample_offset,
                           with_stats=True)


def _assert_tie_robust(out, st, ref, rst):
    """tests/test_torch_render.py's rule: mean |d| < 1e-3 and at most 0.5%
    of values over 3e-3 per buffer, segments within 0.5%."""
    for name, a, b in zip(out._fields, out, ref):
        d = np.abs(a.numpy() - np.asarray(b))
        assert d.mean() < 1e-3, (name, d.mean())
        assert (d > 3e-3).mean() < 0.005, (name, (d > 3e-3).mean())
    assert abs(st["segments"] - rst["segments"]) <= 0.005 * st["segments"]


def _kw(w, h, spp, **kw):
    return dict(width=w, height=h, samples_per_pixel=spp, max_depth=10, **kw)


def test_unfused_pool_matches_reference(scenes):
    """32x18 @ 2 spp, all six buffers, sample offset 1 (one AOV sample of
    the aux budget 2 in range), pixels in a shuffled order."""
    ids = np.random.default_rng(0).permutation(32 * 18)
    kw = _kw(32, 18, 2, **ALL_BUFFERS)
    ref, rst = _reference(scenes[0], kw, 5, ids, sample_offset=1)
    out, st = _port(scenes[1], kw, 5, ids, sample_offset=1)
    assert st["engine"] == "pool"
    for name in ("beauty", "albedo", "normal", "z_depth", "reflection"):
        assert float(getattr(out, name).abs().max()) > 0, name
    _assert_tie_robust(out, st, ref, rst)


def test_coherence_order_matches_reference():
    """_coherence_order is the reference's lane permutation bit for bit."""
    rng = np.random.default_rng(1)
    p = 4096
    o = rng.normal(size=(3, p)).astype(np.float32) * 5.0
    d = rng.normal(size=(3, p)).astype(np.float32)
    live = rng.random(p) < 0.7
    ref = jwf._coherence_order(tuple(jnp.asarray(x) for x in o),
                               tuple(jnp.asarray(x) for x in d),
                               jnp.asarray(live))
    out = twf._coherence_order(tuple(torch.as_tensor(x) for x in o),
                               tuple(torch.as_tensor(x) for x in d),
                               torch.as_tensor(live))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sort_lanes_matches_reference(scenes):
    """sort_lanes is scheduling only: the sorted pool holds the reference's
    sorted pool, and the unsorted one within float reassociation."""
    ids = np.arange(24 * 16)
    kw = _kw(24, 16, 2, pool_lanes=512, sort_lanes=True, use_albedo=False,
             use_normal=False, use_z_depth=False)
    ref, rst = _reference(scenes[0], kw, 2, ids)
    out, st = _port(scenes[1], kw, 2, ids)
    _assert_tie_robust(out, st, ref, rst)
    plain, pst = _port(scenes[1], dict(kw, sort_lanes=False), 2, ids)
    assert pst["segments"] == st["segments"]
    np.testing.assert_allclose(out.beauty.numpy(), plain.beauty.numpy(),
                               rtol=3e-4, atol=3e-5)


def _fog_scene(builder_cls):
    b = builder_cls()
    gray = b.materials.lambertian("gray", (0.5, 0.5, 0.5))
    lamp = b.materials.diffuse_light("lamp", (5.0, 5.0, 5.0))
    b.geometry.add_sphere((0.0, -100.5, 0.0), 100.0, gray)
    b.geometry.add_sphere((0.0, 0.5, 0.0), 0.5, gray)
    b.geometry.add_box((0.8, 0.0, -0.4), (1.6, 1.2, 0.4), lamp)
    tex = b.textures.add_checker(0.3, (0.9, 0.2, 0.2), (0.1, 0.8, 0.3))
    b.add_fog_sphere((0.0, 0.5, 0.0), 1.5, 0.6, (1.0, 1.0, 1.0), texture_id=tex)
    b.add_fog_box((-2.0, 0.0, -1.0), (-1.0, 1.0, 0.0), 0.8, (0.8, 0.8, 0.9))
    return b.build(with_bvh=False)


FOG_CAM = dict(vfov=40.0, lookfrom=(0.0, 1.0, 4.0), lookat=(0.0, 0.5, 0.0))


def test_pool_with_textured_fog(scenes):
    """Fog with a textured phase material (outside the fused step) renders
    on the unfused pool through integrator.render, and holds the
    reference's pool."""
    ids = np.arange(24 * 16)
    kw = _kw(24, 16, 2, use_albedo=True, use_normal=False, use_z_depth=False)
    ref, rst = _reference(_fog_scene(JBuilder), kw, 4, ids, cam_kw=FOG_CAM)
    tscene = _fog_scene(TBuilder)
    out, st = _port(tscene, kw, 4, ids, cam_kw=FOG_CAM)
    _assert_tie_robust(out, st, ref, rst)
    cfg = tint.RenderConfig(**kw)
    img, rs = tint.render(tscene, tcam.make_camera(image_width=24, image_height=16,
                                                   **FOG_CAM),
                          tenv.make_environment(**ENV_KW), 4, cfg, device="cpu",
                          with_stats=True)
    assert rs["engine"] == "pool"
    np.testing.assert_allclose(img["beauty"].numpy().reshape(-1, 3),
                               out.beauty.numpy() / 2, rtol=3e-6, atol=3e-7)


def test_pool_bigger_than_work(scenes):
    """A pool of more lanes than work items holds the default pool."""
    ids = np.arange(16 * 12)
    kw = _kw(16, 12, 2, use_albedo=False, use_normal=False, use_z_depth=False)
    a, sa = _port(scenes[1], kw, 7, ids)
    b, sb = _port(scenes[1], dict(kw, pool_lanes=4096), 7, ids)
    assert sb["steps"] <= sa["steps"] and sa["segments"] == sb["segments"]
    np.testing.assert_allclose(a.beauty.numpy(), b.beauty.numpy(), rtol=3e-6,
                               atol=3e-7)


def test_progressive_offset(scenes):
    """Two calls of 2 spp from offsets 0 and 2 sum to one call of 4 spp."""
    ids = np.arange(16 * 12)
    kw4 = _kw(16, 12, 4, use_normal=False, use_z_depth=False)
    one, _ = _port(scenes[1], kw4, 3, ids)
    kw2 = dict(kw4, samples_per_pixel=2)
    a, _ = _port(scenes[1], kw2, 3, ids, sample_offset=0)
    b, _ = _port(scenes[1], kw2, 3, ids, sample_offset=2)
    np.testing.assert_allclose((a.beauty + b.beauty).numpy(),
                               one.beauty.numpy(), rtol=3e-6, atol=3e-7)
    # A call counts the AOVs of absolute sample ids below its own
    # min(aux_samples, spp), 2 here: the second call's samples 2-3 none.
    assert float(a.albedo.abs().max()) > 0
    assert float(b.albedo.abs().max()) == 0


def test_engine_routing(scenes, monkeypatch):
    """Identity frames take the fused pool, explicit pixel ids and
    RAYTRACER_TPU_NO_FUSED the unfused one; both engines give one sum."""
    cfg = tint.RenderConfig(**_kw(12, 8, 2, use_albedo=False, use_normal=False,
                                  use_z_depth=False))
    cam = tcam.make_camera(image_width=12, image_height=8, **CAM_KW)
    env = tenv.make_environment(**ENV_KW)
    fused, fs = twf.render_pool(scenes[1], cam, env, 1, cfg, with_stats=True)
    ident, si = twf.render_pool(scenes[1], cam, env, 1, cfg,
                                np.arange(96), with_stats=True)
    sub, ss = twf.render_pool(scenes[1], cam, env, 1, cfg,
                              np.arange(0, 96, 2), with_stats=True)
    monkeypatch.setenv("RAYTRACER_TPU_NO_FUSED", "1")
    pool, ps = twf.render_pool(scenes[1], cam, env, 1, cfg, with_stats=True)
    assert (fs["engine"], si["engine"], ss["engine"], ps["engine"]) == (
        "fused", "fused", "pool", "pool")
    assert fs["segments"] == ps["segments"]
    np.testing.assert_allclose(pool.beauty.numpy(), fused.beauty.numpy(),
                               rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(sub.beauty.numpy(), pool.beauty.numpy()[::2],
                               rtol=3e-6, atol=3e-7)
