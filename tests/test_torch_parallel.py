"""Pixel windows and sharded renders of the port on the CPU: the fused
window (K3's plain version with pixel_offset) against the reference's
fused pool in interpret mode, shard invariance over CPU windows for both
pool engines and the chunked path, pixel subsets, sample chunking and the
sharded image statistics."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.ops import fused_step as jfs
from raytracer_project_tpu.ops import integrator as jint
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.models.scene import SceneBuilder
from raytracer_project_tpu_torch.ops import fused_step as tfs
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import post as tpost
from raytracer_project_tpu_torch.parallel import render as prender

torch.set_num_threads(2)

CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
              defocus_angle=0.0, focus_dist=10.0)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)
# The reference's shard-invariance tolerance (tests/test_parallel.py:57-63):
# a window's pool sums a pixel's samples in another order.
SHARD_TOL = dict(rtol=3e-6, atol=3e-7)


def test_fused_window_matches_reference():
    """The window [150, 350) of 32x18 @ 2 spp, sample offset 1, through the
    fused pool against the reference's render_pool_fused(interpret=True,
    pixel_offset, n_pixels_local): the tie-robust rule of
    tests/test_torch_render.py on the sums, segments within 0.5%."""
    w, h, spp, off, poff, n_local = 32, 18, 2, 1, 150, 200
    jcfg = jint.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                             max_depth=10, use_albedo=False, use_normal=False,
                             use_z_depth=False)
    ref, rst = jfs.render_pool_fused(
        jpresets.showcase_scene(with_bvh=False),
        jcam.make_camera(image_width=w, image_height=h, **CAM_KW),
        jenv.make_environment(**ENV_KW), jax.random.PRNGKey(5), jcfg,
        sample_offset=off, with_stats=True, interpret=True,
        pixel_offset=poff, n_pixels_local=n_local)
    cfg = tint.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                            max_depth=10, use_albedo=False, use_normal=False,
                            use_z_depth=False)
    out, st = tfs.render_pool_fused(
        tpresets.showcase_scene(),
        tcam.make_camera(image_width=w, image_height=h, **CAM_KW),
        tenv.make_environment(**ENV_KW), 5, cfg, 0, sample_offset=off,
        with_stats=True, pixel_offset=poff, n_pixels_local=n_local)
    assert out.beauty.shape == (n_local, 3)
    d = np.abs(out.beauty.numpy() - np.asarray(ref.beauty))
    assert d.mean() < 1e-3, d.mean()
    assert (d > 3e-3).mean() < 0.005, (d > 3e-3).mean()
    assert abs(st["segments"] - int(rst["segments"])) <= 0.005 * st["segments"]


def _scene():
    b = SceneBuilder()
    ground = b.materials.lambertian("g", (0.5, 0.5, 0.5))
    metal = b.materials.metal("m", (0.9, 0.8, 0.7), fuzz=0.2)
    glass = b.materials.dielectric("d", 1.5)
    light = b.materials.diffuse_light("l", (4.0, 4.0, 4.0))
    b.geometry.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)
    b.geometry.add_sphere((-1.2, 0.5, 0.0), 0.5, metal)
    b.geometry.add_sphere((0.0, 0.5, 0.0), 0.5, glass)
    b.geometry.add_box((0.8, 0.0, -0.4), (1.6, 1.2, 0.4), light)
    return b.build()


@pytest.fixture(scope="module")
def setup():
    """The scene of the reference's tests/test_parallel.py at 25x16 (400
    pixels: 2 windows of 200, or 3 of 134 with 2 padding slots)."""
    cfg = tint.RenderConfig(width=25, height=16, samples_per_pixel=4,
                            max_depth=5, env_mode=tenv.SOLID_COLOR,
                            use_reflection=True)
    cam = tcam.make_camera(image_width=25, image_height=16, vfov=40.0,
                           lookfrom=(0.0, 1.5, 4.0), lookat=(0.0, 0.5, 0.0),
                           defocus_angle=0.4, focus_dist=4.0)
    env = tenv.make_environment(background_color=(0.7, 0.8, 1.0))
    return _scene(), cfg, cam, env


ENGINES = {"fused": dict(), "pool": dict(pool_lanes=700),
           "chunked": dict(wavefront=False)}


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_shard_invariance(setup, engine, n_shards, monkeypatch):
    """Windows on a CPU mesh sum to the one-device render: every buffer
    within the reference's tolerance, and the segments exactly those of
    the frame plus those of the padding slots."""
    scene, cfg, cam, env = setup
    if engine == "pool":
        monkeypatch.setenv("RAYTRACER_TPU_NO_FUSED", "1")
    cfg = dataclasses.replace(cfg, **ENGINES[engine])
    n = cfg.n_pixels
    single, sst = tint.accumulate_samples(scene, cam, env, 42, cfg,
                                          with_stats=True)
    mesh = prender.make_mesh(n_shards, device="cpu")
    ids = prender._padded_pixel_ids(n, n_shards)
    acc, st = prender.sharded_accumulate(scene, cam, env, 42, cfg, ids, 0,
                                         mesh=mesh, with_stats=True)
    assert acc.beauty.shape == (ids.shape[0], 3)
    for name, a, b in zip(acc._fields, acc, single):
        np.testing.assert_allclose(a[:n].numpy(), b.numpy(), **SHARD_TOL,
                                   err_msg=name)
    pad = ids.shape[0] - n
    phantom = 0
    if pad and engine == "fused":
        # The fused window runs past the frame's end on phantom pixels.
        phantom = tint.accumulate_samples(
            scene, cam, env, 42, cfg, pixel_offset=n, n_pixels_local=pad,
            with_stats=True)[1]["segments"]
    elif pad:
        # The unfused pool and the chunked path re-render pixel n - 1.
        phantom = tint.accumulate_samples(
            scene, cam, env, 42, cfg, torch.full((pad,), n - 1),
            with_stats=True)[1]["segments"]
    assert st["segments"] == sst["segments"] + phantom
    img = prender.render_sharded(scene, cam, env, 42, cfg, mesh)
    np.testing.assert_allclose(img["beauty"].numpy().reshape(-1, 3),
                               single.beauty.numpy() / 4, **SHARD_TOL)


def test_sharded_explicit_ids(setup):
    """An id list other than the padded identity renders each shard's
    slice as explicit pixel ids (the unfused pool), in any order."""
    scene, cfg, cam, env = setup
    single = tint.accumulate_samples(scene, cam, env, 42, cfg)
    ids = np.random.default_rng(3).permutation(cfg.n_pixels)
    acc = prender.sharded_accumulate(scene, cam, env, 42, cfg, ids, 0,
                                     mesh=prender.make_mesh(4, device="cpu"))
    np.testing.assert_allclose(acc.beauty.numpy(), single.beauty.numpy()[ids],
                               **SHARD_TOL)


def test_pixel_subset_matches_full(setup):
    """A pixel subset reproduces those pixels of the full render
    (tests/test_parallel.py:68-78)."""
    scene, cfg, cam, env = setup
    full = tint.render(scene, cam, env, 42, cfg, device="cpu")
    ids = torch.tensor([0, 17, 100, 383])
    acc = tint.accumulate_samples(scene, cam, env, 42, cfg, ids)
    np.testing.assert_allclose(acc.beauty.numpy() / cfg.samples_per_pixel,
                               full["beauty"].numpy().reshape(-1, 3)[ids],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("engine", ["fused", "chunked"])
def test_sample_chunking_matches(setup, engine):
    """Two calls of 2 spp sum to one render of 4 (tests/test_parallel.py:
    81-92), for the progressive sessions."""
    scene, cfg, cam, env = setup
    cfg = dataclasses.replace(cfg, **ENGINES[engine])
    full = tint.render(scene, cam, env, 42, cfg, device="cpu")
    half = dataclasses.replace(cfg, samples_per_pixel=2)
    a = tint.accumulate_samples(scene, cam, env, 42, half, sample_offset=0)
    b = tint.accumulate_samples(scene, cam, env, 42, half, sample_offset=2)
    np.testing.assert_allclose((a.beauty + b.beauty).numpy() / 4.0,
                               full["beauty"].numpy().reshape(-1, 3),
                               rtol=1e-6, atol=1e-7)


def test_analyze_sharded(setup):
    """Window statistics combined over the mesh equal the whole image's."""
    scene, cfg, cam, env = setup
    img = tint.render(scene, cam, env, 42, cfg, device="cpu")["beauty"]
    flat = img.reshape(-1, 3)
    whole = tpost.analyze_framebuffer(flat)
    sharded = prender.analyze_sharded(flat, prender.make_mesh(4, device="cpu"))
    torch.testing.assert_close(sharded.average_luminance,
                               whole.average_luminance, rtol=1e-5, atol=0)
    assert float(sharded.max_luminance) == float(whole.max_luminance)
    assert torch.equal(sharded.histogram, whole.histogram)
