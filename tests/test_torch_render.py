"""The port's fused showcase render on the CPU: against the reference's CPU
golden, against the reference's fused render in interpret mode, sample
chunking, the device default, and the no-JAX import rule."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.ops import fused_step as jfs
from raytracer_project_tpu.ops import integrator as jint
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.models import scene as tscene
from raytracer_project_tpu_torch.ops import fused_step as tfs
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import wavefront as twf

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
              defocus_angle=0.0, focus_dist=10.0)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)


@pytest.fixture(scope="module")
def scene():
    return tpresets.showcase_scene()


def _cfg(w, h, spp, **kw):
    return tint.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                             max_depth=10, use_albedo=False, use_normal=False,
                             use_z_depth=False, **kw)


def test_showcase_matches_cpu_golden(scene):
    """64x36 @ 2 spp, seed 0: the reference's smoke stage, its CPU budget
    (utils/smoke.py:144: mean |d| <= 0.01, <= 1% of pixels over 0.05)."""
    cfg = _cfg(64, 36, 2)
    cam = tcam.make_camera(image_width=64, image_height=36, **CAM_KW)
    out = tint.render(scene, cam, tenv.make_environment(**ENV_KW), 0, cfg,
                      device="cpu")
    img = out["beauty"].numpy()
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "smoke_fused_64x36.npz"))["beauty"]
    d = np.abs(img - golden)
    assert np.isfinite(img).all() and img.max() > 0
    assert d.mean() <= 0.01, d.mean()
    assert (d.max(axis=-1) > 0.05).mean() <= 0.01


@pytest.mark.parametrize("env_mode", [tenv.PHYSICAL_SUN, tenv.HDR_MAP])
def test_fused_render_matches_reference(scene, env_mode):
    """32x18 @ 2 spp with a sample offset, against the reference's fused
    pool in interpret mode: the tie-robust rule of
    tests/test_fused_step.py:147-149 on the sums, segments within 0.5%."""
    hdr = np.linspace(0, 2, 8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
    env_kw = dict(ENV_KW, hdr_image=hdr, hdri_rotation=0.5, hdri_tilt=0.2,
                  hdri_roll=0.1, intensity=0.8)
    w, h, spp, offset = 32, 18, 2, 3
    jcfg = jint.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                             max_depth=10, env_mode=env_mode, use_albedo=False,
                             use_normal=False, use_z_depth=False)
    ref, rst = jfs.render_pool_fused(
        jpresets.showcase_scene(with_bvh=False),
        jcam.make_camera(image_width=w, image_height=h, **CAM_KW),
        jenv.make_environment(**env_kw), jax.random.PRNGKey(5), jcfg,
        sample_offset=offset, with_stats=True, interpret=True)
    out, st = tfs.render_pool_fused(
        scene, tcam.make_camera(image_width=w, image_height=h, **CAM_KW),
        tenv.make_environment(**env_kw), 5,
        _cfg(w, h, spp, env_mode=env_mode), 0, sample_offset=offset,
        with_stats=True)
    d = np.abs(out.beauty.numpy() - np.asarray(ref.beauty))
    assert d.mean() < 1e-3, d.mean()
    assert (d > 3e-3).mean() < 0.005, (d > 3e-3).mean()
    assert abs(st["segments"] - int(rst["segments"])) <= 0.005 * st["segments"]


def test_sample_chunking_equals_one_call(scene, monkeypatch):
    """A render split into sample chunks (the path above the 2^24 work-id
    cap) sums to the one-call render: lane streams are (pixel, sample)-keyed."""
    cfg = _cfg(16, 12, 4)
    cam = tcam.make_camera(image_width=16, image_height=12, **CAM_KW)
    env = tenv.make_environment(**ENV_KW)
    one = twf.render_pool(scene, cam, env, 3, cfg)
    # A cap of 2 spp per call at this frame size forces two chunks.
    monkeypatch.setattr(tfs, "_TOTAL_WORK_CAP", 2 * 2 * cfg.n_pixels + 1)
    assert tfs.fused_spp_chunk(scene, cfg, env) == 2
    chunked, st = twf.render_pool(scene, cam, env, 3, cfg, with_stats=True)
    np.testing.assert_allclose(chunked.beauty.numpy(), one.beauty.numpy(),
                               rtol=2e-5, atol=2e-5)
    assert st["steps"] > 0


def test_1080p_spp_chunk():
    """A 1080p render is split into sample chunks below the work-id cap."""
    cfg = _cfg(1920, 1080, 8)
    sc = tpresets.showcase_scene(grid=1, with_meshes=False)
    chunk = tfs.fused_spp_chunk(sc, cfg)
    assert 0 < chunk < 8
    assert chunk == (tfs._TOTAL_WORK_CAP - 1) // (2 * cfg.n_pixels)


def test_render_defaults_to_cuda(scene):
    """render() with no device runs on the card, and never falls back to
    the CPU: without a CUDA device it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    cfg = _cfg(8, 4, 1)
    cam = tcam.make_camera(image_width=8, image_height=4, **CAM_KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tint.render(scene, cam, tenv.make_environment(**ENV_KW), 0, cfg)


def test_out_of_slice_features_raise(scene):
    """Nothing of the render modes stays out of the port now: the
    differentiable mode renders with either engine flag (it always takes
    the chunked engine) and carries finite, non-zero gradients to the
    scene and the environment; textured fog, outside the fused step, renders
    on the unfused pool."""
    cam = tcam.make_camera(image_width=8, image_height=4, **CAM_KW)
    for kw in (dict(differentiable=True),
               dict(differentiable=True, wavefront=False)):
        cfg = dataclasses.replace(_cfg(8, 4, 1), **kw)
        albedo = scene.materials.albedo.clone().requires_grad_(True)
        sky = torch.tensor(1.0, requires_grad=True)
        env = tenv.make_environment(**ENV_KW)._replace(intensity=sky)
        sc = scene._replace(materials=scene.materials._replace(albedo=albedo))
        out, st = tint.render(sc, cam, env, 0, cfg, device="cpu",
                              with_stats=True)
        assert st["steps"] == 1 and "engine" not in st
        grads = torch.autograd.grad(out["beauty"].sum(), (albedo, sky))
        for g in grads:
            assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    env = tenv.make_environment(**ENV_KW)
    b = tscene.SceneBuilder()
    b.geometry.add_sphere((0.0, 0.0, 0.0), 1.0,
                          b.materials.lambertian("m", (0.5, 0.5, 0.5)))
    tex = b.textures.add_checker(0.5, (0.9, 0.9, 0.9), (0.1, 0.1, 0.1))
    b.add_fog_sphere((0.0, 0.0, 0.0), 3.0, 0.1, (1.0, 1.0, 1.0), texture_id=tex)
    out, st = tint.render(b.build(), cam, env, 0, _cfg(8, 4, 1), device="cpu",
                          with_stats=True)
    assert st["engine"] == "pool" and torch.isfinite(out["beauty"]).all()


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) loads neither
    jax nor the reference package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import raytracer_project_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'raytracer_project_tpu' or k.startswith('raytracer_project_tpu.')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
