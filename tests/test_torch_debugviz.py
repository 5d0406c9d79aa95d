"""The port's BVH wireframe (ops/debugviz.py) on the CPU against the
reference's (raytracer_project_tpu/ops/debugviz.py): the edge scan on
pixel-center rays, the composite into a beauty buffer, the full-frame
debug render with the reference's threefry camera draws, the session's
display_wire, and the reference test's four cases (tests/test_debugviz.py)
on the port. Inputs: the reference test's `_scene` and the showcase, built
in both packages from the same numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_project_tpu.core import rng as jrng
from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.models.scene import SceneBuilder as JBuilder
from raytracer_project_tpu.ops import debugviz as jdv
from raytracer_project_tpu.ops import integrator as jint
from raytracer_project_tpu_torch.core import rng
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer_project_tpu_torch.ops import debugviz as tdv
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import post as tpost
from raytracer_project_tpu_torch.utils.session import RenderSession, to_u8

torch.set_num_threads(2)

THREE_CAM = dict(lookfrom=(0, 2.0, 8.0), lookat=(0, 0, 0), vfov=45.0)
SHOWCASE_CAM = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0),
                    lookat=(0.0, 1.0, 0.0))
# Edge t: relative tolerance; rays whose level or any_sel may differ
# because they graze an edge's thickness test: at most this share.
T_RTOL = 1e-5
GRAZE_FRAC = 0.002


def _three(builder):
    b = builder()
    m = b.materials.lambertian("m", (0.5, 0.5, 0.5))
    for x in (-2.0, 0.0, 2.0):
        b.geometry.add_sphere((x, 0.0, 0.0), 0.8, m)
    return b.build(with_bvh=True)


@pytest.fixture(scope="module")
def scenes():
    return {"three": (_three(JBuilder), _three(TBuilder), THREE_CAM),
            "showcase": (jpresets.showcase_scene(), tpresets.showcase_scene(),
                         SHOWCASE_CAM)}


def _center_rays(cam_kw, w, h):
    cam = jcam.make_camera(image_width=w, image_height=h, **cam_kw)
    ii = jnp.tile(jnp.arange(w, dtype=jnp.float32), h)
    jj = jnp.repeat(jnp.arange(h, dtype=jnp.float32), w)
    d = (cam.pixel00[None, :] + ii[:, None] * cam.pixel_delta_u[None, :]
         + jj[:, None] * cam.pixel_delta_v[None, :] - cam.center[None, :])
    return jnp.broadcast_to(cam.center, d.shape), d


@pytest.mark.parametrize("name,level,thickness", [
    ("three", -1, 2.0), ("showcase", -1, 2.0), ("showcase", -1, 0.01),
    ("showcase", 2, 0.01), ("showcase", 1, 0.5)])
def test_edge_scan_matches_reference(scenes, name, level, thickness):
    """Center rays of a 160x90 frame: edge t within T_RTOL where both find
    an edge; levels, any_sel and which rays find an edge equal except on at
    most GRAZE_FRAC of the rays."""
    js, ts, cam_kw = scenes[name]
    o, d = _center_rays(cam_kw, 160, 90)
    et, el, es = (np.asarray(x) for x in jdv.bvh_edge_scan(
        js, o, d, level=level, thickness=thickness))
    gt, gl, gs = (x.numpy() for x in tdv.bvh_edge_scan(
        ts, torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
        level=level, thickness=thickness))
    assert (et < 1e30).any()
    both = (et < 1e30) & (gt < 1e30)
    np.testing.assert_allclose(gt[both], et[both], rtol=T_RTOL)
    grazing = ((et < 1e30) != (gt < 1e30)) | (el != gl) | (es != gs)
    assert grazing.mean() <= GRAZE_FRAC, grazing.sum()


def test_camera_draws_match_reference():
    """The threefry per-pixel draws of render_bvh_debug: the jitter bit for
    bit, the disk point to cos/sin's last ulp."""
    ids = jnp.arange(2048, dtype=jnp.int32)
    jk, dk = jrng.split_each(jrng.per_lane_keys(jax.random.PRNGKey(7), ids), 2)
    (jx, jy), (r0, r1) = rng.camera_draws_threefry(rng.Key(0, 7),
                                                   torch.arange(2048))
    off = np.asarray(jrng.square_jitter_each(jk))
    disk = np.asarray(jrng.in_unit_disk_each(dk))
    np.testing.assert_array_equal(jx.numpy(), off[:, 0])
    np.testing.assert_array_equal(jy.numpy(), off[:, 1])
    np.testing.assert_allclose(r0.numpy(), disk[:, 0], atol=2e-7)
    np.testing.assert_allclose(r1.numpy(), disk[:, 1], atol=2e-7)


def _cams(cam_kw, w, h):
    return (jcam.make_camera(image_width=w, image_height=h, **cam_kw),
            tcam.make_camera(image_width=w, image_height=h, **cam_kw))


@pytest.mark.parametrize("name,level,thickness", [
    ("three", -1, 2.0), ("showcase", -1, 0.05), ("showcase", 3, 0.05)])
def test_composite_and_debug_render_match_reference(scenes, name, level,
                                                    thickness):
    """composite_wireframe over the same beauty buffer and render_bvh_debug
    at the same key: equal except on pixels whose edge or surface test
    grazes (at most GRAZE_FRAC of them, where the surface t of the two
    packages' closest-hit searches may differ)."""
    js, ts, cam_kw = scenes[name]
    w, h = 64, 36
    jc, tc = _cams(cam_kw, w, h)
    beauty = np.random.default_rng(0).uniform(0, 1, (h, w, 3)).astype(
        np.float32)
    want = np.asarray(jdv.composite_wireframe(js, jc, jnp.asarray(beauty),
                                              level=level,
                                              thickness=thickness))
    got = tdv.composite_wireframe(ts, tc, torch.tensor(beauty), level=level,
                                  thickness=thickness).numpy()
    assert (want != beauty).any()
    assert (np.abs(got - want).max(-1) > 1e-6).mean() <= GRAZE_FRAC
    cfg = jint.RenderConfig(width=w, height=h, samples_per_pixel=1)
    want = np.asarray(jdv.render_bvh_debug(js, jc, jax.random.PRNGKey(3),
                                           cfg, level=level,
                                           thickness=thickness))
    got = tdv.render_bvh_debug(ts, tc, 3, tint.RenderConfig(
        width=w, height=h, samples_per_pixel=1), level=level,
        thickness=thickness).numpy()
    assert want.max() > 1.0
    assert (np.abs(got - want).max(-1) > 1e-6).mean() <= GRAZE_FRAC


# The reference test's four cases on the port.

def _cfg(w, h, spp, depth):
    return tint.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                             max_depth=depth, env_mode=tenv.SOLID_COLOR)


def test_wireframe_renders_edges_and_interior(scenes):
    scene = scenes["three"][1]
    cfg = _cfg(64, 40, 1, 2)
    cam = tcam.make_camera(image_width=64, image_height=40, **THREE_CAM)
    img = tdv.render_bvh_debug(scene, cam, 0, cfg, level=-1,
                               thickness=2.0).numpy()
    assert img.shape == (40, 64, 3)
    assert np.isfinite(img).all()
    assert img.max() > 1.0                       # neon edges (x4)
    vals = img.reshape(-1, 3)
    assert ((vals > 0.005) & (vals < 0.05)).any()  # dark interiors
    assert (img[0, 0] == 0.0).all()              # background black


def test_level_selector(scenes):
    scene = scenes["three"][1]
    cam = tcam.make_camera(image_width=32, image_height=20, **THREE_CAM)
    img0 = tdv.render_bvh_debug(scene, cam, 0, _cfg(32, 20, 1, 2), level=0,
                                thickness=2.0).numpy()
    # Level 0 = root box: edge color has g = 0 -> pure (0.4, 0, 1)*4 edges.
    edges = img0[img0[..., 0] > 1.0]
    assert edges.size
    np.testing.assert_allclose(edges[:, 1], 0.0, atol=1e-6)


def test_composite_wireframe_into_beauty(scenes):
    scene = scenes["three"][1]
    cfg = _cfg(64, 40, 2, 3)
    cam = tcam.make_camera(image_width=64, image_height=40, **THREE_CAM)
    env = tenv.make_environment(background_color=(0.4, 0.5, 0.7))
    beauty = tint.render(scene, cam, env, 0, cfg, device="cpu")["beauty"]
    comp = tdv.composite_wireframe(scene, cam, beauty, level=-1,
                                   thickness=2.0).numpy()
    beauty = beauty.numpy()
    wire_px = (comp != beauty).any(-1)
    assert wire_px.any() and not wire_px.all()
    assert comp[wire_px].max() > 1.0
    np.testing.assert_array_equal(comp[~wire_px], beauty[~wire_px])
    assert (~wire_px).sum() > wire_px.sum() * 0.1


def test_session_display_wire(scenes):
    """display_wire is the composite over the session's beauty through the
    post chain; it differs from the plain display where the wires are."""
    scene = scenes["three"][1]
    cfg = _cfg(48, 27, 2, 3)
    cam = tcam.make_camera(image_width=48, image_height=27, **THREE_CAM)
    env = tenv.make_environment(background_color=(0.4, 0.5, 0.7))
    sess = RenderSession(scene, cam, env, cfg, key=0, chunk_samples=2,
                         device="cpu")
    sess.step()
    plain = sess.display()
    wired = sess.display_wire(level=-1, thickness=2.0)
    assert wired.shape == plain.shape and wired.dtype == np.uint8
    assert (wired != plain).any()
    comp = tdv.composite_wireframe(sess.scene, sess.camera,
                                   sess.buffers()["beauty"], level=-1,
                                   thickness=2.0)
    params = sess.post_params._replace(exposure=sess.resolved_exposure())
    np.testing.assert_array_equal(wired, to_u8(tpost.update_post_processing(
        comp, params, sess.post_config, tpost.PASS_RGB)))
    bare = RenderSession(_three_no_bvh(), cam, env, cfg, key=0, device="cpu")
    with pytest.raises(ValueError, match="no BVH"):
        bare.display_wire()


def _three_no_bvh():
    b = TBuilder()
    m = b.materials.lambertian("m", (0.5, 0.5, 0.5))
    b.geometry.add_sphere((0.0, 0.0, 0.0), 0.8, m)
    return b.build(with_bvh=False)
