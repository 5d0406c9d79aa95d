"""The port's fog (ops/volumes.py, SceneBuilder.add_fog_*): the fog tables
against the reference's bit for bit, the volume sampling against the
reference's on showcase rays, and the chunked integrator's fog render
against the reference's compiled chunked render."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer_project_tpu.core import rng as jrng
from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.models.scene import SceneBuilder as JBuilder
from raytracer_project_tpu.ops import integrator as jint
from raytracer_project_tpu.ops import intersect as jis
from raytracer_project_tpu.ops import volumes as jvol
from raytracer_project_tpu_torch.core import rng as trng
from raytracer_project_tpu_torch.core.tree import flatten
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.models.scene import SceneBuilder as TBuilder
from raytracer_project_tpu_torch.models.scene import scene_from_numpy
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import intersect as tis
from raytracer_project_tpu_torch.ops import shade as tsh
from raytracer_project_tpu_torch.ops import volumes as tvol

torch.set_num_threads(2)

CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
BUFFERS = ("beauty", "albedo", "normal", "z_depth", "reflection", "refraction")


def _jax_flat(obj, prefix=""):
    """{dotted path: numpy} of a reference NamedTuple (BVH left out)."""
    out = {}
    if obj is None:
        return out
    if hasattr(obj, "_fields"):
        for name, val in zip(obj._fields, obj):
            if name != "bvh":
                out.update(_jax_flat(val, f"{prefix}.{name}" if prefix else name))
        return out
    out[prefix] = np.asarray(obj)
    return out


def _assert_bit_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k].reshape(-1).view(np.uint8),
                                      b[k].reshape(-1).view(np.uint8), err_msg=k)


def _fog_scene(b):
    """The fog scene of tests/test_fused_step.py:281-291: a glass sphere,
    a lamp and a box in a fog sphere, plus a denser fog box."""
    ground = b.materials.lambertian("ground", (0.5, 0.6, 0.5))
    lamp = b.materials.diffuse_light("lamp", (5.0, 4.0, 3.0))
    glass = b.materials.dielectric("glass", 1.5)
    b.geometry.add_sphere((0.0, -100.5, 0.0), 100.0, ground)
    b.geometry.add_sphere((0.0, 0.5, 0.0), 0.5, glass)
    b.geometry.add_sphere((0.0, 2.2, -0.5), 0.6, lamp)
    b.geometry.add_box((-2.0, 0.0, -1.5), (-1.2, 0.9, -0.7), ground)
    b.add_fog_sphere((0.0, 0.5, 0.0), 4.0, 0.15, (0.85, 0.9, 0.95))
    b.add_fog_box((1.0, 0.0, -1.0), (2.0, 1.2, 0.2), 0.4, (0.9, 0.6, 0.5))
    return b.build(with_bvh=False)


@pytest.fixture(scope="module")
def showcase_fog():
    return (jpresets.showcase_scene(with_bvh=False, use_fog=True,
                                    fog_density=0.1),
            tpresets.showcase_scene(with_bvh=False, use_fog=True,
                                    fog_density=0.1))


def test_fog_builder_tables_bit_equal():
    """Fog sphere and box: the volume rows and the isotropic phase
    materials they add to the library, and the numpy hand-over."""
    ref = _jax_flat(_fog_scene(JBuilder()))
    scene = _fog_scene(TBuilder())
    _assert_bit_equal(ref, flatten(scene))
    assert scene.volumes.count == 2 and scene.volumes.textured is None
    assert scene.materials.count == 5
    _assert_bit_equal(ref, flatten(scene_from_numpy(ref)))
    # A textured phase material is marked, as the reference marks it.
    jb, tb = JBuilder(), TBuilder()
    for b in (jb, tb):
        tex = b.textures.add_checker(0.5, (0.9, 0.9, 0.9), (0.1, 0.1, 0.1))
        b.geometry.add_sphere((0.0, 0.0, 0.0), 1.0,
                              b.materials.lambertian("m", (0.5, 0.5, 0.5)))
        b.add_fog_box((0, 0, 0), (1, 1, 1), 0.5, (1, 1, 1), texture_id=tex)
    jt, tt = jb.build(with_bvh=False), tb.build(with_bvh=False)
    np.testing.assert_array_equal(np.asarray(jt.volumes.textured),
                                  tt.volumes.textured.numpy())


def test_showcase_fog_tables_bit_equal(showcase_fog):
    jsc, tsc = showcase_fog
    _assert_bit_equal(_jax_flat(jsc), flatten(tsc))
    assert tsc.materials.count == 35 and tsc.volumes.count == 1


def test_sample_interaction_matches_reference(showcase_fog):
    """4,096 showcase rays (64x32 camera rays, seed 3, and one scatter of
    each) against the reference's compiled sample_interaction, same lane
    streams at bounce context 1: is_volume and mat equal, t within 1e-6
    relative."""
    jsc, tsc = showcase_fog
    cam = tcam.make_camera(image_width=64, image_height=32, **CAM_KW)
    pix = torch.arange(64 * 32)
    lr = trng.lane_rng(trng.seed_from_int(3), pix, 0).with_ctx(0, 0)
    o, d = tcam.generate_rays(cam, lr, pix, 64)
    tables = tis.hit_tables(tsc)
    rec = tis.make_record(tsc, o, d, tis.intersect(tsc, o, d, 1e-3, tables))
    sc = tsh.scatter(tsc, rec, d, lr)
    o, d = torch.cat([o, sc.origin]), torch.cat([d, sc.direction])
    pix2 = torch.cat([pix, pix])
    hit = tis.intersect(tsc, o, d, 1e-3, tables)
    t, mat, is_vol = tvol.sample_interaction(
        tsc.volumes, o, d, 1e-3, hit,
        trng.lane_rng(trng.seed_from_int(3), pix2, 0).with_ctx(1, 0))

    jlr = jrng.LaneRng(jrng.seed_from_key(jax.random.PRNGKey(3)),
                       jnp.asarray(pix2.numpy().astype(np.uint32)),
                       jnp.uint32(0), jnp.uint32(2))
    jhit = jis.Hit(t=jnp.asarray(hit.t.numpy()),
                   prim_type=jnp.asarray(hit.prim_type.numpy()),
                   prim_idx=jnp.asarray(hit.prim_idx.numpy()),
                   hit=jnp.asarray(hit.hit.numpy()))
    jt, jm, jv = jax.jit(lambda o, d, h: jvol.sample_interaction(
        jsc.volumes, o, d, jnp.full((o.shape[0],), 1e-3, jnp.float32), h,
        jlr))(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jhit)
    frac = float(is_vol.float().mean())
    assert 0.1 < frac < 0.9, frac
    np.testing.assert_array_equal(np.asarray(jv), is_vol.numpy())
    np.testing.assert_array_equal(np.asarray(jm), mat.numpy())
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6, atol=0)


def test_apply_to_record_frame(showcase_fog):
    """A volume scatter moves the hit point to the scatter point and sets
    the reference's arbitrary frame: normal (1, 0, 0), front face, the
    volume's material; other lanes keep the surface record."""
    _, tsc = showcase_fog
    n = 512
    r = np.random.default_rng(0)
    o = torch.as_tensor(np.tile(np.float32([12.0, 2.5, 6.0]), (n, 1)))
    d = torch.as_tensor(np.stack([r.uniform(-16, -8, n), r.uniform(-3, 0, n),
                                  r.uniform(-10, -2, n)], 1).astype(np.float32))
    hit = tis.intersect(tsc, o, d, 1e-3, tis.hit_tables(tsc))
    rec = tis.make_record(tsc, o, d, hit)
    lr = trng.lane_rng(trng.seed_from_int(1), torch.arange(n), 0).with_ctx(0, 0)
    out = tvol.apply_to_record(tsc.volumes, o, d, hit, rec, lr)
    vol = out.mat == int(tsc.volumes.mat[0])
    assert 0 < int(vol.sum()) < n
    assert bool(out.hit[vol].all()) and bool(out.front_face[vol].all())
    assert torch.equal(out.normal[vol], torch.tensor([[1.0, 0.0, 0.0]]).expand(
        int(vol.sum()), 3))
    assert bool((out.t[vol] < torch.where(hit.hit, hit.t, 1e30)[vol]).all())
    torch.testing.assert_close(out.p[vol], o[vol] + out.t[vol, None] * d[vol])
    assert torch.equal(out.p[~vol], rec.p[~vol])
    assert tvol.apply_to_record(None, o, d, hit, rec, lr) is rec


def test_chunked_fog_render_matches_reference():
    """The fog scene and camera of tests/test_fused_step.py at 24x14 @ 2
    spp, all six buffers, through the port's
    chunked integrator against the reference's compiled chunked render
    (PRNGKey(5)), under the tie-robust rule of tests/test_torch_chunked.py
    (mean |d| < 1e-3, < 0.5% of values over 3e-3)."""
    w, h = 24, 14
    kw = dict(width=w, height=h, samples_per_pixel=2, max_depth=10,
              use_reflection=True, use_refraction=True, wavefront=False)
    cam_kw = dict(vfov=40.0, lookfrom=(0.0, 1.0, 4.0), lookat=(0.0, 0.5, 0.0))
    env_kw = dict(sun_direction=(0.3, 0.8, 0.2), sun_intensity=4.0)
    ref = jax.jit(jint.render, static_argnames="config")(
        _fog_scene(JBuilder()), jcam.make_camera(image_width=w, image_height=h,
                                                 **cam_kw),
        jenv.make_environment(**env_kw), jax.random.PRNGKey(5),
        jint.RenderConfig(**kw))
    out = tint.render(_fog_scene(TBuilder()),
                      tcam.make_camera(image_width=w, image_height=h, **cam_kw),
                      tenv.make_environment(**env_kw), 5,
                      tint.RenderConfig(**kw), device="cpu")
    for name in BUFFERS:
        d = np.abs(out[name].numpy() - np.asarray(ref[name]))
        assert d.mean() < 1e-3, (name, d.mean())
        assert (d > 3e-3).mean() < 0.005, (name, (d > 3e-3).mean())
