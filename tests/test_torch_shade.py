"""Each module of the port's chunked integrator against its JAX function on
the same inputs: the AoS lane draws, camera rays, background shaders,
texture lookups, hit-record decode, albedo and scatter.

The inputs are showcase camera rays (64x32, seed 3) and one scatter of
them; their hits come from the port and go to both sides. The JAX
functions run under jax.jit, whose compiled arithmetic (fused
multiply-adds where XLA's CPU compiler emits them) the port copies where
paths are sensitive. Tolerances: integer and mask outputs exact; float
outputs bit-equal where both sides round alike, else within a few ulp of
the largest magnitudes involved (stated per case).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer_project_tpu.core import rng as jrng
from raytracer_project_tpu.models import camera as jcam
from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.models import textures as jtex
from raytracer_project_tpu.ops import intersect as jis
from raytracer_project_tpu.ops import shade as jsh
from raytracer_project_tpu_torch.core import rng as trng
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.models import textures as ttex
from raytracer_project_tpu_torch.ops import intersect as tis
from raytracer_project_tpu_torch.ops import shade as tsh

torch.set_num_threads(2)

W, H = 64, 32
CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
HDR = np.linspace(0, 2, 8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0, hdr_image=HDR,
              hdri_rotation=0.5, hdri_tilt=0.2, hdri_roll=0.1, intensity=0.8)
# A few ulp of the largest coordinates the showcase rays reach.
ATOL_GEOM = 2e-5


class Case:
    """Both scenes and cameras, the rays, their hits and both records."""

    def __init__(self):
        self.jsc = jpresets.showcase_scene(with_bvh=False)
        self.tsc = tpresets.showcase_scene()
        self.jcam = jcam.make_camera(image_width=W, image_height=H, **CAM_KW)
        self.tcam = tcam.make_camera(image_width=W, image_height=H, **CAM_KW)
        pix = torch.arange(W * H)
        lr = trng.lane_rng(trng.seed_from_int(3), pix, 0).with_ctx(0, 0)
        o, d = tcam.generate_rays(self.tcam, lr, pix, W)
        rec = tis.make_record(self.tsc, o, d, tis.intersect(self.tsc, o, d, 1e-3))
        sc = tsh.scatter(self.tsc, rec, d, lr)
        self.o = torch.cat([o, sc.origin])
        self.d = torch.cat([d, sc.direction])
        self.hit = tis.intersect(self.tsc, self.o, self.d, 1e-3)
        self.jhit = jis.Hit(*(jnp.asarray(x.numpy()) for x in self.hit))
        self.jo, self.jd = jnp.asarray(self.o.numpy()), jnp.asarray(self.d.numpy())
        self.trec = tis.make_record(self.tsc, self.o, self.d, self.hit)
        self.jrec = jax.jit(lambda o, d, h: jis.make_record(self.jsc, o, d, h))(
            self.jo, self.jd, self.jhit)
        self.mask = self.hit.hit.numpy()
        n = self.o.shape[0]
        self.jlr = jrng.lane_rng(jax.random.PRNGKey(3),
                                 jnp.arange(n, dtype=jnp.int32), 0).with_ctx(2, 1)
        self.tlr = trng.lane_rng(trng.seed_from_int(3), torch.arange(n),
                                 0).with_ctx(2, 1)


@pytest.fixture(scope="module")
def case():
    return Case()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_lane_draws(case):
    """The AoS unit-vector draw: the uniform and z bit-equal (the same hash
    bits); x and y come from sin/cos, where torch and XLA may differ by an
    ulp."""
    jv, ju = jrng.draw_unit_vector_and_uniform(case.jlr, jrng.STREAM_SCATTER)
    tv, tu = trng.draw_unit_vector_and_uniform(case.tlr, trng.STREAM_SCATTER)
    np.testing.assert_array_equal(_np(ju), _np(tu))
    np.testing.assert_array_equal(_np(jv)[:, 2], _np(tv)[:, 2])
    np.testing.assert_allclose(_np(jv), _np(tv), rtol=0, atol=1.2e-7)
    # with_ctx: the contexts, hence every word of the hash, agree.
    for b, s in ((0, 0), (0, 1), (3, 0), (9, 1)):
        jb = jrng.bits4(case.jlr.with_ctx(b, s), jrng.STREAM_RR)
        tb = trng.bits4(case.tlr.with_ctx(b, s), trng.STREAM_RR)
        for a, t in zip(jb, tb):
            np.testing.assert_array_equal(_np(a), _np(t).astype(np.uint32))


def test_generate_rays_and_normal_color(case):
    """Camera rays bit-equal (pinhole); view-space normal colors within
    1e-5."""
    pix = jnp.arange(W * H, dtype=jnp.int32)
    jlr = jrng.lane_rng(jax.random.PRNGKey(3), pix, 0).with_ctx(0, 0)
    jo, jd = jax.jit(lambda lr, p: jcam.generate_rays(case.jcam, lr, p, W, W * H))(
        jlr, pix)
    np.testing.assert_array_equal(_np(jo), _np(case.o[:W * H]))
    np.testing.assert_array_equal(_np(jd), _np(case.d[:W * H]))
    a = jax.jit(lambda n: jcam.view_space_normal_color(case.jcam, n))(
        case.jrec.normal)
    b = tcam.view_space_normal_color(case.tcam, case.trec.normal)
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", [tenv.PHYSICAL_SUN, tenv.HDR_MAP,
                                  tenv.SOLID_COLOR])
def test_background_color(case, mode):
    """HDR and solid bit-equal (the same texel); sun-sky within 1e-6."""
    je, te = jenv.make_environment(**ENV_KW), tenv.make_environment(**ENV_KW)
    a = jax.jit(lambda d: jenv.background_color(je, d, mode))(case.jd)
    b = tenv.background_color(te, case.d, mode)
    atol = 1e-6 if mode == tenv.PHYSICAL_SUN else 0.0
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


def test_texture_sample_and_bump_deltas(case):
    """Both lookups exact on random ids, uv (wrapping past [0, 1)) and
    points, over the showcase bank."""
    r = np.random.default_rng(0)
    n = 4096
    k = case.tsc.textures.count
    tex = r.integers(-1, k, n).astype(np.int32)
    u = r.uniform(-1.5, 2.5, n).astype(np.float32)
    v = r.uniform(-0.2, 1.2, n).astype(np.float32)
    p = r.uniform(-20, 20, (n, 3)).astype(np.float32)
    default = r.uniform(0, 1, (n, 3)).astype(np.float32)
    jb = case.jsc.textures
    tb = case.tsc.textures
    a = jtex.sample(jb, jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v),
                    jnp.asarray(p), jnp.asarray(default))
    b = ttex.sample(tb, torch.as_tensor(tex), torch.as_tensor(u),
                    torch.as_tensor(v), torch.as_tensor(p),
                    torch.as_tensor(default))
    np.testing.assert_array_equal(_np(a), _np(b))
    ja = jtex.sample_bump_deltas(jb, jnp.asarray(tex), jnp.asarray(u),
                                 jnp.asarray(v), 1.0 / 1024.0)
    ta = ttex.sample_bump_deltas(tb, torch.as_tensor(tex), torch.as_tensor(u),
                                 torch.as_tensor(v), 1.0 / 1024.0)
    for x, y in zip(ja, ta):
        np.testing.assert_array_equal(_np(x), _np(y))


def test_derived_tables_bit_equal(case):
    """The tables the chunked path derives from the scene: the packed
    [Ns + Nt + Nb, 28] shading rows, the box rows and every material's
    columns, bit for bit."""
    np.testing.assert_array_equal(_np(jis._packed_all(case.jsc)),
                                  _np(tis._packed_all(case.tsc)))
    np.testing.assert_array_equal(_np(jis._box_packed(case.jsc)),
                                  _np(tis._box_packed(case.tsc)))
    ids = np.arange(case.tsc.materials.mtype.shape[0], dtype=np.int32)
    for a, b in zip(jsh._mat_fetch(case.jsc, jnp.asarray(ids)),
                    tsh._mat_fetch(case.tsc, torch.as_tensor(ids))):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_make_record(case):
    """Records of the same hits (spheres, triangles, boxes): t, front face,
    material and hit exact; geometry within ATOL_GEOM on hit lanes."""
    m = case.mask
    assert m.sum() > 1000
    types = set(np.unique(case.hit.prim_type.numpy()[m]).tolist())
    assert types == {0, 1, 2}
    for f in ("t", "front_face", "mat", "hit"):
        a = _np(getattr(case.jrec, f))[m].astype(np.float64)
        np.testing.assert_array_equal(a, _np(getattr(case.trec, f))[m])
    for f in ("p", "normal", "tangent", "bitangent", "u", "v"):
        np.testing.assert_allclose(_np(getattr(case.jrec, f))[m],
                                   _np(getattr(case.trec, f))[m],
                                   rtol=0, atol=ATOL_GEOM, err_msg=f)


def test_get_albedo_and_scatter(case):
    """Albedo, attenuation, emission and the scattered mask exact; origin
    and direction within ATOL_GEOM on hit lanes."""
    m = case.mask
    a = jax.jit(lambda r: jsh.get_albedo(case.jsc, r))(case.jrec)
    np.testing.assert_array_equal(_np(a)[m], _np(tsh.get_albedo(case.tsc,
                                                                 case.trec))[m])
    js = jax.jit(lambda r, d, lr: jsh.scatter(case.jsc, r, d, lr))(
        case.jrec, case.jd, case.jlr)
    ts = tsh.scatter(case.tsc, case.trec, case.d, case.tlr)
    for f in ("attenuation", "emitted", "scattered"):
        np.testing.assert_array_equal(_np(getattr(js, f))[m],
                                      _np(getattr(ts, f))[m])
    for f in ("origin", "direction"):
        np.testing.assert_allclose(_np(getattr(js, f))[m],
                                   _np(getattr(ts, f))[m], rtol=0,
                                   atol=ATOL_GEOM, err_msg=f)
