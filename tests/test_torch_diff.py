"""The port's differentiable mode and inverse fit on the CPU, against the
reference package: the detached intersection (t and its gradients, each
primitive type's recomputed t as a VJP), the differentiable render of the
reference's tiny gradient scene, autograd against jax.grad of the same
loss, the reference's five finite-difference checks, the fit loop against
the reference's (optax), the threefry fold-in seed, and the parameter
paths. Every JAX reference is computed once per module."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer_project_tpu.core import rng as jrng
from raytracer_project_tpu.diff import inverse as jinv
from raytracer_project_tpu.models import geometry as jgeo
from raytracer_project_tpu.models import scene as jscene
from raytracer_project_tpu.ops import integrator as jint
from raytracer_project_tpu.ops import intersect as jis
from raytracer_project_tpu_torch import diff as tdiff
from raytracer_project_tpu_torch.core import rng as trng
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import geometry as tgeo
from raytracer_project_tpu_torch.models import scene as tscene
from raytracer_project_tpu_torch.ops import intersect as tis
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.tools import diff_cases

torch.set_num_threads(2)

MODES = {"SOLID_COLOR": tenv.SOLID_COLOR, "PHYSICAL_SUN": tenv.PHYSICAL_SUN}
# The six parameter groups held against jax.grad.
GRAD_PATHS = ["scene.materials.albedo", "scene.materials.param",
              "env.background_color", "env.sun_intensity",
              "env.sun_direction", "cam.center"]


def _j_tiny_state(env_mode):
    """The reference's _tiny_state (tests/test_gradients.py:24-49), built by
    the JAX package from the port's own description of it."""
    tstate, tcfg = diff_cases.tiny_state(env_mode)
    b = jscene.SceneBuilder()
    red = b.materials.lambertian("red", (0.7, 0.2, 0.1))
    gray = b.materials.lambertian("gray", (0.5, 0.5, 0.5))
    lamp = b.materials.diffuse_light("lamp", (4.0, 4.0, 4.0))
    metal = b.materials.metal("mirror", (0.9, 0.9, 0.9), fuzz=0.1)
    b.geometry.add_sphere((0.0, 1.0, 0.0), 1.0, red)
    b.geometry.add_sphere((0.0, -100.0, 0.0), 100.0, gray)
    b.geometry.add_sphere((2.2, 1.0, -1.0), 0.7, metal)
    b.geometry.add_sphere((-2.0, 2.5, 1.0), 0.5, lamp)
    from raytracer_project_tpu.models import camera as jcam
    from raytracer_project_tpu.models import environment as jenv

    cam = jcam.make_camera(image_width=24, image_height=16, vfov=40.0,
                           lookfrom=(0.0, 2.0, 8.0), lookat=(0.0, 1.0, 0.0),
                           defocus_angle=0.0)
    env = jenv.make_environment(background_color=(0.3, 0.5, 0.9),
                                sun_direction=(0.4, 0.8, 0.2),
                                sun_intensity=4.0)
    cfg = jint.RenderConfig(**dataclasses.asdict(tcfg))
    jstate = jinv.RenderState(scene=b.build(with_bvh=False), cam=cam, env=env)
    return jstate, cfg, tstate, tcfg


@pytest.fixture(scope="module")
def tiny():
    return {name: _j_tiny_state(mode) for name, mode in MODES.items()}


@pytest.fixture(scope="module")
def target():
    return np.random.default_rng(8).uniform(0.0, 1.0, (16, 24, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_grads(tiny, target):
    """jax.jit(jax.value_and_grad) of the L2 loss over GRAD_PATHS, each mode,
    PRNGKey(0): the compiled reference's arithmetic."""
    out = {}
    for name, (jstate, jcfg, _, _) in tiny.items():
        loss_fn, p0 = jinv.make_loss_fn(jstate, jcfg, jnp.asarray(target),
                                        GRAD_PATHS)
        loss, g = jax.jit(jax.value_and_grad(loss_fn))(p0, jax.random.PRNGKey(0))
        out[name] = float(loss), {k: np.asarray(v) for k, v in g.items()}
    return out


# --- the detached intersection -------------------------------------------------

def _offset_scene(build, dy):
    """The reference's test scene (test_gradients.py:160-195) with every
    primitive moved by (0, dy, 0) in its raw tables, differentiably in dy
    (torch tensor or JAX value)."""
    scene = build()
    if isinstance(dy, torch.Tensor):
        off = torch.stack([torch.zeros_like(dy), dy, torch.zeros_like(dy)])
        m = scene.boxes.minv.reshape(-1, 3, 3)
        trans = scene.boxes.trans - torch.einsum("bij,j->bi", m, off)
    else:
        off = jnp.asarray([0.0, dy, 0.0])
        m = scene.boxes.minv.reshape(-1, 3, 3)
        trans = scene.boxes.trans - jnp.einsum("bij,j->bi", m, off)
    return scene._replace(
        spheres=scene.spheres._replace(center=scene.spheres.center + off),
        triangles=scene.triangles._replace(v0=scene.triangles.v0 + off),
        boxes=scene.boxes._replace(trans=trans))


def _three_prims(builder_cls):
    def build():
        b = builder_cls()
        m = b.materials.lambertian("m", (0.5, 0.5, 0.5))
        b.geometry.add_sphere((0.0, 1.0, 0.0), 1.0, m)
        b.geometry.add_box((-3.0, -0.5, -3.0), (3.0, 0.0, 3.0), m)
        v = np.array([[-1.0, 2.5, -2.0]], np.float32)
        b.geometry.add_triangles(v, v + [[2.0, 0.0, 0.0]],
                                 v + [[1.0, 1.5, 0.0]], m)
        return b.build(with_bvh=False)
    return build


_O = np.array([[0.0, 1.0, 5.0], [0.5, 3.0, 0.5], [0.0, 2.9, 3.0]], np.float32)
_D = np.array([[0.0, 0.0, -1.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], np.float32)


def test_intersect_detached_t_grad():
    """d(sum t)/d(dy) of the reference's case (tests/test_gradients.py
    :150-202) against jax.grad of the reference's intersect_detached (rtol
    1e-5), and against central finite differences of intersect_detached's
    own t (rtol 5e-3, as the reference's test). The search keeps the tables
    built at dy = 0; the recomputed t follows the moved geometry."""
    tbuild = _three_prims(tscene.SceneBuilder)
    jbuild = _three_prims(jscene.SceneBuilder)
    tables = tis.hit_tables(tbuild())
    o, d = torch.from_numpy(_O), torch.from_numpy(_D)

    def t_sum(dy):
        h = tis.intersect_detached(_offset_scene(tbuild, dy), o, d, 1e-3, tables)
        assert bool(h.hit.all()) and h.t.requires_grad == dy.requires_grad
        return h.t.sum()

    def j_t_sum(dy):
        h = jis.intersect_detached(_offset_scene(jbuild, dy), jnp.asarray(_O),
                                   jnp.asarray(_D), 1e-3)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    dy = torch.zeros((), requires_grad=True)
    val = t_sum(dy)
    (g,) = torch.autograd.grad(val, dy)
    np.testing.assert_allclose(float(val.detach()), float(j_t_sum(0.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(g), float(jax.grad(j_t_sum)(0.0)),
                               rtol=1e-5)
    eps = 1e-3
    with torch.no_grad():
        fd = (float(t_sum(torch.tensor(eps)))
              - float(t_sum(torch.tensor(-eps)))) / (2 * eps)
    assert abs(fd) > 0.1
    np.testing.assert_allclose(float(g), fd, rtol=5e-3)


def _vjp_scene(builder_cls, geo):
    """Spheres, triangles and rotated affine boxes of seeded sizes."""
    r = np.random.default_rng(21)
    b = builder_cls()
    m = b.materials.lambertian("m", (0.5, 0.5, 0.5))
    for k in range(5):
        b.geometry.add_sphere(tuple(r.uniform(-4, 4, 3)), float(r.uniform(0.3, 1.2)), m)
        b.geometry.add_box(tuple(r.uniform(-1.5, -0.3, 3)), tuple(r.uniform(0.3, 1.5, 3)), m,
                           transform=geo.compose(geo.translate(r.uniform(-3, 3, 3)),
                                                 geo.rotate_y(float(r.uniform(0, 90)))))
    v0 = r.uniform(-4, 4, (12, 3)).astype(np.float32)
    b.geometry.add_triangles(v0, v0 + r.uniform(-3, 3, (12, 3)),
                             v0 + r.uniform(-3, 3, (12, 3)), m)
    return b.build(with_bvh=False)


_FIELDS = {"sphere": (tis._diff_t_sphere, jis._diff_t_sphere, "spheres",
                      ("center", "radius")),
           "triangle": (tis._diff_t_triangle, jis._diff_t_triangle,
                        "triangles", ("v0", "e1", "e2")),
           "box": (tis._diff_t_box, jis._diff_t_box, "boxes",
                   ("minv", "trans"))}


@pytest.mark.parametrize("kind", list(_FIELDS))
def test_diff_t_vjp(kind):
    """Each _diff_t_*: the recomputed t on the lanes whose closest hit
    (the exact oracle) is that type, and its VJP with one seeded cotangent
    into o, d and the type's tables, against the JAX function's under
    jax.jit (t rtol 1e-5; each VJP within 1e-4 of its largest entry)."""
    tfn, jfn, table, fields = _FIELDS[kind]
    tsc, jsc = _vjp_scene(tscene.SceneBuilder, tgeo), _vjp_scene(jscene.SceneBuilder, jgeo)
    r = np.random.default_rng(5)
    n = 4096
    o = r.uniform(-9, 9, (n, 3)).astype(np.float32)
    d = (r.uniform(-4, 4, (n, 3)) - o).astype(np.float32)
    hit = tis.intersect_brute(tsc, torch.from_numpy(o), torch.from_numpy(d), 1e-3)
    ptype = {"sphere": 0, "triangle": 1, "box": 2}[kind]
    lanes = (hit.hit & (hit.prim_type == ptype)).numpy()
    assert lanes.sum() > 100
    o, d = o[lanes], d[lanes]
    idx = hit.prim_idx.numpy()[lanes].astype(np.int64)
    t_det = hit.t.numpy()[lanes]
    cot = r.normal(size=o.shape[0]).astype(np.float32)
    tab = [np.asarray(getattr(getattr(tsc, table), f)) for f in fields]

    def jf(o_, d_, *cols):
        s = jsc._replace(**{table: getattr(jsc, table)._replace(**dict(zip(fields, cols)))})
        return jfn(s, o_, d_, jnp.asarray(idx), jnp.asarray(t_det))

    @jax.jit
    def j_t_vjp(cot_, *args):
        t_, vjp_ = jax.vjp(jf, *args)
        return t_, vjp_(cot_)

    jt, jg = j_t_vjp(jnp.asarray(cot), jnp.asarray(o), jnp.asarray(d),
                     *map(jnp.asarray, tab))

    ins = [torch.from_numpy(x).requires_grad_(True) for x in (o, d, *tab)]
    s = tsc._replace(**{table: getattr(tsc, table)._replace(**dict(zip(fields, ins[2:])))})
    tt = tfn(s, ins[0], ins[1], torch.from_numpy(idx), torch.from_numpy(t_det))
    tg = torch.autograd.grad(tt, ins, torch.from_numpy(cot))
    np.testing.assert_allclose(tt.detach().numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tt.detach().numpy(), t_det, rtol=1e-4, atol=1e-5)
    for name, a, b in zip(("o", "d") + fields, tg, jg):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-4 * scale, (kind, name)


# --- the differentiable render ---------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_diff_render_matches_reference(tiny, mode):
    """The differentiable render of the tiny scene (render_beauty, seed 0)
    against the reference's, compiled (jax.jit): the tie-robust rule,
    mean |d| < 1e-3 and < 0.5% of values over 3e-3."""
    jstate, jcfg, tstate, tcfg = tiny[mode]
    ref = jax.jit(jinv.render_beauty, static_argnames="config")(
        jstate, jax.random.PRNGKey(0), config=jcfg)
    out = tdiff.render_beauty(tstate, 0, tcfg, device="cpu")
    d = np.abs(out.numpy() - np.asarray(ref))
    assert np.isfinite(out.numpy()).all() and float(out.max()) > 0
    assert d.mean() < 1e-3, d.mean()
    assert (d > 3e-3).mean() < 0.005


def test_diff_render_matches_reference_on_the_showcase():
    """The chunked smoke's frame (showcase grid=6, 64x36 @ 8 spp, depth 6,
    seed 0, the frame chip_smoke.py D1 renders on the card) in the
    differentiable mode, against the reference's differentiable render
    under jax.jit: the tie-robust rule. Its hit points come from the
    recomputed t, as the reference's do."""
    from raytracer_project_tpu.models import camera as jcam
    from raytracer_project_tpu.models import environment as jenv
    from raytracer_project_tpu.models import presets as jpresets
    from raytracer_project_tpu_torch.models import camera as tcam
    from raytracer_project_tpu_torch.models import presets as tpresets

    cam_kw = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
                  defocus_angle=0.0, focus_dist=10.0)
    env_kw = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)
    kw = dict(width=64, height=36, samples_per_pixel=8, max_depth=6,
              use_albedo=False, use_normal=False, use_z_depth=False,
              use_reflection=False, use_refraction=False, wavefront=False,
              differentiable=True)
    ref = jax.jit(jint.render, static_argnames="config")(
        jpresets.showcase_scene(grid=6),
        jcam.make_camera(image_width=64, image_height=36, **cam_kw),
        jenv.make_environment(**env_kw), jax.random.PRNGKey(0),
        jint.RenderConfig(**kw))["beauty"]
    with torch.no_grad():
        out = tint.render(tpresets.showcase_scene(grid=6),
                          tcam.make_camera(image_width=64, image_height=36,
                                           **cam_kw),
                          tenv.make_environment(**env_kw), 0,
                          tint.RenderConfig(**kw), device="cpu")["beauty"]
    d = np.abs(out.numpy() - np.asarray(ref))
    assert np.isfinite(out.numpy()).all()
    assert d.mean() < 1e-3, d.mean()
    assert (d > 3e-3).mean() < 0.005, (d > 3e-3).mean()


@pytest.mark.parametrize("mode", list(MODES))
def test_autograd_matches_jax_grad(tiny, target, jax_grads, mode):
    """Autograd of the L2 loss against a seeded target over the material
    albedos and params, the background, the sun intensity and direction and
    the camera centre, against jax.jit(jax.value_and_grad) of the
    reference's loss: loss rtol 1e-5; each gradient within 2e-3 relative
    plus 1e-6 of its reference (f32 sums in other orders over 768 pixels
    and four bounces). A group no path reaches has a zero gradient."""
    _, _, tstate, tcfg = tiny[mode]
    jloss, jg = jax_grads[mode]
    loss_fn, p0 = tdiff.make_loss_fn(tstate, tcfg, torch.from_numpy(target),
                                     GRAD_PATHS, device="cpu")
    params = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    loss = loss_fn(params, 0)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    nonzero = 0
    for path, g in zip(GRAD_PATHS, grads):
        g = np.zeros(jg[path].shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, jg[path], rtol=2e-3, atol=1e-6,
                                   err_msg=path)
        nonzero += bool(np.abs(jg[path]).max() > 0)
    assert nonzero >= 2


@pytest.mark.parametrize("check", diff_cases.FD_CHECKS,
                         ids=[f"{c[1]}[{c[2]}]" for c in diff_cases.FD_CHECKS])
def test_fd_checks(check):
    """The reference's five finite-difference checks (albedo, emission,
    background, sun intensity, fuzz) on the port: autograd against central
    differences (eps 1e-3), rtol 0.08 (fuzz 0.15), atol 1e-5."""
    mode, path, index, rtol = check
    state, cfg = diff_cases.tiny_state(MODES[mode])
    g, fd = diff_cases.fd_check(state, cfg, 0, path, index, device="cpu")
    assert diff_cases.fd_agrees(g, fd, rtol), (g, fd)


def test_fit_matches_reference(tiny):
    """Three steps of fit (Adam, lr 5e-2, albedo clipped to [0, 8]) from a
    wrong hero albedo, against the reference's fit with optax.adam: the
    losses (rtol 1e-4) and the fitted albedos (atol 1e-5)."""
    pytest.importorskip("optax")
    jstate, jcfg, tstate, tcfg = tiny["SOLID_COLOR"]
    target = jinv.render_beauty(jstate, jax.random.PRNGKey(0), jcfg)
    wrong = jnp.asarray([0.1, 0.8, 0.9])
    jstart = jstate._replace(scene=jstate.scene._replace(
        materials=jstate.scene.materials._replace(
            albedo=jstate.scene.materials.albedo.at[0].set(wrong))))
    jfitted, jlosses = jinv.fit(
        jstart, jax.random.PRNGKey(0), jcfg, target, ["scene.materials.albedo"],
        steps=3, learning_rate=5e-2,
        project=lambda p: {k: jnp.clip(v, 0.0, 8.0) for k, v in p.items()})

    albedo = tstate.scene.materials.albedo.clone()
    albedo[0] = torch.tensor([0.1, 0.8, 0.9])
    tstart = tdiff.apply_params(tstate, {"scene.materials.albedo": albedo})
    seen = []
    fitted, losses = tdiff.fit(
        tstart, 0, tcfg, torch.tensor(np.asarray(target)),
        ["scene.materials.albedo"], steps=3, learning_rate=5e-2,
        project=lambda p: {k: torch.clamp(v, 0.0, 8.0) for k, v in p.items()},
        callback=lambda i, loss: seen.append(i), device="cpu")
    assert seen == [0, 1, 2] and losses[2] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(fitted.scene.materials.albedo.numpy(),
                               np.asarray(jfitted.scene.materials.albedo),
                               atol=1e-5)
    assert not fitted.scene.materials.albedo.requires_grad


def test_fit_resample_keys_seeds():
    """resample_keys: step i renders with the seed of fold_in(PRNGKey(s), i),
    bit for bit the reference's jax.random.fold_in + seed_from_key; an
    integer seed k is PRNGKey(k)."""
    for s, i in ((0, 0), (0, 1), (7, 3), (2**31 + 5, 19), (123456789, 2**32 - 1)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(s), i)
        tkey = trng.fold_in(trng.Key(0, s), i)
        assert [tkey.hi, tkey.lo] == np.asarray(jax.random.key_data(jkey)).tolist()
        assert trng.seed_from_int(tkey) == int(jrng.seed_from_key(jkey))
        assert trng.seed_from_int(trng.Key(0, s)) == trng.seed_from_int(s)
    state, cfg = diff_cases.tiny_state(tenv.SOLID_COLOR)
    cfg = dataclasses.replace(cfg, width=6, height=4, max_depth=2)
    state = state._replace(cam=state.cam)
    used = []
    orig = tint.render

    def spy(scene, cam, env, seed, config, **kw):
        used.append(seed)
        return orig(scene, cam, env, seed, config, **kw)

    tint.render = spy
    try:
        tdiff.fit(state, 7, cfg, torch.zeros(4, 6, 3), ["env.background_color"],
                  steps=2, resample_keys=True, device="cpu")
    finally:
        tint.render = orig
    assert used == [trng.fold_in(trng.Key(0, 7), 0), trng.fold_in(trng.Key(0, 7), 1)]


def test_extract_apply_roundtrip():
    """tree_get / tree_set / extract_params / apply_params over the state's
    NamedTuples (the reference's test_extract_apply_roundtrip)."""
    state, _ = diff_cases.tiny_state(tenv.SOLID_COLOR)
    paths = ["scene.materials.albedo", "env.sun_intensity", "cam.center"]
    params = tdiff.extract_params(state, paths)
    state2 = tdiff.apply_params(state, {k: v + 1.0 for k, v in params.items()})
    for p in paths:
        torch.testing.assert_close(tdiff.tree_get(state2, p), params[p] + 1.0)
    assert tdiff.tree_get(state2, "scene.spheres") is state.scene.spheres
    assert tdiff.tree_set(state, "env.sun_size", 3.0).env.sun_size == 3.0


def test_non_differentiable_render_refuses_grad_inputs():
    """A render outside the differentiable mode whose inputs require grad
    raises (on either engine) instead of cutting the gradient silently;
    under no_grad, or with differentiable=True, it renders."""
    state, cfg = diff_cases.tiny_state(tenv.SOLID_COLOR)
    cfg = dataclasses.replace(cfg, width=6, height=4, max_depth=2)
    albedo = state.scene.materials.albedo.clone().requires_grad_(True)
    st = tdiff.apply_params(state, {"scene.materials.albedo": albedo})
    for wavefront in (True, False):
        c = dataclasses.replace(cfg, wavefront=wavefront)
        with pytest.raises(ValueError, match="differentiable=True"):
            tint.render(st.scene, st.cam, st.env, 0, c, device="cpu")
        with pytest.raises(ValueError, match="differentiable=True"):
            tint.accumulate_samples(st.scene, st.cam, st.env, 0, c)
        with torch.no_grad():
            tint.render(st.scene, st.cam, st.env, 0, c, device="cpu")
    img = tdiff.render_beauty(st, 0, cfg, device="cpu")
    (g,) = torch.autograd.grad(img.sum(), albedo)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


def test_fit_defaults_to_cuda():
    """fit and render_beauty run on the card by default, and raise without
    a CUDA device rather than fit on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    state, cfg = diff_cases.tiny_state(tenv.SOLID_COLOR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdiff.fit(state, 0, cfg, torch.zeros(16, 24, 3),
                  ["scene.materials.albedo"], steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdiff.render_beauty(state, 0, cfg)


def test_search_agreement(monkeypatch):
    """diff_cases.search_agreement on the searches of the tiny scene's
    render, recorded twice: all lanes agree with themselves; a changed
    primitive on one lane of one search, or a hit of a search only one
    recording made, marks that lane and its pixel, and no other."""
    state, cfg = diff_cases.tiny_state(tenv.PHYSICAL_SUN)
    search, hits = tis.intersect, []

    def recorded(*args, **kw):
        hits.append(search(*args, **kw))
        return hits[-1]

    monkeypatch.setattr(tis, "intersect", recorded)
    tdiff.render_beauty(state, 0, cfg, device="cpu")
    assert 1 <= len(hits) <= cfg.max_depth
    n = cfg.n_pixels
    lanes, pixels = diff_cases.search_agreement(hits, list(hits), n)
    assert lanes.shape == (n * cfg.samples_per_pixel,) and bool(lanes.all())
    assert pixels.shape == (n,) and bool(pixels.all())
    k = int(torch.nonzero(hits[0].hit)[5])
    other = hits[0]._replace(prim_idx=hits[0].prim_idx.clone())
    other.prim_idx[k] += 1
    lanes, pixels = diff_cases.search_agreement(hits, [other] + hits[1:], n)
    assert torch.nonzero(~lanes).flatten().tolist() == [k]
    assert torch.nonzero(~pixels).flatten().tolist() == [k % n]
    extra = hits[0]._replace(hit=torch.zeros_like(hits[0].hit))
    extra.hit[k] = True
    lanes, _ = diff_cases.search_agreement(hits + [extra], hits, n)
    assert torch.nonzero(~lanes).flatten().tolist() == [k]
