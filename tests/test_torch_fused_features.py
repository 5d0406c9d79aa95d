"""The fused pool's features on the CPU: fog, the albedo/normal/z-depth
AOVs and the reflection/refraction split passes. K3's plain version
against the reference's Pallas kernel in interpret mode in each variant;
the reference's `fused-features` smoke render against its CPU goldens;
sample chunking with the whole render's AOV budget; the default render."""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer_project_tpu.ops import fused_step as jfs
from raytracer_project_tpu_torch.core.constants import T_MIN
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.models.scene import SceneBuilder
from raytracer_project_tpu_torch.ops import closest_hit as tk1
from raytracer_project_tpu_torch.ops import fused_step as tfs
from raytracer_project_tpu_torch.ops import integrator as tint
from raytracer_project_tpu_torch.ops import wavefront as twf

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HDR = np.linspace(0, 2, 8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0,
              hdr_image=HDR, hdri_rotation=0.5, hdri_tilt=0.2, hdri_roll=0.1,
              intensity=0.8)
CAM_KW = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
              defocus_angle=0.0, focus_dist=10.0)
SUN_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)
BUFFERS = ("beauty", "albedo", "normal", "z_depth", "reflection", "refraction")
# Lanes that may flip a fog flight or a specular classification on an ulp
# of log or sqrt, as a share of the pool.
FLIP_BUDGET = 0.005


@pytest.fixture(scope="module")
def fog_scene():
    return tpresets.showcase_scene(use_fog=True, fog_density=0.05)


def _rays(n, seed):
    """Half showcase camera-like rays, half rays from random points above
    the ground in random directions (as tests/test_torch_fused_step.py)."""
    r = np.random.default_rng(seed)
    m = n // 2
    o_cam = np.tile(np.float32([12.0, 2.5, 6.0]), (m, 1))
    look = np.stack([r.uniform(-4, 4, m), r.uniform(-1, 3, m),
                     r.uniform(-4, 4, m)], 1)
    o_rnd = np.stack([r.uniform(-8, 8, n - m), r.uniform(0.05, 3, n - m),
                      r.uniform(-8, 8, n - m)], 1)
    o = np.concatenate([o_cam, o_rnd]).astype(np.float32)
    d = np.concatenate([look - o_cam, r.normal(size=(n - m, 3))]).astype(np.float32)
    return o, d


def _vparams(tables):
    """The showcase's fog sphere and a denser fog box across the middle of
    the scene (both sides of the comparison take these rows as given)."""
    box = np.zeros(16, np.float32)
    box[tfs._VP_KIND] = 1.0
    box[tfs._VP_BMIN:tfs._VP_BMIN + 3] = (-3.0, 0.0, -2.0)
    box[tfs._VP_BMAX:tfs._VP_BMAX + 3] = (2.0, 1.5, 3.0)
    box[tfs._VP_NID] = -1.0 / 0.3
    box[tfs._VP_ALBEDO:tfs._VP_ALBEDO + 3] = (0.9, 0.6, 0.5)
    return np.concatenate([tables.vparams.numpy(), box[None]])


CONFIGS = {
    "fog": dict(aovs=(), want_spec=False, fog=True),
    "aovs": dict(aovs=tfs.AOVS, want_spec=False, fog=False),
    "spec": dict(aovs=(), want_spec=True, fog=False),
    "all": dict(aovs=tfs.AOVS, want_spec=True, fog=True),
    "all_hdr": dict(aovs=tfs.AOVS, want_spec=True, fog=True,
                    env_mode=tenv.HDR_MAP),
}


def _variant_step(fog_scene, name, reference=True):
    """One step of K3's variant `name` on P = 8192 lanes and the
    reference's Pallas kernel (interpret mode) on the same inputs: the
    inputs and plain outputs of the port, and the reference's outputs in
    the port's layout (ref_f, ref_i, ref_c, ref_t) with its counters
    (None without `reference`)."""
    cfg = CONFIGS[name]
    env_mode = cfg.get("env_mode", tenv.PHYSICAL_SUN)
    p, n_pix, spp = 8192, 64 * 36, 4
    r = np.random.default_rng(11)
    env = tenv.make_environment(**ENV_KW)
    tables = tfs.build_tables(fog_scene, env, env_mode)
    vparams = _vparams(tables)
    tables = tables._replace(vparams=torch.as_tensor(vparams))
    n_vol = len(vparams) if cfg["fog"] else 0
    o, d = _rays(p, 3)
    od = torch.as_tensor(np.concatenate([o.T, d.T]))
    rec = tfs.trace_decode(tables, od, tfs._aparams(env, "cpu"))
    want_spec = cfg["want_spec"]
    f_rows = [o.T, d.T, r.uniform(0.0, 1.0, (3, p)), r.uniform(0.0, 2.0, (3, p))]
    bounce = np.where(r.random(p) < 0.4, 0, r.integers(1, 13, p))
    i_rows = [(r.random(p) < 0.85), bounce, r.integers(0, spp, p),
              r.integers(0, n_pix, p)]
    if want_spec:
        f_rows.append(r.uniform(0.2, 1.0, (3, p)))
        i_rows += [r.random(p) < 0.5, r.random(p) < 0.3, r.random(p) < 0.3]
    state_f = np.concatenate(f_rows).astype(np.float32)
    state_i = np.stack(i_rows).astype(np.int32)
    cam = tcam.make_camera(image_width=64, image_height=36, **CAM_KW)
    bparams = tfs._bparams(cam, env, "cpu")
    seed, aux = 0x9E3779B9, 2
    n_beauty = n_pix * spp
    total_work = n_beauty * (2 if want_spec else 1)
    next_work = total_work - 1200
    sp = tfs.StepParams(
        seed=seed, sample_offset=1, n_pixels=n_pix, width=64,
        total_work=total_work, max_depth=10, env_mode=env_mode, aux=aux,
        z_max=50.0, aovs=cfg["aovs"], use_reflection=want_spec,
        use_refraction=want_spec,
        n_beauty=n_beauty, n_volumes=n_vol)
    out = tfs.shade_advance(
        tables, rec, torch.as_tensor(state_f), torch.as_tensor(state_i),
        torch.tensor([next_work], dtype=torch.int32),
        torch.tensor([5], dtype=torch.int64), bparams, sp)
    new_f, new_i, contrib, tgt, nw, seg, lc = out
    assert tfs.output_rows(sp) == (contrib.shape[0], tgt.shape[0])
    step = types.SimpleNamespace(
        cfg=cfg, p=p, n_pix=n_pix, tables=tables, rec=rec,
        state_f=state_f, state_i=state_i, bparams=bparams, sp=sp, env=env,
        next_work=next_work, out=out)
    if not reference:
        return step

    recn = rec.numpy()
    gather = lambda tab, rows, k: tuple(jnp.asarray(tab.numpy()[rows, c])
                                        for c in range(k))
    trow = np.clip(recn[tfs._RO_TEXROW], 0, None).astype(np.int32)
    brow = np.clip(recn[tfs._RO_BUMPROW], 0, None).astype(np.int32)
    erow = recn[tfs._RO_ENVROW].astype(np.int32)
    iscal = jnp.asarray(np.array([[np.uint32(seed).view(np.int32), next_work,
                                   1, 0]], np.int32))
    cols = (tuple(jnp.asarray(x) for x in state_f[:12])
            + tuple(jnp.asarray(x) for x in state_i[:4]))
    if want_spec:
        cols += (tuple(jnp.asarray(x) for x in state_i[4:])
                 + tuple(jnp.asarray(x) for x in state_f[12:]))
    ref = jfs.shade_advance(
        None, iscal, jnp.asarray([[5.0, 0.0]], jnp.float32),
        jnp.asarray(bparams.numpy()).reshape(1, 40),
        tuple(jnp.asarray(x) for x in recn), gather(tables.atlas_rows, trow, 3),
        gather(tables.grad_rows, brow, 2), gather(tables.env_rows, erow, 3),
        cols, n_pixels=n_pix, width=64, total_work=total_work, max_depth=10,
        env_mode=env_mode, spp=spp, aux=aux, z_max=50.0, aovs=cfg["aovs"],
        want_spec=want_spec, use_reflection=want_spec,
        use_refraction=want_spec, n_beauty=n_beauty,
        vparams=jnp.asarray(vparams[:n_vol]) if n_vol else None,
        interpret=True)
    ref = [np.asarray(x) for x in ref]

    # The reference's outputs in the port's layout.
    na = tfs._n_aov(cfg["aovs"])
    k = 20
    ref_f, ref_i = list(ref[:12]), list(ref[12:16])
    ref_c, ref_t = list(ref[16:19]), [ref[19]]
    if want_spec:
        ref_i += ref[k:k + 3]
        ref_f += ref[k + 3:k + 6]
        ref_c += ref[k + 6:k + 9] + ref[k + 10:k + 13]
        spec_t = [ref[k + 9], ref[k + 13]]
        k += 14
    if cfg["aovs"]:
        ref_c = ref_c[:3] + ref[k:k + na] + ref_c[3:]
        ref_t.append(ref[k + na])
    if want_spec:
        ref_t += spec_t
    step.__dict__.update(recn=recn, ref=ref, ref_f=ref_f, ref_i=ref_i,
                         ref_c=ref_c, ref_t=ref_t)
    return step


def _differing_lanes(s):
    """Lanes on which any output of the port's step differs from the
    reference's: integer rows and targets exactly, float rows beyond 1e-5
    abs + 1e-5 rel."""
    new_f, new_i, contrib, tgt = s.out[:4]
    pairs = [(new_f.numpy(), np.stack(s.ref_f), False),
             (new_i.numpy(), np.stack(s.ref_i), True),
             (contrib.numpy(), np.stack(s.ref_c), False),
             (tgt.numpy(), np.stack(s.ref_t), True)]
    bad = np.zeros(s.p, bool)
    for a, b, exact in pairs:
        assert a.shape == b.shape
        if exact:
            bad |= (a != b).any(0)
        else:
            bad |= ~np.isclose(a, b, rtol=1e-5, atol=1e-5).all(0)
    return bad


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shade_advance_variant_matches_reference(fog_scene, name):
    """P = 8192 lanes (two of the reference's 4096-lane blocks, so the
    respawn carry crosses a block), a random path state on decoded hits
    with 40% of the lanes at bounce 0 and half of them spec lanes; next_work
    leaves less work than there are free lanes. Lanes on which any output
    differs may be at most FLIP_BUDGET of the pool (each is logged); on all
    others integer rows and targets are equal and float rows within 1e-5
    abs + 1e-5 rel."""
    s = _variant_step(fog_scene, name)
    cfg, p, n_pix, sp = s.cfg, s.p, s.n_pix, s.sp
    want_spec, state_i, recn, ref = cfg["want_spec"], s.state_i, s.recn, s.ref
    new_f, new_i, contrib, tgt, nw, seg, lc = s.out
    ref_f, ref_i, ref_c, ref_t = s.ref_f, s.ref_i, s.ref_c, s.ref_t
    bad = _differing_lanes(s)
    for lane in np.flatnonzero(bad):
        print(f"{name}: lane {lane} differs: bounce {state_i[1, lane]} "
              f"hit {recn[tfs._RO_HIT, lane]:.0f} mtype "
              f"{recn[tfs._RO_MTYPE, lane]:.0f}")
    assert bad.mean() <= FLIP_BUDGET, bad.mean()
    if not bad.any():
        assert int(nw) == int(ref[-3][0, 0])
        assert int(lc) == int(ref[-1][0, 0])
    assert int(seg) == int(ref[-2][0, 0])
    # The variant's features act on this input.
    if cfg["fog"]:
        assert (new_i[1] > 0).sum() > 0
    if want_spec:
        assert tgt[-2:].lt(n_pix).any()
    if cfg["aovs"]:
        assert tgt[1].lt(n_pix).any()


def _accumulated_variant(s):
    """K3 fused's plain version on the inputs of _variant_step: its
    outputs and the accumulator as [channels, n + 1]."""
    state_f = torch.as_tensor(s.state_f)
    hits = tk1.closest_hit(state_f[:6], T_MIN, s.tables.scan)
    acc = tfs.new_accumulator(s.sp, "cpu")
    out = tfs.shade_accumulate(
        s.tables, hits, state_f, torch.as_tensor(s.state_i),
        torch.tensor([s.next_work], dtype=torch.int32),
        torch.tensor([5], dtype=torch.int64), torch.zeros(1, dtype=torch.int64),
        tfs._aparams(s.env, "cpu"), s.bparams, s.sp, acc)
    return out, acc.view(len(tfs.acc_channels(s.sp)), s.sp.n_pixels + 1)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_shade_accumulate_plain_is_the_unfused_variant_step(fog_scene, name):
    """K3 fused's plain version in each feature variant equals, bit for
    bit, shade_advance_plain's step followed by one index_add_ of every
    channel with the idle lanes on the dummy slot (the pool's step before
    K3 fused); the pool (8,192 lanes) is larger than the 2,304 pixels, so
    several lanes of one pixel finish in the step, in every channel the
    variant has."""
    s = _variant_step(fog_scene, name, reference=False)
    out, acc = _accumulated_variant(s)
    _, _, contrib, tgt, nw, seg, lc = s.out
    chans = tfs.acc_channels(s.sp)
    stride = s.n_pix + 1
    idx = (tgt[[t for _, t in chans]].to(torch.int64)
           + torch.arange(len(chans))[:, None] * stride)
    old = torch.zeros(len(chans) * stride).index_add_(
        0, idx.reshape(-1), contrib[[c for c, _ in chans]].reshape(-1))
    old = old.view(len(chans), stride)
    assert torch.equal(acc[:, :s.n_pix], old[:, :s.n_pix])
    assert not acc[:, s.n_pix].any()
    for a, b in zip(out[:5], (s.out[0], s.out[1], nw, seg, lc)):
        assert torch.equal(a, b)
    for c, t in chans:
        real = tgt[t][tgt[t] < s.n_pix]
        assert len(real) > len(torch.unique(real)), (c, t)


@pytest.mark.parametrize("name", ["all", "all_hdr"])
def test_shade_accumulate_matches_reference_scatter_with_features(fog_scene,
                                                                  name):
    """Fog, every AOV and both split passes: the accumulated channels
    against np.add.at of the reference step's contributions at its
    targets, within rtol/atol 3e-4 (the reassociation budget), on every
    pixel that no lane of _differing_lanes (at most FLIP_BUDGET of the
    pool) finishes into."""
    s = _variant_step(fog_scene, name)
    _, acc = _accumulated_variant(s)
    want = np.zeros(tuple(acc.shape), np.float32)
    for ch, (c, t) in enumerate(tfs.acc_channels(s.sp)):
        np.add.at(want[ch], s.ref_t[t], s.ref_c[c])
    bad = _differing_lanes(s)
    assert bad.mean() <= FLIP_BUDGET, bad.mean()
    keep = np.ones(s.n_pix, bool)
    keep[s.state_i[3][bad]] = False
    np.testing.assert_allclose(acc[:, :s.n_pix].numpy()[:, keep],
                               want[:, :s.n_pix][:, keep], rtol=3e-4,
                               atol=3e-4)
    assert (acc[:, :s.n_pix].abs().sum(1) > 0).all()


def _features_cfg(w, h, spp, **kw):
    return tint.RenderConfig(width=w, height=h, samples_per_pixel=spp,
                             max_depth=10, use_reflection=True,
                             use_refraction=True, **kw)


def test_features_render_matches_cpu_goldens():
    """The reference's `fused-features` smoke stage (utils/smoke.py:241-292):
    the fog showcase (density 0.02) at 64x36 @ 4 spp, every AOV and both
    passes, seed 0, against its CPU goldens with the stage's budget: mean
    |d| <= 0.01, <= 4% of pixels with a channel over 0.05. The pool is cut
    to 2048 lanes to keep the CPU run short; a lane's path does not depend
    on the pool's size."""
    scene = tpresets.showcase_scene(use_fog=True, fog_density=0.02)
    cam = tcam.make_camera(image_width=64, image_height=36, **CAM_KW)
    out, st = tint.render(scene, cam, tenv.make_environment(**SUN_KW), 0,
                          _features_cfg(64, 36, 4, pool_lanes=2048),
                          device="cpu", with_stats=True)
    for name in ("beauty", "albedo", "reflection"):
        img = out[name].numpy()
        golden = np.load(os.path.join(
            REPO, "tests", "goldens", f"smoke_features_{name}_64x36.npz"))["beauty"]
        d = np.abs(img - golden)
        assert np.isfinite(img).all() and img.max() > 0, name
        assert d.mean() <= 0.01, (name, d.mean())
        assert (d.max(axis=-1) > 0.05).mean() <= 0.04, name
    assert st["segments"] > 2 * 64 * 36 * 4


def test_sample_chunks_count_the_whole_aov_budget(fog_scene, monkeypatch):
    """Two sample chunks give all six buffers of one call: each chunk
    counts its AOV samples against the render's budget (a chunk's own spp
    would drop the second chunk's AOV samples)."""
    cfg = _features_cfg(16, 12, 4)
    cam = tcam.make_camera(image_width=16, image_height=12, **CAM_KW)
    env = tenv.make_environment(**SUN_KW)
    one = twf.render_pool(fog_scene, cam, env, 3, cfg)
    monkeypatch.setattr(tfs, "_TOTAL_WORK_CAP", 2 * 2 * cfg.n_pixels + 1)
    assert tfs.fused_spp_chunk(fog_scene, cfg, env) == 2
    chunked = twf.render_pool(fog_scene, cam, env, 3, cfg)
    for name, a, b in zip(BUFFERS, chunked, one):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, msg=name)
        assert float(b.abs().max()) > 0, name
    img = tint.finalize_buffers(one, cfg)
    # Camera-ray normal colors average over the 4 AOV samples into [0, 1].
    assert 0.0 <= float(img["normal"].min()) and float(img["normal"].max()) <= 1.0


def test_default_render_runs_on_the_fused_pool(fog_scene):
    """The default RenderConfig (AOVs on, wavefront=True) renders all six
    buffers through the fused pool, with and without the split passes."""
    cam = tcam.make_camera(image_width=12, image_height=8, **CAM_KW)
    env = tenv.make_environment(**SUN_KW)
    base = tint.RenderConfig(width=12, height=8, samples_per_pixel=2)
    for cfg in (base, dataclasses.replace(base, use_reflection=True,
                                          use_refraction=True)):
        out, st = tint.render(fog_scene, cam, env, 1, cfg, device="cpu",
                              with_stats=True)
        assert sorted(out) == sorted(BUFFERS) and st["steps"] > 0
        for name, img in out.items():
            assert img.shape == (8, 12, 3) and torch.isfinite(img).all(), name
        assert float(out["albedo"].max()) > 0 and float(out["z_depth"].max()) > 0
        spec = float(out["reflection"].max() + out["refraction"].max())
        assert (spec > 0) == cfg.use_reflection


def test_textured_fog_refused_on_the_fused_pool():
    """Textured fog is outside the fused step: its tables raise, naming
    the unfused pool, which integrator.render routes the render to; the
    unfused pool and the chunked integrator render it and agree within
    float reassociation (lane streams are (pixel, sample)-keyed)."""
    b = SceneBuilder()
    tex = b.textures.add_checker(0.5, (0.9, 0.9, 0.9), (0.1, 0.1, 0.1))
    b.geometry.add_sphere((0.0, -100.5, 0.0), 100.0,
                          b.materials.lambertian("g", (0.5, 0.5, 0.5)))
    b.add_fog_sphere((0.0, 0.5, 0.0), 3.0, 0.3, (1, 1, 1), texture_id=tex)
    scene = b.build()
    cam = tcam.make_camera(image_width=8, image_height=4, **CAM_KW)
    env = tenv.make_environment(**SUN_KW)
    cfg = tint.RenderConfig(width=8, height=4, samples_per_pixel=1)
    pool, st = tint.render(scene, cam, env, 0, cfg, device="cpu",
                           with_stats=True)
    assert st["engine"] == "pool"
    with pytest.raises(NotImplementedError, match="routes textured fog to the "
                                                  "unfused pool"):
        tfs.build_tables(scene, env, cfg.env_mode)
    out = tint.render(scene, cam, env, 0,
                      dataclasses.replace(cfg, wavefront=False), device="cpu")
    assert torch.isfinite(out["beauty"]).all()
    for name in out:
        torch.testing.assert_close(pool[name], out[name], rtol=3e-4, atol=3e-5)
