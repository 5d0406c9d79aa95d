"""The port's hit-record decode (K2) and shade-advance (K3) against the
reference's Pallas kernels in interpret mode, on showcase inputs made with
numpy from a seed.

Rule for both: integer-valued rows equal exactly, float rows within
1e-5 abs + 1e-5 rel (the two sides differ only in the ulps of sin, cos
and fused multiply-adds). tests/test_torch_cuda.py holds each CUDA kernel
against these plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracer_project_tpu.models import environment as jenv
from raytracer_project_tpu.models import presets as jpresets
from raytracer_project_tpu.ops import fused_step as jfs
from raytracer_project_tpu_torch.models import environment as tenv
from raytracer_project_tpu_torch.core.constants import T_MIN
from raytracer_project_tpu_torch.models import camera as tcam
from raytracer_project_tpu_torch.models import presets as tpresets
from raytracer_project_tpu_torch.ops import closest_hit as tk1
from raytracer_project_tpu_torch.ops import fused_step as tfs

torch.set_num_threads(2)

HDR = np.linspace(0, 2, 8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
ENV_KW = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0,
              hdr_image=HDR, hdri_rotation=0.5, hdri_tilt=0.2, hdri_roll=0.1,
              intensity=0.8)
# K2 rows that carry integers or flags.
INT_ROWS = (tfs._RO_HIT, tfs._RO_FRONT, tfs._RO_MTYPE, tfs._RO_GU, tfs._RO_GV,
            tfs._RO_HASB, tfs._RO_TEXROW, tfs._RO_BUMPROW, tfs._RO_ENVROW)


@pytest.fixture(scope="module")
def scenes():
    return (jpresets.showcase_scene(with_bvh=False),
            tpresets.showcase_scene())


def _rays(n, seed):
    """Half showcase camera-like rays, half rays from random points above
    the ground in random directions: spheres, triangles, boxes and sky."""
    r = np.random.default_rng(seed)
    m = n // 2
    o_cam = np.tile(np.float32([12.0, 2.5, 6.0]), (m, 1))
    look = np.stack([r.uniform(-4, 4, m), r.uniform(-1, 3, m),
                     r.uniform(-4, 4, m)], 1)
    d_cam = look - o_cam
    o_rnd = np.stack([r.uniform(-8, 8, n - m), r.uniform(0.05, 3, n - m),
                      r.uniform(-8, 8, n - m)], 1)
    d_rnd = r.normal(size=(n - m, 3))
    o = np.concatenate([o_cam, o_rnd]).astype(np.float32)
    d = np.concatenate([d_cam, d_rnd]).astype(np.float32)
    return o, d


def _assert_rows(a, b, int_rows, mask=None):
    a, b = np.asarray(a), np.asarray(b)
    if mask is not None:
        a, b = a[:, mask], b[:, mask]
    for k in range(a.shape[0]):
        if k in int_rows:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"row {k}")
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"row {k}")


def _port_tables(scene, env_mode):
    return tfs.build_tables(scene, tenv.make_environment(**ENV_KW), env_mode)


def test_trace_decode_matches_reference(scenes):
    js, ts = scenes
    o, d = _rays(2048, 0)
    env_j = jenv.make_environment(**ENV_KW)
    jt = jfs.build_tables(js, env_j, jenv.HDR_MAP)
    aparams = tfs._aparams(tenv.make_environment(**ENV_KW), "cpu")
    ref = jfs.trace_decode(
        js, jt, tuple(jnp.asarray(o[:, k]) for k in range(3)),
        tuple(jnp.asarray(d[:, k]) for k in range(3)),
        jnp.asarray(aparams.numpy()).reshape(1, 8),
        (float(HDR.shape[0]), float(HDR.shape[1])), interpret=True)
    ref = np.stack([np.asarray(x) for x in ref])
    od = torch.as_tensor(np.concatenate([o.T, d.T]))
    out = tfs.trace_decode(_port_tables(ts, tenv.HDR_MAP), od, aparams).numpy()
    # Lanes whose closest hit agrees: both miss, or both hit at the same t
    # to f32 rounding (the two sides sum the coefficient dots in another
    # order).
    tr, to = ref[tfs._RO_T], out[tfs._RO_T]
    agree = np.abs(tr - to) <= 1e-5 * np.abs(tr)
    assert agree.mean() >= 0.99, agree.mean()
    assert (ref[tfs._RO_HIT] > 0.5).mean() > 0.5  # mostly hits
    _assert_rows(out, ref, INT_ROWS, agree)


def _k3_inputs(ts, p, seed):
    """Realistic K3 inputs: decoded hits of random rays plus a random path
    state, some lanes dead, bounces past the roulette start."""
    r = np.random.default_rng(seed)
    o, d = _rays(p, seed)
    tables = _port_tables(ts, tenv.PHYSICAL_SUN)
    aparams = tfs._aparams(tenv.make_environment(**ENV_KW), "cpu")
    od = torch.as_tensor(np.concatenate([o.T, d.T]))
    rec = tfs.trace_decode(tables, od, aparams)
    state_f = np.concatenate([
        o.T, d.T, r.uniform(0.0, 1.0, (3, p)), r.uniform(0.0, 2.0, (3, p)),
    ]).astype(np.float32)
    state_i = np.stack([
        (r.random(p) < 0.85).astype(np.int32),
        r.integers(0, 13, p).astype(np.int32),
        r.integers(0, 4, p).astype(np.int32),
        r.integers(0, 64 * 36, p).astype(np.int32),
    ])
    return tables, rec, torch.as_tensor(state_f), torch.as_tensor(state_i)


@pytest.mark.parametrize("env_mode", [tenv.PHYSICAL_SUN, tenv.SOLID_COLOR,
                                      tenv.HDR_MAP])
def test_shade_advance_matches_reference(scenes, env_mode):
    """P = 8192 is two of the reference's 4096-lane blocks, so the respawn
    carry between blocks is exercised; next_work is set so that the work
    runs out part-way through the free lanes."""
    js, ts = scenes
    p = 8192
    tables, rec, state_f, state_i = _k3_inputs(ts, p, 1)
    tables = _port_tables(ts, env_mode)
    from raytracer_project_tpu_torch.models import camera as tcam
    cam = tcam.make_camera(image_width=64, image_height=36, vfov=30.0,
                           lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
    bparams = tfs._bparams(cam, tenv.make_environment(**ENV_KW), "cpu")
    seed = 0x9E3779B9
    sp = tfs.StepParams(seed=seed, sample_offset=3, n_pixels=64 * 36, width=64,
                        total_work=64 * 36 * 4, max_depth=10, env_mode=env_mode)
    next_work = 7000
    out = tfs.shade_advance(
        tables, rec, state_f, state_i,
        torch.tensor([next_work], dtype=torch.int32),
        torch.tensor([5], dtype=torch.int64), bparams, sp)
    new_f, new_i, contrib, tgt, nw, seg, lc = out

    # The reference's seam: texel, bump and HDR rows gathered outside.
    recn = rec.numpy()
    trow = np.clip(recn[tfs._RO_TEXROW], 0, None).astype(np.int32)
    brow = np.clip(recn[tfs._RO_BUMPROW], 0, None).astype(np.int32)
    tex3 = tuple(jnp.asarray(tables.atlas_rows.numpy()[trow, k]) for k in range(3))
    bump2 = tuple(jnp.asarray(tables.grad_rows.numpy()[brow, k]) for k in range(2))
    erow = recn[tfs._RO_ENVROW].astype(np.int32)
    env3 = tuple(jnp.asarray(tables.env_rows.numpy()[erow, k]) for k in range(3))
    iscal = jnp.asarray(np.array([[np.uint32(seed).view(np.int32), next_work,
                                   3, 0]], np.int32))
    fscal = jnp.asarray([[5.0, 0.0]], jnp.float32)
    cols = tuple(jnp.asarray(x) for x in state_f.numpy()) + tuple(
        jnp.asarray(x) for x in state_i.numpy())
    ref = jfs.shade_advance(
        None, iscal, fscal, jnp.asarray(bparams.numpy()).reshape(1, 40),
        tuple(jnp.asarray(x) for x in recn), tex3, bump2, env3, cols,
        n_pixels=sp.n_pixels, width=sp.width, total_work=sp.total_work,
        max_depth=sp.max_depth, env_mode=env_mode, spp=4, aux=0, z_max=50.0,
        aovs=(), interpret=True)
    ref = [np.asarray(x) for x in ref]
    _assert_rows(new_f, np.stack(ref[:12]), ())
    np.testing.assert_array_equal(new_i.numpy(), np.stack(ref[12:16]))
    _assert_rows(contrib, np.stack(ref[16:19]), ())
    assert tgt.shape == (1, p)
    np.testing.assert_array_equal(tgt[0].numpy(), ref[19])
    assert int(nw) == int(ref[20][0, 0])
    assert int(seg) == int(ref[21][0, 0])
    assert int(lc) == int(ref[22][0, 0])
    # More lanes were free than work was left: the counter reached the cap.
    spawned = int(((new_i[0] == 1) & (new_i[1] == 0)).sum())
    assert spawned == sp.total_work - next_work
    assert int(nw) == sp.total_work


# --- K3 fused: decode, shade, advance and accumulate in one step -----------

# Beauty steps of P = 8192 lanes: the pool smaller than the pixel count
# with one lane per pixel, a pixel window (pixel_offset > 0) of the same
# frame, and a pool larger than the pixel count, where several lanes of
# one pixel finish in the same step.
STEP_CASES = {
    "beauty": dict(n_pixels=128 * 72, pixel_offset=0, one_lane_per_pixel=True),
    "window": dict(n_pixels=8192, pixel_offset=1024, one_lane_per_pixel=True),
    "pool_over_pixels": dict(n_pixels=64 * 36, pixel_offset=0,
                             one_lane_per_pixel=False),
}


def _step_inputs(ts, case):
    """(tables, hits, aparams, bparams, sp, state_f, state_i, next_work,
    segments) of one beauty step: decoded hits of random rays (as
    _k3_inputs) on a random path state whose pixels follow the case."""
    c = STEP_CASES[case]
    p, n, poff = 8192, c["n_pixels"], c["pixel_offset"]
    r = np.random.default_rng(5)
    o, d = _rays(p, 5)
    tables = _port_tables(ts, tenv.PHYSICAL_SUN)
    env = tenv.make_environment(**ENV_KW)
    cam = tcam.make_camera(image_width=128, image_height=72, vfov=30.0,
                           lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0))
    sp = tfs.StepParams(seed=0x9E3779B9, sample_offset=3, n_pixels=n,
                        width=128, total_work=n * 4, max_depth=10,
                        env_mode=tenv.PHYSICAL_SUN, pixel_offset=poff)
    slots = (r.permutation(n)[:p] if c["one_lane_per_pixel"]
             else r.integers(0, n, p))
    state_f = np.concatenate([
        o.T, d.T, r.uniform(0.0, 1.0, (3, p)), r.uniform(0.0, 2.0, (3, p)),
    ]).astype(np.float32)
    state_i = np.stack([(r.random(p) < 0.85), r.integers(0, 13, p),
                        r.integers(0, 4, p), poff + slots]).astype(np.int32)
    state_f = torch.as_tensor(state_f)
    hits = tk1.closest_hit(state_f[:6], T_MIN, tables.scan)
    return (tables, hits, tfs._aparams(env, "cpu"), tfs._bparams(cam, env, "cpu"),
            sp, state_f, torch.as_tensor(state_i),
            torch.tensor([sp.total_work - 1200], dtype=torch.int32),
            torch.tensor([5], dtype=torch.int64))


def _accumulated_step(scenes, case):
    """The inputs of `case` and K3 fused's plain version run on them:
    (inputs, its outputs, the accumulator as [channels, n + 1])."""
    inputs = _step_inputs(scenes[1], case)
    tables, hits, aparams, bparams, sp, sf, si, nw, seg = inputs
    acc = tfs.new_accumulator(sp, "cpu")
    steps = torch.zeros(1, dtype=torch.int64)
    out = tfs.shade_accumulate(tables, hits, sf, si, nw, seg, steps, aparams,
                               bparams, sp, acc)
    assert out[5] is steps and int(steps) == 1
    return inputs, out, acc.view(len(tfs.acc_channels(sp)), sp.n_pixels + 1)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_shade_accumulate_plain_is_the_unfused_step(scenes, case):
    """K3 fused's plain version equals, bit for bit, the step it replaces
    on the main path: trace_decode, shade_advance_plain, then one
    index_add_ of every channel with the idle lanes on the dummy slot n;
    it leaves the dummy slots at zero."""
    inputs, out, acc = _accumulated_step(scenes, case)
    tables, hits, aparams, bparams, sp, sf, si, nw, seg = inputs
    rec = tfs.trace_decode(tables, sf[:6], aparams)
    ref = tfs.shade_advance_plain(tables, rec, sf, si, nw, seg, bparams, sp)
    chans = tfs.acc_channels(sp)
    stride = sp.n_pixels + 1
    idx = (ref[3][[t for _, t in chans]].to(torch.int64)
           + torch.arange(len(chans))[:, None] * stride)
    old = torch.zeros(len(chans) * stride).index_add_(
        0, idx.reshape(-1), ref[2][[c for c, _ in chans]].reshape(-1))
    old = old.view(len(chans), stride)
    n = sp.n_pixels
    assert torch.equal(acc[:, :n], old[:, :n])
    assert not acc[:, n].any()
    for a, b in zip(out[:5], (ref[0], ref[1], ref[4], ref[5], ref[6])):
        assert torch.equal(a, b)
    finished = ref[3][0][ref[3][0] < n]
    assert len(finished) > 100
    many = len(finished) > len(torch.unique(finished))
    assert many == (case == "pool_over_pixels")


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_shade_accumulate_matches_reference_scatter(scenes, case):
    """The accumulated channels against np.add.at of the reference step's
    contributions at its targets (jfs.shade_advance in interpret mode on
    the same record rows, texel rows gathered outside as its seam does),
    within rtol/atol 3e-4, the reassociation budget."""
    inputs, out, acc = _accumulated_step(scenes, case)
    tables, hits, aparams, bparams, sp, sf, si, nw, seg = inputs
    rec = tfs.decode_plain(tables, sf[:6], *hits, aparams).numpy()
    trow = np.clip(rec[tfs._RO_TEXROW], 0, None).astype(np.int32)
    brow = np.clip(rec[tfs._RO_BUMPROW], 0, None).astype(np.int32)
    gather = lambda tab, rows, k: tuple(jnp.asarray(tab.numpy()[rows, c])
                                        for c in range(k))
    iscal = jnp.asarray(np.array([[np.uint32(sp.seed).view(np.int32),
                                   int(nw[0]), sp.sample_offset,
                                   sp.pixel_offset]], np.int32))
    ref = jfs.shade_advance(
        None, iscal, jnp.asarray([[5.0, 0.0]], jnp.float32),
        jnp.asarray(bparams.numpy()).reshape(1, 40),
        tuple(jnp.asarray(x) for x in rec), gather(tables.atlas_rows, trow, 3),
        gather(tables.grad_rows, brow, 2),
        gather(tables.env_rows, np.zeros_like(trow), 3),
        tuple(jnp.asarray(x) for x in sf.numpy())
        + tuple(jnp.asarray(x) for x in si.numpy()),
        n_pixels=sp.n_pixels, width=sp.width, total_work=sp.total_work,
        max_depth=sp.max_depth, env_mode=sp.env_mode, spp=4, aux=0,
        z_max=50.0, aovs=(), interpret=True)
    want = np.zeros((3, sp.n_pixels + 1), np.float32)
    for c in range(3):
        np.add.at(want[c], np.asarray(ref[19]), np.asarray(ref[16 + c]))
    n = sp.n_pixels
    np.testing.assert_allclose(acc[:, :n].numpy(), want[:, :n], rtol=3e-4,
                               atol=3e-4)
    assert float(acc.sum()) > 0
    np.testing.assert_array_equal(out[1].numpy(),
                                  np.stack([np.asarray(x) for x in ref[12:16]]))


@pytest.mark.parametrize("features", [False, True])
def test_k3_wrappers_pass_their_c_signatures(scenes, features, monkeypatch):
    """The CUDA branches of shade_advance and shade_accumulate, driven with
    meta tensors: each launch passes as many arguments as its C entry's
    ctypes signature has (the stream last), a tensor exactly where the
    signature has a pointer."""
    from raytracer_project_tpu_torch import kernels

    seen = []

    def launch(entry, *args):
        types = kernels.SIGNATURES[entry][1]
        assert len(args) + 1 == len(types), entry
        for k, (a, t) in enumerate(zip(args, types)):
            assert isinstance(a, torch.Tensor) == (t is kernels._P), (entry, k)
        seen.append(entry)

    monkeypatch.setattr(kernels, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "launch", launch)
    tables = _port_tables(scenes[1], tenv.PHYSICAL_SUN)
    sp = tfs.StepParams(seed=1, sample_offset=0, n_pixels=100, width=10,
                        total_work=400, max_depth=5, env_mode=0,
                        aovs=tfs.AOVS if features else (),
                        use_reflection=features, use_refraction=features,
                        n_beauty=200)
    meta = lambda shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device="meta")
    p, i32, i64 = 512, torch.int32, torch.int64
    nf, ni = tfs.state_rows(sp)
    state = (meta((nf, p)), meta((ni, p), i32), meta(1, i32), meta(1, i64))
    tfs.shade_advance(tables, meta((tfs._RO_ROWS, p)), *state, meta(40), sp)
    acc = meta(len(tfs.acc_channels(sp)) * (sp.n_pixels + 1))
    tfs.shade_accumulate(tables, (meta(p), meta(p, i32), meta(p, i32)),
                         *state, meta(1, i64), meta(8), meta(40), sp, acc)
    assert seen == ["shade_advance_launch", "shade_accumulate_launch"]
