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
from raytracer_project_tpu_torch.models import presets as tpresets
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
