"""The port's counter-hash lane RNG and polynomial arcs against the
reference's (core/rng.py, core/vecmath.py): bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytracer_project_tpu.core import rng as jrng
from raytracer_project_tpu.core import vecmath as jvm
from raytracer_project_tpu_torch.core import rng as trng
from raytracer_project_tpu_torch.core import vecmath as tvm

torch.set_num_threads(2)


def _u32(r, n):
    return r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("salt", [0, 1, 2, 3])
def test_bits4_and_u01_bit_equal(salt):
    r = np.random.default_rng(10 + salt)
    n = 4096
    pix, samp, ctx = _u32(r, n), _u32(r, n), _u32(r, n) >> 1
    seed = int(_u32(r, 1)[0])
    lj = jrng.LaneRng(jnp.uint32(seed), jnp.asarray(pix), jnp.asarray(samp),
                      jnp.asarray(ctx))
    lt = trng.LaneRng(seed, trng.u32(pix.astype(np.int64)),
                      trng.u32(samp.astype(np.int64)),
                      trng.u32(ctx.astype(np.int64)))
    for stream in (trng.STREAM_CAMERA, trng.STREAM_SCATTER, trng.STREAM_RR,
                   trng.STREAM_VOLUME):
        bj = jrng.bits4(lj, stream, salt)
        bt = trng.bits4(lt, stream, salt)
        for a, b in zip(bj, bt):
            np.testing.assert_array_equal(np.asarray(a),
                                          b.numpy().astype(np.uint32))
            np.testing.assert_array_equal(np.asarray(jrng._u01(a)),
                                          trng._u01(b).numpy())


@pytest.mark.parametrize("k", [0, 1, 7, 123456789, 2**32 - 1])
def test_seed_from_int_matches_prng_key(k):
    assert trng.seed_from_int(k) == int(jrng.seed_from_key(jax.random.PRNGKey(k)))


def test_draws_match_to_float_rounding():
    """The draws share the bits; sin/cos may differ by an ulp."""
    r = np.random.default_rng(3)
    pix, samp = _u32(r, 2048), _u32(r, 2048)
    seed = trng.seed_from_int(5)
    lj = jrng.LaneRng(jnp.uint32(seed), jnp.asarray(pix), jnp.asarray(samp),
                      jnp.uint32(4))
    lt = trng.LaneRng(seed, trng.u32(pix.astype(np.int64)),
                      trng.u32(samp.astype(np.int64)), 4)
    (vj, uj), (vt, ut) = (jrng.draw_unit_vector_and_uniform_soa(lj, 1),
                          trng.draw_unit_vector_and_uniform_soa(lt, 1))
    np.testing.assert_array_equal(np.asarray(uj), ut.numpy())
    for a, b in zip(vj, vt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=3e-7)
    cj, ct = jrng.draw_camera(lj), trng.draw_camera(lt)
    np.testing.assert_array_equal(np.asarray(cj[0][:, 0]), ct[0][0].numpy())
    np.testing.assert_allclose(np.asarray(cj[1][:, 1]), ct[1][1].numpy(),
                               atol=3e-7)


def test_polynomial_arcs_match():
    r = np.random.default_rng(4)
    y = r.normal(size=8192).astype(np.float32)
    x = r.normal(size=8192).astype(np.float32)
    x[:16] = 0.0
    np.testing.assert_allclose(
        tvm.atan2_poly(torch.as_tensor(y), torch.as_tensor(x)).numpy(),
        np.asarray(jvm.atan2_poly(jnp.asarray(y), jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    c = r.uniform(-1.2, 1.2, 8192).astype(np.float32)
    np.testing.assert_allclose(tvm.acos_poly(torch.as_tensor(c)).numpy(),
                               np.asarray(jvm.acos_poly(jnp.asarray(c))),
                               rtol=1e-6, atol=1e-6)
    # Against the exact arcs: the reference's stated ~1e-5 rad.
    np.testing.assert_allclose(
        tvm.atan2_poly(torch.as_tensor(y), torch.as_tensor(x)).numpy(),
        np.arctan2(y, x), atol=2e-5)
