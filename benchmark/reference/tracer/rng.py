"""Frozen copy of raytracer_project_tpu_torch/core/rng.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import vecmath


MASK32 = 0xFFFFFFFF


_C0 = 0x9E3779B9


_C1 = 0x85EBCA6B


_C2 = 0xC2B2AE35


_C3 = 0x27D4EB2F


STREAM_CAMERA = 0


STREAM_SCATTER = 1


STREAM_RR = 2


STREAM_VOLUME = 3


_N_STREAMS = 16


TWO_PI = 6.2831855  # f32(2 * pi), the constant the reference's f32 math uses


class LaneRng(NamedTuple):
    """Per-lane stateless stream: seed is a Python int (u32); pix, samp and
    ctx are int64 tensors holding u32 values (ctx may be a Python int)."""

    seed: int
    pix: torch.Tensor
    samp: torch.Tensor
    ctx: object

    def with_ctx(self, bounce: int, spec: int = 0) -> "LaneRng":
        """Context of an absolute bounce index and the spec-pass flag:
        (bounce << 1) | spec."""
        return self._replace(ctx=((int(bounce) << 1) | int(spec)) & MASK32)


def lane_rng(seed: int, pix, samp=0, ctx=0) -> LaneRng:
    """LaneRng of the u32 seed for lanes (pix, samp); pix and samp are
    tensors (or ints) of u32 values."""
    pix = u32(pix)
    return LaneRng(seed, pix, u32(samp).to(pix.device), ctx)


def seed_from_int(k) -> int:
    """u32 seed of a render seed: an integer k is the reference's
    seed_from_key(PRNGKey(k)) = data[0] + data[1] * 0x9E3779B9 with key
    data [0, k]; a Key maps by the same rule from its own data."""
    if isinstance(k, Key):
        return (k.hi + k.lo * _C0) & MASK32
    return (int(k) * _C0) & MASK32


class Key(NamedTuple):
    """The two u32 words of a reference PRNG key (threefry2x32 key data
    [hi, lo]); PRNGKey(k) is Key(0, k). The render entry points take one
    wherever they take an integer seed."""

    hi: int
    lo: int


def _threefry2x32(k0: int, k1: int, x0: int, x1: int):
    """Threefry-2x32, 20 rounds, of one counter pair (x0, x1) under key
    (k0, k1): the block function of the reference's PRNG keys. Every
    argument may also be an int64 tensor of u32 values (elementwise)."""
    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & MASK32

    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x0 + ks[0]) & MASK32, (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in(key, data) of a threefry key, bit for bit: the
    block function of (0, data) under the key."""
    return Key(*_threefry2x32(key.hi, key.lo, 0, int(data) & MASK32))


def _uniform2_threefry(k0, k1):
    """jax.random.uniform(key, (2,)) of per-lane keys (k0, k1), bit for bit:
    bits i = y0 ^ y1 of the block of (0, i), mantissa-filled floats in
    [0, 1). Returns two f32 tensors."""
    out = []
    for i in range(2):
        y0, y1 = _threefry2x32(k0, k1, torch.zeros_like(k0),
                               torch.full_like(k0, i))
        bits = ((y0 ^ y1) >> 9) | 0x3F800000
        out.append(bits.to(torch.int32).view(torch.float32) - 1.0)
    return out


def camera_draws_threefry(key: Key, lane_ids):
    """The reference's per-lane-key camera draws (its rng.per_lane_keys,
    split_each(2), square_jitter_each and in_unit_disk_each, which its BVH
    debug view takes), bit for bit up to cos/sin: ((jitter x, jitter y) in
    [-0.5, 0.5), unit-disk point (r0, r1)) per lane id."""
    ids = u32(lane_ids)
    zero = torch.zeros_like(ids)
    k0, k1 = _threefry2x32(key.hi, key.lo, zero, ids)      # fold_in
    # split(k, 2): key i is the block of (0, i) under k.
    jk = _threefry2x32(k0, k1, zero, zero)
    dk = _threefry2x32(k0, k1, zero, zero + 1)
    jx, jy = (u - 0.5 for u in _uniform2_threefry(*jk))
    u0, u1 = _uniform2_threefry(*dk)
    r = torch.sqrt(u0)
    theta = TWO_PI * u1
    return (jx, jy), (r * torch.cos(theta), r * torch.sin(theta))


def u32(x) -> torch.Tensor:
    """Tensor of u32 values as int64 (i32 inputs reinterpret modulo 2^32)."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def _mix4(a, b, c, d):
    """Three ChaCha quarter-rounds over the 4-word state (reference
    core/rng.py:105-126)."""
    a = a ^ _C0
    b = (b + _C1) & MASK32
    c = c ^ _C2
    d = (d + _C3) & MASK32
    for _ in range(3):
        a = (a + b) & MASK32
        d = _rotl(d ^ a, 16)
        c = (c + d) & MASK32
        b = _rotl(b ^ c, 12)
        a = (a + b) & MASK32
        d = _rotl(d ^ a, 8)
        c = (c + d) & MASK32
        b = _rotl(b ^ c, 7)
    return a, b, c, d


def bits4(lr: LaneRng, stream: int, salt: int = 0):
    """Four u32 words (int64 tensors) for this lane batch at a draw site."""
    word = (torch.as_tensor(lr.ctx, dtype=torch.int64) * _N_STREAMS
            + stream) & MASK32
    seed = (lr.seed + ((salt * _C1) & MASK32)) & MASK32
    pix, samp, word = torch.broadcast_tensors(lr.pix, lr.samp,
                                              word.to(lr.pix.device))
    return _mix4(pix, samp, word, torch.full_like(pix, seed))


def _u01(bits) -> torch.Tensor:
    """u32 -> f32 uniform in [0, 1): top 24 bits, exact integer convert."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def draw_uniform(lr: LaneRng, stream: int, salt: int = 0) -> torch.Tensor:
    a, _, _, _ = bits4(lr, stream, salt)
    return _u01(a)


def draw_unit_vector_and_uniform_soa(lr: LaneRng, stream: int):
    """((x, y, z) uniform unit-sphere vector, uniform) from one hash."""
    a, b, c, _ = bits4(lr, stream)
    z = 1.0 - 2.0 * _u01(a)
    phi = TWO_PI * _u01(b)
    r = vecmath.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return (r * torch.cos(phi), r * torch.sin(phi), z), _u01(c)


def draw_unit_vector_and_uniform(lr: LaneRng, stream: int):
    """AoS form of the draw above: (unit vector [N, 3], uniform [N])."""
    vec, u = draw_unit_vector_and_uniform_soa(lr, stream)
    return torch.stack(vec, dim=-1), u


def draw_camera(lr: LaneRng, stream: int = STREAM_CAMERA):
    """(jitter x, jitter y) in [-0.5, 0.5) and a unit-disk point (r0, r1)
    from one hash (camera.hpp:784-794)."""
    a, b, c, d = bits4(lr, stream)
    jx = _u01(a) - 0.5
    jy = _u01(b) - 0.5
    r = vecmath.sqrt(_u01(c))
    theta = TWO_PI * _u01(d)
    return (jx, jy), (r * torch.cos(theta), r * torch.sin(theta))

