"""Stackless (threaded) BVH traversal over ray batches (twin of
raytracer_project_tpu/ops/traverse.py).

The state of a lane is one node index. On an AABB hit an internal node
falls through to its first child (i + 1, DFS layout); otherwise, and after
a leaf's primitive tests, the lane jumps to the node's escape link. The
closest hit so far shrinks the slab interval, as the reference engine's
`ray_t.max` does (bvh.hpp:113-118).

All lanes step in lock-step, each step a fixed sequence of torch ops over
every lane; finished lanes (node -1) are masked. The arithmetic is the
reference's float32 arithmetic: the 1/d clamp at 1e-20, the slab interval
clamped to [tmin, best t], and the leaf tests of ops/intersect.py's
brute-force oracle, so the two find the same hits.

Whether any lane is still live is a host read, which waits for the device.
It is taken every STOP_CHECK_EVERY steps: one step is ~40 small kernels,
so 8 steps keep the launch queue fed between reads, and the at most 7
steps run after the last lane finishes are masked no-ops (a few percent of
the hundreds of steps a batch takes).
"""

from __future__ import annotations

import torch

from ..core import vecmath
from ..core.constants import T_MAX
from ..models.geometry import PRIM_BOX, PRIM_SPHERE
from . import intersect
from .intersect import Hit

STOP_CHECK_EVERY = 8


def _leaf_candidates(bvh, slots, o, d, tmin, tmax):
    """Candidate t of a [N, K] block of leaf slots (clipped slot ids; the
    caller masks invalid ones), with each slot's (type, row). tmin, tmax
    f32[N, 1]. The tests are those of intersect_brute, on per-lane rows."""
    ptype = bvh.prim_type[slots]
    prow = bvh.prim_row[slots]

    # Sphere (sphere.hpp:18-39).
    oc = bvh.slot_center[slots] - o[:, None, :]
    radius = bvh.slot_radius[slots]
    a = (d * d).sum(-1)[:, None]
    h = (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - radius * radius
    disc = h * h - a * c
    sq = vecmath.safe_sqrt(disc)
    inv_a = 1.0 / a
    r0 = (h - sq) * inv_a
    r1 = (h + sq) * inv_a
    ok0 = (r0 > tmin) & (r0 < tmax)
    ok1 = (r1 > tmin) & (r1 < tmax)
    t_sph = torch.where((disc >= 0.0) & (ok0 | ok1) & (radius > 0.0),
                        torch.where(ok0, r0, r1), T_MAX)

    # Two-sided Moller-Trumbore (triangle.hpp:17-82).
    e1 = bvh.slot_e1[slots]
    e2 = bvh.slot_e2[slots]
    d_b = d[:, None, :].expand_as(e2)
    pvec = torch.linalg.cross(d_b, e2, dim=-1)
    det = (e1 * pvec).sum(-1)
    near_zero = torch.abs(det) < 1e-12
    inv_det = 1.0 / torch.where(near_zero, 1.0, det)
    tvec = o[:, None, :] - bvh.slot_v0[slots]
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = (d_b * qvec).sum(-1) * inv_det
    t_raw = (e2 * qvec).sum(-1) * inv_det
    t_tri = torch.where(~near_zero & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                        & (t_raw > tmin) & (t_raw < tmax), t_raw, T_MAX)

    # Affine-slab box (cube.hpp:44-86).
    m = bvh.slot_minv[slots].reshape(*slots.shape, 3, 3)
    o_l = torch.einsum("nkij,nj->nki", m, o) + bvh.slot_trans[slots]
    d_l = torch.einsum("nkij,nj->nki", m, d)
    inv = intersect._safe_inv(d_l)
    b0 = (-1.0 - o_l) * inv
    b1 = (1.0 - o_l) * inv
    bt_near = torch.minimum(b0, b1).amax(-1)
    bt_far = torch.maximum(b0, b1).amin(-1)
    t_box_raw = torch.where(bt_near > tmin, bt_near, bt_far)
    t_box = torch.where((bt_near < bt_far) & (t_box_raw > tmin)
                        & (t_box_raw < tmax), t_box_raw, T_MAX)

    t = torch.where(ptype == PRIM_SPHERE, t_sph,
                    torch.where(ptype == PRIM_BOX, t_box, t_tri))
    return t, ptype, prow


def intersect_bvh(scene, o, d, tmin: float, stats: dict | None = None) -> Hit:
    """Closest hit of the rays o, d f32[N, 3] beyond tmin by threaded-BVH
    traversal of scene.bvh (on the rays' device). stats, when given, adds
    the steps taken under "iterations"."""
    return intersect_flat(scene.bvh, o, d, tmin, stats)


def intersect_flat(bvh, o, d, tmin: float, stats: dict | None = None) -> Hit:
    """`intersect_bvh` over the FlatBVH `bvh` itself: the plain version of
    the fused pool's BVH closest hit (ops/closest_hit.py)."""
    n = o.shape[0]
    dev = o.device
    k = bvh.leaf_size
    n_slots = bvh.prim_type.shape[0]
    tmin_n = torch.full((n,), tmin, dtype=torch.float32, device=dev)
    tmin_c = tmin_n[:, None]
    small = torch.abs(d) < 1e-20
    inv_d = 1.0 / torch.where(small, torch.where(d < 0, -1e-20, 1e-20), d)
    lane = torch.arange(n, device=dev)
    kk = torch.arange(k, dtype=torch.int32, device=dev)[None, :]

    node = torch.zeros((n,), dtype=torch.int32, device=dev)
    best_t = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    best_type = torch.zeros((n,), dtype=torch.int32, device=dev)
    best_row = torch.zeros((n,), dtype=torch.int32, device=dev)
    steps = 0
    while True:
        if steps % STOP_CHECK_EVERY == 0 and not bool((node >= 0).any()):
            break
        steps += 1
        live = node >= 0
        ni = torch.clamp(node, min=0).long()

        # Slab test (aabb.hpp:44-66) against the shrunken [tmin, best_t].
        t0 = (bvh.node_min[ni] - o) * inv_d
        t1 = (bvh.node_max[ni] - o) * inv_d
        t_near = torch.maximum(torch.minimum(t0, t1).amax(-1), tmin_n)
        t_far = torch.minimum(torch.maximum(t0, t1).amin(-1), best_t)
        box_hit = live & (t_near <= t_far)

        count = bvh.count[ni]
        is_leaf = count > 0
        test_leaf = box_hit & is_leaf

        # Leaf primitive tests; slots past the leaf's count are masked.
        slots = torch.clamp(bvh.first[ni][:, None] + kk, 0, n_slots - 1).long()
        t_cand, ptype, prow = _leaf_candidates(bvh, slots, o, d, tmin_c,
                                               best_t[:, None])
        valid = (kk < count[:, None]) & test_leaf[:, None]
        t_cand = torch.where(valid, t_cand, T_MAX)
        k_best = torch.argmin(t_cand, dim=-1)
        cand_t = t_cand[lane, k_best]
        better = cand_t < best_t
        best_t = torch.where(better, cand_t, best_t)
        best_type = torch.where(better, ptype[lane, k_best], best_type)
        best_row = torch.where(better, prow[lane, k_best], best_row)

        # Descend on an internal hit, else take the escape link.
        nxt = torch.where(box_hit & ~is_leaf, node + 1, bvh.escape[ni])
        node = torch.where(live, nxt, node)
    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + steps
    return Hit(t=best_t, prim_type=best_type, prim_idx=best_row,
               hit=best_t < T_MAX)
