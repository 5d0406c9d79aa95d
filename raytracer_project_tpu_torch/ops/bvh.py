"""BVH construction (twin of raytracer_project_tpu/ops/bvh.py): a host-side
build into flat, threaded (stackless) arrays.

The tree is binned SAH on the largest centroid extent (the default), or
`median_random_axis`, the reference engine's random-axis median split
(bvh.hpp:15-42), kept for A/B comparison. It is emitted depth-first with
escape links: a ray descends from node i to i + 1 on an AABB hit and
jumps to `escape[i]` otherwise, so the traversal's state is one node index
per lane (ops/traverse.py). Leaf primitives are reordered into contiguous
slots, and each slot carries its primitive's data, so a leaf is one gather
of at most `leaf_size` rows.

The SAH build runs in the native library (native/, the port's copy of
csrc/zenith_native.cpp) when it builds, and in Python otherwise or with
use_native=False. The two SAH trees may differ in shape; every tree gives
the same closest hits.

`hit_bvh` hands a scene's tree to the fused pool's closest hit
(ops/closest_hit.py): the tree on the scene's device and its node records
packed for the kernel (csrc/bvh_hit.cu), built once per scene.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..core.tree import to_device
from ..models.geometry import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE
from ..utils import spans

# AABB padding (the reference engine's aabb-expand delta, triangle.hpp:95,
# cube.hpp:35).
PAD = 1e-4
# Large leaves: the lock-step traversal pays per node step, while a leaf's
# primitive tests are one wide vectorized op.
DEFAULT_LEAF_SIZE = 16
SAH_BINS = 16
# The kernel's node records (csrc/bvh_hit.cu): a leaf's word is
# (first slot << LEAF_SHIFT) | count, so a leaf holds at most LEAF_MAX
# slots and a tree at most SLOT_MAX.
LEAF_SHIFT = 8
LEAF_MAX = (1 << LEAF_SHIFT) - 1
SLOT_MAX = 1 << (31 - LEAF_SHIFT)
# Each node box is widened by NODE_PAD plus NODE_PAD_REL of its largest
# coordinate on each axis when packed for the kernel: more than the
# rounding of the slab test and of the primitives' f32 bounds, so that no
# primitive the epilogue hits is culled (a wider box costs a test, never a
# hit).
NODE_PAD = PAD
NODE_PAD_REL = 2.0 ** -20


class FlatBVH(NamedTuple):
    """Threaded flat BVH: NN nodes in DFS order, P leaf slots.

    node_min/max f32[NN, 3]  AABB slabs
    escape       i32[NN]     node to jump to when this subtree is done or
                             missed (-1 ends the traversal)
    first        i32[NN]     leaf: first slot; internal: -1
    count        i32[NN]     leaf: primitive count; internal: 0
    prim_type    i32[P]      PRIM_SPHERE / PRIM_TRIANGLE / PRIM_BOX per slot
    prim_row     i32[P]      row in the per-type table
    node_level   i32[NN]     depth of each node (root 0)
    slot_center  f32[P, 3]   sphere center (zeros for others)
    slot_radius  f32[P]      sphere radius (0 for others: never hit)
    slot_v0/e1/e2 f32[P, 3]  triangle data (zeros for others: det 0, miss)
    slot_minv    f32[P, 9]   box world -> local rows (zeros for others)
    slot_trans   f32[P, 3]   box translation (1e6 for others: miss)
    n_levels     int         tree depth
    leaf_size    int         most primitives in a leaf (the gather width)
    """

    node_min: torch.Tensor
    node_max: torch.Tensor
    escape: torch.Tensor
    first: torch.Tensor
    count: torch.Tensor
    prim_type: torch.Tensor
    prim_row: torch.Tensor
    node_level: torch.Tensor
    slot_center: torch.Tensor
    slot_radius: torch.Tensor
    slot_v0: torch.Tensor
    slot_e1: torch.Tensor
    slot_e2: torch.Tensor
    slot_minv: torch.Tensor
    slot_trans: torch.Tensor
    n_levels: int
    leaf_size: int

    @property
    def node_count(self) -> int:
        return int(self.escape.shape[0])

    def to(self, device):
        return to_device(self, device)


def flat_bvh_from_numpy(d: dict) -> FlatBVH:
    """FlatBVH from a {field name: numpy array} dict, such as the reference
    package's FlatBVH fields; n_levels and leaf_size, when absent, follow
    from the levels and leaf counts."""
    arrays = {k: torch.as_tensor(np.array(d[k]))
              for k in FlatBVH._fields if k not in ("n_levels", "leaf_size")}
    n_levels = int(np.asarray(d["n_levels"])) if "n_levels" in d else int(
        np.asarray(d["node_level"]).max()) + 1
    leaf_size = int(np.asarray(d["leaf_size"])) if "leaf_size" in d else max(
        1, int(np.asarray(d["count"]).max()))
    return FlatBVH(**arrays, n_levels=n_levels, leaf_size=leaf_size)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def primitive_bounds(scene) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """Per-primitive AABBs f32[n, 3] (min, max) and (type, row) ids i32[n]
    of every live primitive: spheres of positive radius, triangles of
    nonzero area, boxes with a finite AABB."""
    mins, maxs, types, rows = [], [], [], []

    centers = _np(scene.spheres.center)
    radii = _np(scene.spheres.radius)
    valid = radii > 0.0
    if valid.any():
        c, r = centers[valid], radii[valid][:, None]
        mins.append(c - r)
        maxs.append(c + r)
        types.append(np.full(len(c), PRIM_SPHERE, np.int32))
        rows.append(np.nonzero(valid)[0].astype(np.int32))

    v0 = _np(scene.triangles.v0)
    e1 = _np(scene.triangles.e1)
    e2 = _np(scene.triangles.e2)
    keep = ~(np.linalg.norm(np.cross(e1, e2), axis=-1) < 1e-12)
    if keep.any():
        p0, p1, p2 = v0[keep], v0[keep] + e1[keep], v0[keep] + e2[keep]
        mins.append(np.minimum(np.minimum(p0, p1), p2) - PAD)
        maxs.append(np.maximum(np.maximum(p0, p1), p2) + PAD)
        types.append(np.full(keep.sum(), PRIM_TRIANGLE, np.int32))
        rows.append(np.nonzero(keep)[0].astype(np.int32))

    if getattr(scene, "boxes", None) is not None:
        bmin = _np(scene.boxes.aabb_min)
        bmax = _np(scene.boxes.aabb_max)
        bvalid = (bmin <= bmax).all(axis=-1)   # dummy rows are inverted-inf
        if bvalid.any():
            mins.append(bmin[bvalid] - PAD)
            maxs.append(bmax[bvalid] + PAD)
            types.append(np.full(bvalid.sum(), PRIM_BOX, np.int32))
            rows.append(np.nonzero(bvalid)[0].astype(np.int32))

    if not mins:
        # Empty scene: one never-hit leaf.
        return (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                np.asarray([PRIM_SPHERE], np.int32), np.asarray([0], np.int32))
    return (np.concatenate(mins).astype(np.float32),
            np.concatenate(maxs).astype(np.float32),
            np.concatenate(types), np.concatenate(rows))


class _Node:
    __slots__ = ("mn", "mx", "left", "right", "prims")

    def __init__(self, mn, mx, prims=None):
        self.mn, self.mx = mn, mx
        self.left = self.right = None
        self.prims = prims  # None for internal nodes


def _median_split(idxs, centroids, axis):
    order = np.argsort(centroids[idxs, axis], kind="stable")
    half = len(idxs) // 2
    return idxs[order[:half]], idxs[order[half:]]


def _build_tree(pmin, pmax, ids, leaf_size, mode, rng) -> _Node:
    centroids = (pmin + pmax) * 0.5

    def build(idxs) -> _Node:
        mn = pmin[idxs].min(axis=0)
        mx = pmax[idxs].max(axis=0)
        if len(idxs) <= leaf_size:
            return _Node(mn, mx, prims=idxs)
        if mode == "median_random_axis":
            # The reference engine (bvh.hpp:15-24): random axis, median split.
            left_idx, right_idx = _median_split(idxs, centroids,
                                                int(rng.integers(0, 3)))
        else:
            left_idx, right_idx = _sah_split(pmin[idxs], pmax[idxs],
                                             centroids[idxs], idxs, leaf_size)
            if left_idx is None:   # SAH keeps a leaf, but it is too large
                left_idx, right_idx = _median_split(
                    idxs, centroids, int(np.argmax(mx - mn)))
        node = _Node(mn, mx)
        node.left = build(left_idx)
        node.right = build(right_idx)
        return node

    return build(ids)


def _sah_split(bmin, bmax, cent, idxs, leaf_size):
    """Binned surface-area-heuristic split: (left ids, right ids), or (None,
    None) when no split beats the leaf's cost."""
    n = len(idxs)
    ext = cent.max(axis=0) - cent.min(axis=0)
    axis = int(np.argmax(ext))
    if ext[axis] < 1e-12:
        return None, None

    lo = cent[:, axis].min()
    scale = SAH_BINS * (1.0 - 1e-6) / max(ext[axis], 1e-12)
    bin_of = np.minimum(((cent[:, axis] - lo) * scale).astype(np.int32),
                        SAH_BINS - 1)

    bin_counts = np.bincount(bin_of, minlength=SAH_BINS)
    bin_min = np.full((SAH_BINS, 3), np.inf)
    bin_max = np.full((SAH_BINS, 3), -np.inf)
    for b in range(SAH_BINS):
        sel = bin_of == b
        if sel.any():
            bin_min[b] = bmin[sel].min(axis=0)
            bin_max[b] = bmax[sel].max(axis=0)

    def areas(mns, mxs):
        d = np.maximum(mxs - mns, 0.0)
        return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

    lmin = np.minimum.accumulate(bin_min, axis=0)
    lmax = np.maximum.accumulate(bin_max, axis=0)
    rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
    lcount = np.cumsum(bin_counts)
    rcount = n - lcount

    # Cost of splitting after bin b (b in 0 .. SAH_BINS - 2).
    la = areas(lmin[:-1], lmax[:-1])
    ra = areas(rmin[1:], rmax[1:])
    valid = (lcount[:-1] > 0) & (rcount[:-1] > 0)
    cost = np.where(valid, la * lcount[:-1] + ra * rcount[:-1], np.inf)
    best = int(np.argmin(cost))
    if not np.isfinite(cost[best]):
        return None, None

    whole = areas(bmin.min(axis=0)[None], bmax.max(axis=0)[None])[0]
    if cost[best] >= whole * n and n <= 2 * leaf_size:
        return None, None   # the leaf is cheaper

    go_left = bin_of <= best
    return idxs[go_left], idxs[~go_left]


def _subtree_sizes(root: _Node) -> dict[int, int]:
    """Node count of every subtree (keyed by id(node)), post-order."""
    sizes: dict[int, int] = {}
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if node.prims is not None:
            sizes[id(node)] = 1
        elif expanded:
            sizes[id(node)] = 1 + sizes[id(node.left)] + sizes[id(node.right)]
        else:
            stack += [(node, True), (node.left, False), (node.right, False)]
    return sizes


def _flatten(root: _Node):
    """DFS emission with escape links: a node's left child sits at i + 1
    and escapes into the right child at i + 1 + size(left subtree); the
    right child escapes wherever its parent does."""
    nodes, leaf_prims = [], []
    sizes = _subtree_sizes(root)
    stack = [(root, -1, 0)]
    while stack:
        node, escape, level = stack.pop()
        rec = {"mn": node.mn, "mx": node.mx, "escape": escape,
               "first": -1, "count": 0, "level": level}
        i = len(nodes)
        nodes.append(rec)
        if node.prims is not None:
            rec["first"] = len(leaf_prims)
            rec["count"] = len(node.prims)
            leaf_prims.extend(node.prims.tolist())
        else:
            right_i = i + 1 + sizes[id(node.left)]
            # Right first, so that the left child is emitted next.
            stack.append((node.right, escape, level + 1))
            stack.append((node.left, right_i, level + 1))
    return nodes, np.asarray(leaf_prims, np.int64)


def _depth(root: _Node) -> int:
    stack, best = [(root, 1)], 1
    while stack:
        n, d = stack.pop()
        best = max(best, d)
        if n.left is not None:
            stack += [(n.left, d + 1), (n.right, d + 1)]
    return best


def _python_tree(pmin, pmax, leaf_size, mode, seed):
    """The Python builder: node arrays, leaf order, depth."""
    ids = np.arange(pmin.shape[0])
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + len(ids)))
    try:
        root = _build_tree(pmin, pmax, ids, leaf_size, mode,
                           np.random.default_rng(seed))
    finally:
        sys.setrecursionlimit(old_limit)
    nodes, leaf_order = _flatten(root)
    return dict(
        node_min=np.stack([n["mn"] for n in nodes]).astype(np.float32),
        node_max=np.stack([n["mx"] for n in nodes]).astype(np.float32),
        escape=np.asarray([n["escape"] for n in nodes], np.int32),
        first=np.asarray([n["first"] for n in nodes], np.int32),
        count=np.asarray([n["count"] for n in nodes], np.int32),
        level=np.asarray([n["level"] for n in nodes], np.int32),
        leaf_order=leaf_order, n_levels=_depth(root))


def build_bvh(scene, leaf_size: int = DEFAULT_LEAF_SIZE, mode: str = "sah",
              seed: int = 0, use_native: bool | None = None) -> FlatBVH:
    """Build the scene's BVH on the host; a FlatBVH of CPU tensors.

    mode: "sah" (default) or "median_random_axis" (the reference engine's
    algorithm, bvh.hpp:15-42; seeded by `seed`). The SAH build runs in the
    native library unless use_native is False or the library cannot be
    built (native.available())."""
    from .. import native

    pmin, pmax, ptype, prow = primitive_bounds(scene)
    tree = None
    if mode == "sah" and use_native is not False:
        tree = native.build_bvh(pmin, pmax, leaf_size, SAH_BINS)
    if tree is None:
        tree = _python_tree(pmin, pmax, leaf_size, mode, seed)

    slot_type = ptype[tree["leaf_order"]]
    slot_row = prow[tree["leaf_order"]]
    p = len(slot_type)
    slot_center = np.zeros((p, 3), np.float32)
    slot_radius = np.zeros((p,), np.float32)
    slot_v0 = np.zeros((p, 3), np.float32)
    slot_e1 = np.zeros((p, 3), np.float32)
    slot_e2 = np.zeros((p, 3), np.float32)
    slot_minv = np.zeros((p, 9), np.float32)
    slot_trans = np.full((p, 3), 1e6, np.float32)   # non-box slots never hit
    is_sph = slot_type == PRIM_SPHERE
    is_tri = slot_type == PRIM_TRIANGLE
    is_box = slot_type == PRIM_BOX
    slot_center[is_sph] = _np(scene.spheres.center)[slot_row[is_sph]]
    slot_radius[is_sph] = _np(scene.spheres.radius)[slot_row[is_sph]]
    slot_v0[is_tri] = _np(scene.triangles.v0)[slot_row[is_tri]]
    slot_e1[is_tri] = _np(scene.triangles.e1)[slot_row[is_tri]]
    slot_e2[is_tri] = _np(scene.triangles.e2)[slot_row[is_tri]]
    if is_box.any():
        slot_minv[is_box] = _np(scene.boxes.minv)[slot_row[is_box]]
        slot_trans[is_box] = _np(scene.boxes.trans)[slot_row[is_box]]

    t = torch.as_tensor
    return FlatBVH(
        node_min=t(tree["node_min"]), node_max=t(tree["node_max"]),
        escape=t(tree["escape"]), first=t(tree["first"]),
        count=t(tree["count"]),
        prim_type=t(np.asarray(slot_type, np.int32)),
        prim_row=t(np.asarray(slot_row, np.int32)),
        node_level=t(tree["level"]),
        slot_center=t(slot_center), slot_radius=t(slot_radius),
        slot_v0=t(slot_v0), slot_e1=t(slot_e1), slot_e2=t(slot_e2),
        slot_minv=t(slot_minv), slot_trans=t(slot_trans),
        n_levels=int(tree["n_levels"]),
        leaf_size=max(1, int(tree["count"].max())),
    )


class HitBVH(NamedTuple):
    """A scene's BVH for the fused pool's closest hit, on the scene's device.

    tree      FlatBVH    the plain traversal's tables (ops/traverse.py)
    nodes     f32[NN, 8] the kernel's records: min xyz, escape (int bits),
                         max xyz, leaf word (int bits; 0 inner)
    slots     i32[P]     (row << 2) | type of each leaf slot
    build_ms  float      host milliseconds of the build (0.0 when the scene
                         brought its own tree)
    """

    tree: FlatBVH
    nodes: torch.Tensor
    slots: torch.Tensor
    build_ms: float

    @property
    def node_count(self) -> int:
        return self.tree.node_count

    @property
    def depth(self) -> int:
        return int(self.tree.n_levels)


def kernel_records(tree: FlatBVH) -> tuple[torch.Tensor, torch.Tensor]:
    """(nodes f32[NN, 8], slots i32[P]) of csrc/bvh_hit.cu for `tree`, on
    its device: each node's box widened by NODE_PAD + NODE_PAD_REL x its
    largest coordinate, its escape and leaf word stored as the bits of
    floats. Raises ValueError past the records' limits (LEAF_MAX slots in a
    leaf, SLOT_MAX in the tree)."""
    n_slots = int(tree.prim_type.shape[0])
    if int(tree.count.max()) > LEAF_MAX or n_slots > SLOT_MAX:
        raise ValueError(f"a BVH of {n_slots} slots with leaves of up to "
                         f"{int(tree.count.max())}: the kernel's records hold "
                         f"{SLOT_MAX} slots, {LEAF_MAX} a leaf")
    lo, hi = tree.node_min.float(), tree.node_max.float()
    pad = NODE_PAD + NODE_PAD_REL * torch.maximum(lo.abs(), hi.abs())
    word = torch.where(tree.count > 0,
                       tree.first * (1 << LEAF_SHIFT) + tree.count, 0)
    bits = lambda x: x.to(torch.int32).contiguous().view(torch.float32)
    nodes = torch.cat([lo - pad, bits(tree.escape)[:, None], hi + pad,
                       bits(word)[:, None]], dim=1).contiguous()
    slots = (tree.prim_row.to(torch.int32) * 4
             + tree.prim_type.to(torch.int32)).contiguous()
    return nodes, slots


def hit_bvh(scene) -> HitBVH:
    """The scene's BVH for the closest hit, on the scene's device: the
    scene's own tree when it has one, else a new build (`build_bvh`,
    inside the span `bvh.build`), with its kernel records. Build once per
    scene (fused_step.build_tables, under the pool's DerivedCache);
    `hit_bvh.builds` counts the trees built."""
    dev = scene.spheres.center.device
    tree, build_ms = scene.bvh, 0.0
    if tree is None:
        with spans.span("bvh.build"):
            t0 = time.perf_counter()
            tree = build_bvh(scene).to(dev)
            build_ms = 1e3 * (time.perf_counter() - t0)
        kernels.count(hit_bvh, "builds")
    nodes, slots = kernel_records(tree)
    return HitBVH(tree=tree, nodes=nodes, slots=slots, build_ms=build_ms)


hit_bvh.builds = 0
