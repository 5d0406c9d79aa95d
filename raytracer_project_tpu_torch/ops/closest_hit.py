"""The closest-hit kernels:
  * K1 `closest_hit`, the port of ops/pallas_intersect.py's
    `_closest_hit_kernel_od` + `scan_tables` + `feats_rows_from_od` (the
    Pallas call at pallas_intersect.py:316), on the fused pool;
  * K4 `closest_hit_feats`, the port of `_closest_hit_kernel` (the Pallas
    call at pallas_intersect.py:391), behind intersect.intersect on the
    chunked integrator: the same scan over features prebuilt by the caller
    as f32[16, N] rows (intersect.ray_feature_rows);
  * `bvh_closest_hit`, which `closest_hit` takes for tables that carry a
    BVH (the fused pool's, from intersect.BVH_MIN_PRIMS primitives on):
    the threaded tree walked per ray (csrc/bvh_hit.cu; plain version
    ops/traverse.py intersect_flat), each leaf slot tested with K1's dots
    and epilogues on K1's compact rows, so it returns K1's answer.

For every ray (o, d) the 16 ray features [d, o, o x d, o.d, |o|^2, 1,
|d|^2, 0, 0, 0] are formed, and the sphere, triangle and box coefficient
tables ([16, G, C_pad], ops/intersect.py) are scanned in index order: a
feature x coefficient dot per primitive output, then the quadratic,
Moller-Trumbore or slab epilogue. Strict `<` against the running best
keeps the first minimal index and the earlier table on ties; rows past
each table's count are never scanned. Returns (t, prim_idx, prim_type),
t = T_MAX on a miss.

The tables' structural nonzeros. build_mm_tables fills fixed feature slots
per output (`SLOTS`): 9 of a sphere's 32 coefficients, 19 of a
triangle's 64, 21 of a box's 96. `scan_tables` gathers them once per scene
into prim-major compact rows (`ROW_WIDTHS` floats, padded to 16 bytes) and
raises if any other coefficient of a scanned column is not exactly 0. In
an fmaf chain that starts at +0, a term with a zero coefficient returns
the sum unchanged for every finite feature (acc + (+-0) is acc for a
nonzero acc, +0 + (+-0) is +0 under round-to-nearest, and the chain never
reaches -0), so the chain over the listed slots in ascending order gives
the dense 16-term chain's result bit for bit.

Three implementations of each kernel:
  * `closest_hit_plain` / `closest_hit_feats_plain` (CPU tensors, and the
    on-card reference): repeat the reference's SPLITK arithmetic -- bf16
    digit split, digits upcast to f32, the hh pass and the five-pair pass
    summed as d1 + d2 -- so the CPU path reproduces the arithmetic behind
    the reference's CPU goldens. K4's plain version is K1's without the
    feature step; 512-wide chunks with the first minimal index of a chunk
    give the hits of the reference's 128-wide argmin scan
    (intersect_brute_mm), ties included.
  * csrc/closest_hit.cu's entries closest_hit_od (K1) and closest_hit_feats
    (K4, which loads features 0-12 of a lane from the [16, N] rows): what
    `closest_hit` / `closest_hit_feats` launch on CUDA tensors. Each
    thread holds one ray; each block stages SCAN_TILE-row tiles of the
    compact rows in shared memory (a two-stage ring of asynchronous
    copies), skips a tile that none of its rays reaches, and each warp
    skips a staged tile that none of its rays reaches before its best t.
    The dots are fmaf chains over the structural slots: equal, bit for
    bit, to the dense entries' on every lane with finite features.
  * csrc/closest_hit.cu's closest_hit_od_dense / closest_hit_feats_dense
    (`closest_hit_dense`, `closest_hit_feats_dense`): the 16-term scan of
    the first port, one ray per thread, kept as the yardstick the new
    entries are held to and timed against; no render path calls them.

Non-finite features. On a lane whose features 0-12 are not all finite
(an infinite or NaN origin or direction), the dense chain multiplies the
bad feature by every zero coefficient too and turns NaN, so the dense
scan and the reference's kernel miss every primitive; the compact chain
skips those products, so K1 and K4 may report a hit there, on a
primitive whose listed slots keep its dots finite. Such a lane's answer is
not specified. chip_smoke.py counts such lanes on the card, on its K1 and
K4 ray sets and in its chunked smoke renders (PERF.md has the counts), and
`integrator.trace` masks every hit of a retired lane with its `active`
mask, so whatever a retired lane gets reaches no buffer
(tests/test_torch_compact.py).

Bound on the H100 (SXM, 700 W): f32 operations at 67 TFLOP/s, against
36 B per ray of traffic (K4: 76 B, the 16 features in). What the rays
need: for each MM_FINE = 128-primitive tile (the tables' finest AABBs)
that a ray reaches before its closest hit, 2 per nonzero coefficient of
the tile's real primitives (one FMA each; the showcase tables hold 4,085
sphere, 10,234 triangle and 5,806 box nonzeros, so about 40k FLOP per ray
unculled) and one epilogue per primitive (15, 12 and 35 operations).
chip_smoke.py `k1_operations` counts it on the run's rays.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import T_MAX
from ..models.geometry import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE
from .. import kernels
from . import intersect

CHUNK_PRIMS = 512
# Feature slots k of each output's structural nonzeros, ascending, per
# primitive type (ops/intersect.py build_mm_tables); csrc/
# closest_hit_sparse.cuh holds the same lists.
SLOTS = (
    ((0, 1, 2, 9), (3, 4, 5, 10, 11)),                   # sphere h, c
    ((0, 1, 2), (0, 1, 2, 6, 7, 8), (0, 1, 2, 6, 7, 8),  # det, u_num, v_num,
     (3, 4, 5, 11)),                                     # t_num
    ((0, 1, 2),) * 3 + ((3, 4, 5, 11),) * 3,             # box dl xyz, ol xyz
)
# Floats per compact row: the slots of all outputs, padded to 16 bytes.
ROW_WIDTHS = (12, 20, 24)
# The compact-row scan's tile: rows staged at a time, and the width of the
# tile AABBs it culls with (the tables' own fine AABBs). csrc/
# closest_hit_sparse.cuh's SCAN_TILE is the same number.
SCAN_TILE = 128


class ScanTables(NamedTuple):
    """One scene's closest-hit tables, built once per scene (`scan_tables`)."""

    coeffs: tuple   # (sphere, tri, box) f32[16, G, C_pad]: the plain versions'
    rows: tuple     # (sphere, tri, box) f32[count, ROW_WIDTHS]: the kernels'
    bounds: tuple   # (sphere, tri, box) f32[C_pad / SCAN_TILE, 6] tile AABBs
    counts: tuple   # (n_spheres, n_tris, n_boxes) ints
    bvh: object = None  # ops/bvh.py HitBVH: the fused pool attaches it past
                        # intersect.BVH_MIN_PRIMS (`closest_hit` then walks it)


def coarsen_bounds(fine: torch.Tensor, width: int = CHUNK_PRIMS) -> torch.Tensor:
    """Union MM_FINE-wide chunk AABBs [Cf, 6] into `width`-wide ones."""
    g = width // intersect.MM_FINE
    r = fine.reshape(-1, g, 6)
    return torch.cat([r[:, :, :3].amin(1), r[:, :, 3:].amax(1)], dim=1)


def compact_rows(coeff: torch.Tensor, count: int, slots, width: int):
    """The structural nonzeros of the first `count` columns of a [16, G,
    C_pad] table as prim-major rows f32[count, width]: output by output,
    each output's slots in ascending k, zeros after. Raises ValueError if
    any coefficient outside `slots` in those columns is not exactly 0."""
    cols = coeff[:, :, :count]
    listed = torch.zeros(cols.shape[:2], dtype=torch.bool)
    for g, ks in enumerate(slots):
        listed[list(ks), g] = True
    listed = listed.to(cols.device)
    stray = (cols[~listed] != 0).any(dim=1)
    if bool(stray.any()):
        k, g = torch.nonzero(~listed)[torch.nonzero(stray)[0, 0]].tolist()
        raise ValueError(f"coefficient table [16, {cols.shape[1]}, :]: slot "
                         f"k={k} of output {g} is not a structural zero")
    rows = torch.cat([cols[list(ks), g] for g, ks in enumerate(slots)]).T
    return torch.nn.functional.pad(rows, (0, width - rows.shape[1])).contiguous()


def scan_tables(scene) -> ScanTables:
    """The closest-hit tables of a scene with coefficient tables (scene.mm):
    the dense tables, their compact rows and the SCAN_TILE-wide tile AABBs,
    on the scene's device. Build once per scene, not per launch."""
    mm = scene.mm
    coeffs = (mm.sphere_coeff, mm.tri_coeff, mm.box_coeff)
    counts = (scene.spheres.count, scene.triangles.count,
              scene.boxes.count if scene.boxes is not None else 0)
    rows = tuple(compact_rows(c, n, s, w)
                 for c, n, s, w in zip(coeffs, counts, SLOTS, ROW_WIDTHS))
    bounds = tuple(coarsen_bounds(b, SCAN_TILE).contiguous()
                   for b in (mm.sphere_bounds, mm.tri_bounds, mm.box_bounds))
    return ScanTables(coeffs=coeffs, rows=rows, bounds=bounds, counts=counts)


def closest_hit_plain(od, tmin: float, coeffs, counts):
    """Plain PyTorch K1. od f32[6, P]; coeffs = (sphere, tri, box) f32
    [16, G, C_pad]; counts = (n_spheres, n_tris, n_boxes)."""
    feats = intersect.ray_features((od[0], od[1], od[2]), (od[3], od[4], od[5]))
    return closest_hit_feats_plain(feats.T, tmin, coeffs, counts)


def closest_hit_feats_plain(feats, tmin: float, coeffs, counts):
    """Plain PyTorch K4: the closest hit of prebuilt features f32[16, N]."""
    feats = feats.T
    dev = feats.device
    p = feats.shape[0]
    a = feats[:, 12:13]
    featsk = intersect.splitk_feats(feats)
    tmin_c = torch.full((p, 1), tmin, dtype=torch.float32, device=dev)
    best_t = torch.full((p,), T_MAX, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((p,), dtype=torch.int32, device=dev)
    best_type = torch.zeros((p,), dtype=torch.int32, device=dev)
    epilogues = (
        lambda h, c, lo, hi: intersect.sphere_candidate_t_mm(h, c, a, lo, hi),
        intersect.triangle_candidate_t_mm,
        intersect.box_candidate_t_mm,
    )
    for coeff, n_rows, epi, ptype in zip(coeffs, counts, epilogues,
                                         (PRIM_SPHERE, PRIM_TRIANGLE, PRIM_BOX)):
        g = coeff.shape[1]
        # Columns past the table's count are not scanned (the reference
        # scans and masks them: the same result).
        for c0 in range(0, n_rows, CHUNK_PRIMS):
            w = min(CHUNK_PRIMS, n_rows - c0)
            block = coeff[:, :, c0:c0 + w].reshape(16, g * w)
            out = intersect.splitk_dot(featsk, intersect.splitk_pack_coeff(block))
            t = epi(*(out[:, i * w:(i + 1) * w] for i in range(g)),
                    tmin_c, best_t[:, None])
            cmin = t.amin(dim=1)
            iota = torch.arange(w, device=dev)
            carg = torch.where(t == cmin[:, None], iota[None, :], w).amin(dim=1)
            better = cmin < best_t
            best_t = torch.where(better, cmin, best_t)
            best_idx = torch.where(better, (c0 + carg).to(torch.int32), best_idx)
            best_type = torch.where(better, ptype, best_type).to(torch.int32)
    return best_t, best_idx, best_type


def _outputs(rays, n):
    return (torch.empty((n,), dtype=torch.float32, device=rays.device),
            torch.empty((n,), dtype=torch.int32, device=rays.device),
            torch.empty((n,), dtype=torch.int32, device=rays.device))


def _check_rows(rays, tables: ScanTables) -> None:
    """Raise unless the rays are detached and each table's compact rows are
    [count, ROW_WIDTHS] on a 16-byte boundary, as the kernels read them."""
    if rays.requires_grad:
        # The ctypes launch records nothing for autograd.
        raise ValueError("the closest-hit kernels take detached rays "
                         "(intersect.intersect_detached)")
    for rows, n_rows, w in zip(tables.rows, tables.counts, ROW_WIDTHS):
        if rows.shape != (n_rows, w) or rows.data_ptr() % 16:
            raise ValueError(f"compact rows {tuple(rows.shape)}, expected "
                             f"({n_rows}, {w}) on a 16-byte boundary")


def scan_args(rays, n, tmin, tables: ScanTables) -> list:
    """The compact-row scan's C arguments (rays, n, tmin, then each table's
    rows, tile bounds and count), after checking what the kernel assumes;
    csrc/closest_hit.cu's entries and P1's take them."""
    kernels.require_cuda(rays, *tables.rows, *tables.bounds,
                         dtype=torch.float32)
    _check_rows(rays, tables)
    for n_rows, bnd in zip(tables.counts, tables.bounds):
        if bnd.shape[0] * SCAN_TILE < n_rows:
            raise ValueError(f"{bnd.shape[0]} tile bounds of width "
                             f"{SCAN_TILE} for {n_rows} rows")
    args = [rays, n, tmin]
    for rows, bnd, c in zip(tables.rows, tables.bounds, tables.counts):
        args += [rows, bnd, c]
    return args


def _launch(entry, rays, n, tmin, tables: ScanTables):
    """One launch of the compact-row scan `entry`."""
    args = scan_args(rays, n, tmin, tables)
    out = _outputs(rays, n)
    kernels.launch(entry, *args, *out)
    return out


def closest_hit(od, tmin: float, tables: ScanTables):
    """Closest hit of the rays od f32[6, P] against a scene's ScanTables.

    Tables that carry a BVH (`tables.bvh`) take `bvh_closest_hit`; the
    others K1's tile scan: on CPU tensors `closest_hit_plain`, on CUDA
    tensors csrc/closest_hit.cu's closest_hit_od on the compact rows (the
    tile bounds are used for culling only). Returns (t f32[P], idx i32[P],
    type i32[P]). `launches` counts the launches of both kernels on the
    card, `bvh_launches` those of the BVH kernel; on CPU tensors nothing
    launches and nothing is counted."""
    if tables.bvh is not None:
        return bvh_closest_hit(od, tmin, tables)
    if od.device.type == "cpu":
        return closest_hit_plain(od, tmin, tables.coeffs, tables.counts)
    out = _launch("closest_hit_od", od, od.shape[1], tmin, tables)
    kernels.count(closest_hit)
    return out


closest_hit.launches = 0
closest_hit.bvh_launches = 0


def bvh_closest_hit_plain(od, tmin: float, bvh):
    """Plain PyTorch BVH closest hit: the threaded traversal of
    ops/traverse.py over bvh.tree (ops/bvh.py HitBVH), its leaves tested by
    the brute-force oracle's arithmetic. Returns K1's (t, idx, type)."""
    from . import traverse

    hit = traverse.intersect_flat(bvh.tree, od[:3].T, od[3:6].T, tmin)
    return hit.t, hit.prim_idx, hit.prim_type


def bvh_closest_hit(od, tmin: float, tables: ScanTables):
    """The closest hit of the rays od f32[6, P] over the tree tables.bvh.

    On CPU tensors this is `bvh_closest_hit_plain`; on CUDA tensors it
    launches csrc/bvh_hit.cu's bvh_closest_hit, which tests each leaf slot
    with K1's dots and epilogues on the compact rows, so that a primitive
    it shares with K1's answer has K1's t bit for bit, and breaks ties on t
    as K1 does; each launch counts on `closest_hit.launches` and
    `closest_hit.bvh_launches`. Returns (t f32[P], idx i32[P], type
    i32[P])."""
    bvh = tables.bvh
    if od.device.type == "cpu":
        return bvh_closest_hit_plain(od, tmin, bvh)
    kernels.require_cuda(od, bvh.nodes, *tables.rows, dtype=torch.float32)
    kernels.require_cuda(od, bvh.slots)
    if bvh.slots.dtype != torch.int32:
        raise ValueError(f"leaf slots of {bvh.slots.dtype}, expected int32")
    _check_rows(od, tables)
    if (bvh.nodes.shape != (bvh.node_count, 8) or bvh.nodes.data_ptr() % 16
            or od.shape[0] != 6):
        raise ValueError(f"node records {tuple(bvh.nodes.shape)} and rays "
                         f"{tuple(od.shape)}: expected ({bvh.node_count}, 8) "
                         f"on a 16-byte boundary and [6, P]")
    n = od.shape[1]
    out = _outputs(od, n)
    kernels.launch("bvh_closest_hit", od, n, tmin, bvh.nodes, bvh.slots,
                   *tables.rows, *out)
    kernels.count(closest_hit)
    kernels.count(closest_hit, "bvh_launches")
    return out


def closest_hit_feats(feats, tmin: float, tables: ScanTables):
    """K4: the closest hit of rays given by their prebuilt features
    f32[16, N] (intersect.ray_feature_rows), against the same tables as
    `closest_hit`. On CPU tensors this is `closest_hit_feats_plain`; on
    CUDA tensors it launches csrc/closest_hit.cu's closest_hit_feats.
    Returns (t f32[N], idx i32[N], type i32[N])."""
    if feats.device.type == "cpu":
        return closest_hit_feats_plain(feats, tmin, tables.coeffs,
                                       tables.counts)
    out = _launch("closest_hit_feats", feats, feats.shape[1], tmin, tables)
    kernels.count(closest_hit_feats)
    return out


closest_hit_feats.launches = 0


def _launch_dense(entry, rays, n, tmin, coeffs, bounds, counts):
    kernels.require_cuda(rays, *coeffs, *bounds, dtype=torch.float32)
    out = _outputs(rays, n)
    args = [rays, n, tmin]
    for coeff, bnd, c in zip(coeffs, bounds, counts):
        args += [coeff, coeff.shape[2], bnd, c]
    kernels.launch(entry, *args, *out)
    return out


def closest_hit_dense(od, tmin: float, coeffs, bounds, counts):
    """The dense 16-term scan of K1 (CUDA tensors only): coeffs [16, G,
    C_pad], bounds the CHUNK_PRIMS-wide chunk AABBs. The yardstick that
    `closest_hit` is held to; no render path calls it."""
    return _launch_dense("closest_hit_od_dense", od, od.shape[1], tmin,
                         coeffs, bounds, counts)


def closest_hit_feats_dense(feats, tmin: float, coeffs, bounds, counts):
    """The dense 16-term scan of K4 (CUDA tensors only), as
    `closest_hit_dense`."""
    return _launch_dense("closest_hit_feats_dense", feats, feats.shape[1],
                         tmin, coeffs, bounds, counts)
