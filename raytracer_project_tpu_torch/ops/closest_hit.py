"""The closest-hit kernels:
  * K1 `closest_hit`, the port of ops/pallas_intersect.py's
    `_closest_hit_kernel_od` + `scan_tables` + `feats_rows_from_od` (the
    Pallas call at pallas_intersect.py:316), on the fused pool;
  * K4 `closest_hit_feats`, the port of `_closest_hit_kernel` (the Pallas
    call at pallas_intersect.py:391), behind intersect.intersect on the
    chunked integrator: the same scan over features prebuilt by the caller
    as f32[16, N] rows (intersect.ray_feature_rows).

For every ray (o, d) the 16 ray features [d, o, o x d, o.d, |o|^2, 1,
|d|^2, 0, 0, 0] are formed, and the sphere, triangle and box coefficient
tables ([16, G, C_pad], ops/intersect.py) are scanned in index order in
512-primitive chunks: a feature x coefficient dot per primitive output,
then the quadratic, Moller-Trumbore or slab epilogue. Strict `<` against
the running best keeps the first minimal index of a chunk and the earlier
chunk or table on ties; rows past each table's count are never scanned.
Returns (t, prim_idx, prim_type), t = T_MAX on a miss.

Two implementations of each:
  * `closest_hit_plain` / `closest_hit_feats_plain` (CPU tensors, and the
    on-card reference): repeat the reference's SPLITK arithmetic -- bf16
    digit split, digits upcast to f32, the hh pass and the five-pair pass
    summed as d1 + d2 -- so the CPU path reproduces the arithmetic behind
    the reference's CPU goldens. K4's plain version is K1's without the
    feature step; 512-wide chunks with the first minimal index of a chunk
    give the hits of the reference's 128-wide argmin scan
    (intersect_brute_mm), ties included.
  * csrc/closest_hit.cu (CUDA tensors), entries closest_hit_od (K1) and
    closest_hit_feats (K4, which loads the 16 features of a lane from the
    [16, N] rows, consecutive threads on consecutive lanes): one thread per
    ray, features in registers, f32 FMAs for the 16-term dots (no
    TF32/bf16 tensor cores: low precision corrupts the hit set). Each warp
    culls a chunk whose AABB none of its rays can reach before its current
    best t, so culling never changes a result.

Bound on the H100 (SXM, 700 W): f32 operations at 67 TFLOP/s, against
36 B per ray of traffic (K4: 76 B, the 16 features in). What the rays
need: for each 512-primitive chunk whose AABB a ray reaches before its
closest hit, 2 per nonzero coefficient of the chunk's real primitives (one
FMA each; the showcase tables hold 4,085 sphere, 10,234 triangle and 5,806
box nonzeros, so about 40k FLOP per ray unculled) and one epilogue per
primitive (15, 12 and 35 operations). chip_smoke.py `k1_operations` counts
it on the run's rays.
"""

from __future__ import annotations

import torch

from ..core.constants import T_MAX
from ..models.geometry import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE
from .. import kernels
from . import intersect

CHUNK_PRIMS = 512


def coarsen_bounds(fine: torch.Tensor) -> torch.Tensor:
    """Union MM_FINE-wide chunk AABBs [Cf, 6] into CHUNK_PRIMS-wide ones."""
    g = CHUNK_PRIMS // intersect.MM_FINE
    r = fine.reshape(-1, g, 6)
    return torch.cat([r[:, :, :3].amin(1), r[:, :, 3:].amax(1)], dim=1)


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


def _launch(entry, rays, n, tmin, coeffs, bounds, counts):
    kernels.require_cuda(rays, *coeffs, *bounds, dtype=torch.float32)
    t = torch.empty((n,), dtype=torch.float32, device=rays.device)
    idx = torch.empty((n,), dtype=torch.int32, device=rays.device)
    typ = torch.empty((n,), dtype=torch.int32, device=rays.device)
    args = [rays, n, tmin]
    for coeff, bnd, c in zip(coeffs, bounds, counts):
        args += [coeff, coeff.shape[2], bnd, c]
    kernels.launch(entry, *args, t, idx, typ)
    return t, idx, typ


def closest_hit(od, tmin: float, coeffs, bounds, counts):
    """Closest hit of the rays od f32[6, P] against the coefficient tables.

    On CPU tensors this is `closest_hit_plain`; on CUDA tensors it launches
    csrc/closest_hit.cu (bounds: the CHUNK_PRIMS-wide chunk AABBs, used for
    culling only). Returns (t f32[P], idx i32[P], type i32[P])."""
    if od.device.type == "cpu":
        return closest_hit_plain(od, tmin, coeffs, counts)
    out = _launch("closest_hit_od", od, od.shape[1], tmin, coeffs, bounds,
                  counts)
    closest_hit.launches += 1
    return out


closest_hit.launches = 0


def closest_hit_feats(feats, tmin: float, coeffs, bounds, counts):
    """K4: the closest hit of rays given by their prebuilt features
    f32[16, N] (intersect.ray_feature_rows), against the same tables as
    `closest_hit`. On CPU tensors this is `closest_hit_feats_plain`; on
    CUDA tensors it launches csrc/closest_hit.cu's closest_hit_feats.
    Returns (t f32[N], idx i32[N], type i32[N])."""
    if feats.device.type == "cpu":
        return closest_hit_feats_plain(feats, tmin, coeffs, counts)
    out = _launch("closest_hit_feats", feats, feats.shape[1], tmin, coeffs,
                  bounds, counts)
    closest_hit_feats.launches += 1
    return out


closest_hit_feats.launches = 0
