"""Ray-primitive intersection (twin of raytracer_project_tpu/ops/intersect.py,
subset the fused pool and the chunked integrator reach).

  * `build_mm_tables`: per-primitive coefficient columns [16, G, C_pad]
    (feature, output, primitive) for the bilinear formulation of the
    sphere quadratic, Moller-Trumbore and the affine box slab, plus one
    AABB per 128-wide chunk. Host numpy, f64 where f32 cancels.
  * `split3_bf16` / `splitk_*`: the reference's exact bf16 digit split and
    its two-pass product. Only the plain version of the closest-hit kernel
    (ops/closest_hit.py) uses them, so that the CPU path repeats the
    arithmetic that produced the reference's CPU goldens.
  * the three `*_mm` epilogues, shared by that plain version;
  * `intersect_brute`: the exact oracle (hittable_list.hpp:28-41);
  * `_packed_all` and the `_*_record_soa` decoders: the plain version of
    the hit-record decode kernel (ops/fused_step.py);
  * the chunked integrator's side: `ray_feature_rows`, `intersect_dispatch`
    and `intersect` (K4 of ops/closest_hit.py, or the BVH traversal of
    ops/traverse.py off the card), and `make_record` with its AoS decoders
    `_*_record_from` ([N, 3] vectors, exact arcs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import soa, vecmath
from ..core.constants import PI, T_MAX
from ..core.tree import to_device, tree_map
from ..models.geometry import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE

RAY_FEATURE_DIM = 16
# Coefficient-table padding (the closest-hit chunk width) and the
# granularity at which chunk AABBs are stored.
MM_PAD = 512
MM_FINE = 128
# Primitive chunk width of the brute-force oracle scan.
CHUNK = 128


class Hit(NamedTuple):
    """Closest-hit result for a ray batch (all [N])."""

    t: torch.Tensor          # f32 hit distance (T_MAX when miss)
    prim_type: torch.Tensor  # i32 PRIM_SPHERE / PRIM_TRIANGLE / PRIM_BOX
    prim_idx: torch.Tensor   # i32 row in the per-type table
    hit: torch.Tensor        # bool


class HitRecord(NamedTuple):
    """Shading record of the closest hits (hittable.hpp:9-26); vectors are
    f32[N, 3]."""

    t: torch.Tensor           # f32[N]
    p: torch.Tensor
    normal: torch.Tensor      # front-face corrected
    tangent: torch.Tensor
    bitangent: torch.Tensor
    front_face: torch.Tensor  # bool[N]
    u: torch.Tensor           # f32[N]
    v: torch.Tensor           # f32[N]
    mat: torch.Tensor         # i64[N]
    hit: torch.Tensor         # bool[N]


class MMTables(NamedTuple):
    """Coefficient matrices and per-chunk bounds (reference MMTables).

    Padding columns are all-zero (sphere, triangle: always invalid) or a
    far-away local origin (box: empty slab); padding chunks carry inverted
    infinite AABBs."""

    sphere_coeff: torch.Tensor   # f32[16, 2, Cs_pad]  (h, c)
    tri_coeff: torch.Tensor      # f32[16, 4, Ct_pad]  (det, u_num, v_num, t_num)
    box_coeff: torch.Tensor      # f32[16, 6, Cb_pad]  (dl xyz, ol xyz)
    sphere_bounds: torch.Tensor  # f32[Cs_pad/MM_FINE, 6]
    tri_bounds: torch.Tensor
    box_bounds: torch.Tensor

    def to(self, device):
        return to_device(self, device)


def _chunk_bounds(pmin, pmax, n_chunks, width=MM_FINE):
    """Per-chunk AABB union of primitive AABBs (host numpy)."""
    out = np.empty((n_chunks, 6), np.float32)
    out[:, 0:3] = np.inf
    out[:, 3:6] = -np.inf
    c = pmin.shape[0]
    for k in range(min(n_chunks, -(-c // width))):
        lo, hi = k * width, min((k + 1) * width, c)
        sel = pmin[lo:hi, 0] <= pmax[lo:hi, 0]
        if sel.any():
            out[k, 0:3] = pmin[lo:hi][sel].min(0)
            out[k, 3:6] = pmax[lo:hi][sel].max(0)
    return out


def tri_coeff_block(v0, e1, e2):
    """Moller-Trumbore coefficient columns for a triangle block f32[16,4,k]."""
    F = RAY_FEATURE_DIM
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    k = v0.shape[0]
    tc = np.zeros((F, 4, k), np.float32)
    n_geo = np.cross(e1, e2)
    tc[0:3, 0, :] = -n_geo.T                   # det = -d.n_geo
    tc[6:9, 1, :] = e2.T                       # u_num = (o x d).e2 - d.(e2 x v0)
    tc[0:3, 1, :] = -np.cross(e2, v0).T
    tc[6:9, 2, :] = -e1.T                      # v_num = -(o x d).e1 - d.(v0 x e1)
    tc[0:3, 2, :] = -np.cross(v0, e1).T
    tc[3:6, 3, :] = n_geo.T                    # t_num = o.n_geo - v0.n_geo
    tc[11, 3, :] = -(v0 * n_geo).sum(-1)
    return tc


def build_mm_tables(spheres, triangles, boxes=None) -> MMTables:
    """Assemble the coefficient matrices (host numpy; numpy leaves)."""
    F = RAY_FEATURE_DIM
    cs = int(np.asarray(spheres.radius).shape[0])
    ct = int(np.asarray(triangles.v0).shape[0])
    cb = int(np.asarray(boxes.mat).shape[0]) if boxes is not None else 0
    cs_pad = max(-(-cs // MM_PAD) * MM_PAD, MM_PAD)
    ct_pad = max(-(-ct // MM_PAD) * MM_PAD, MM_PAD)
    cb_pad = max(-(-cb // MM_PAD) * MM_PAD, MM_PAD)

    sc = np.zeros((F, 2, cs_pad), np.float32)
    if cs:
        # f64: |C|^2 - r^2 cancels catastrophically in f32 for the r=1000
        # ground sphere (scene_management.hpp:107).
        C = np.asarray(spheres.center, np.float64)
        r = np.asarray(spheres.radius, np.float64)
        sc[0:3, 0, :cs] = C.T                  # h = C.d - (o.d)
        sc[9, 0, :cs] = -1.0
        sc[3:6, 1, :cs] = -2.0 * C.T           # c = -2 o.C + |o|^2 + (|C|^2 - r^2)
        sc[10, 1, :cs] = 1.0
        # r <= 0 rows never hit: an overwhelming constant makes disc < 0.
        sc[11, 1, :cs] = np.where(r > 0.0, (C * C).sum(-1) - r * r, 1e30)

    tc = np.zeros((F, 4, ct_pad), np.float32)
    if ct:
        tc[:, :, :ct] = tri_coeff_block(triangles.v0, triangles.e1,
                                        triangles.e2)

    # Box: local direction Minv d and local origin Minv o + trans are
    # linear in the features. Padding columns decode as guaranteed misses.
    bc = np.zeros((F, 6, cb_pad), np.float32)
    bc[11, 3:6, :] = 1e6
    if cb:
        minv = np.asarray(boxes.minv, np.float64)
        trans = np.asarray(boxes.trans, np.float64)
        for i in range(3):
            bc[0:3, i, :cb] = minv[:, 3 * i:3 * i + 3].T
            bc[3:6, 3 + i, :cb] = minv[:, 3 * i:3 * i + 3].T
            bc[11, 3 + i, :cb] = trans[:, i]

    if cs:
        C32 = np.asarray(spheres.center, np.float32)
        r32 = np.asarray(spheres.radius, np.float32)
        live = (r32 > 0.0)[:, None]
        smin = np.where(live, C32 - r32[:, None], np.inf)
        smax = np.where(live, C32 + r32[:, None], -np.inf)
    else:
        smin = np.zeros((0, 3), np.float32) + np.inf
        smax = np.zeros((0, 3), np.float32) - np.inf
    if ct:
        v0f = np.asarray(triangles.v0, np.float32)
        v1f = v0f + np.asarray(triangles.e1, np.float32)
        v2f = v0f + np.asarray(triangles.e2, np.float32)
        tmin_ = np.minimum(np.minimum(v0f, v1f), v2f)
        tmax_ = np.maximum(np.maximum(v0f, v1f), v2f)
    else:
        tmin_ = np.zeros((0, 3), np.float32) + np.inf
        tmax_ = np.zeros((0, 3), np.float32) - np.inf
    if cb:
        bmin = np.asarray(boxes.aabb_min, np.float32)
        bmax = np.asarray(boxes.aabb_max, np.float32)
    else:
        bmin = np.zeros((0, 3), np.float32) + np.inf
        bmax = np.zeros((0, 3), np.float32) - np.inf

    return MMTables(
        sphere_coeff=sc, tri_coeff=tc, box_coeff=bc,
        sphere_bounds=_chunk_bounds(smin, smax, cs_pad // MM_FINE),
        tri_bounds=_chunk_bounds(tmin_, tmax_, ct_pad // MM_FINE),
        box_bounds=_chunk_bounds(bmin, bmax, cb_pad // MM_FINE),
    )


def ray_features(o, d):
    """[N, 16] features [d, o, o x d, o.d, |o|^2, 1, |d|^2, 0, 0, 0] from
    component tuples (column 12 is read by the epilogues only). Products
    and sums fuse as the reference's compiler fuses them:
    o1*d2 - o2*d1 -> fma(o1, d2, -(o2*d1)) and
    a0*b0 + a1*b1 + a2*b2 -> fma(a2, b2, fma(a0, b0, a1*b1))."""
    m = tuple(vecmath.fma(o[i], d[j], -(o[j] * d[i]))
              for i, j in ((1, 2), (2, 0), (0, 1)))
    od, oo, dd = (vecmath.fma(a[2], b[2], vecmath.fma(a[0], b[0], a[1] * b[1]))
                  for a, b in ((o, d), (o, o), (d, d)))
    one = torch.ones_like(od)
    zero = torch.zeros_like(od)
    return torch.stack([d[0], d[1], d[2], o[0], o[1], o[2], m[0], m[1], m[2],
                        od, oo, one, dd, zero, zero, zero], dim=1)


# --- the reference's split-K bf16 product ("SPLITK") ------------------------
# f32 x == hi + mid + lo exactly for three round-to-nearest-even bf16
# digits. The six significant digit products fh*ch + fh*cm + fh*cl + fm*ch
# + fm*cm + fl*ch are summed in two passes: the dominant hh pair alone,
# then the five small pairs, then d1 + d2. Digits are upcast to f32 before
# each product: a torch bf16 matmul would round its result to bf16.

def split3_bf16(x):
    """Exact 3-way bf16 digit split: x == hi + mid + lo for f32 x."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    r2 = r1 - mid.to(torch.float32)
    return hi, mid, r2.to(torch.bfloat16)


def splitk_pack_coeff(coeff):
    """[16, ...] f32 -> [96, ...] bf16 rows [hi mid lo hi mid hi]."""
    hi, mid, lo = split3_bf16(coeff)
    return torch.cat([hi, mid, lo, hi, mid, hi], dim=0)


def splitk_feats(feats):
    """[B, 16] f32 -> [B, 96] bf16 columns [fh fh fh fm fm fl]."""
    hi, mid, lo = split3_bf16(feats)
    return torch.cat([hi, hi, hi, mid, mid, lo], dim=1)


def _dot_k_order(a, b):
    """a @ b for exact products, summed in the order of the reference's CPU
    dot: blocks of 32 along K, even and odd k accumulated apart within a
    block (each a sequential sgemm here), blocks added in turn. This makes
    the CPU result bit-equal to the reference's; on the card the order is
    cuBLAS's."""
    out = None
    for k0 in range(0, a.shape[1], 32):
        ab, bb = a[:, k0:k0 + 32], b[k0:k0 + 32]
        s = ab[:, 0::2] @ bb[0::2] + ab[:, 1::2] @ bb[1::2]
        out = s if out is None else out + s
    return out


def splitk_dot(featsk, coeffk):
    """Two-pass product of SPLITK operands: [B, 96] x [96, N] -> [B, N] f32."""
    f = RAY_FEATURE_DIM
    fk = featsk.to(torch.float32)
    ck = coeffk.to(torch.float32)
    d1 = _dot_k_order(fk[:, :f], ck[:f, :])
    d2 = _dot_k_order(fk[:, f:], ck[f:, :])
    return d1 + d2


# --- epilogues on the products, all [N, C] (tmin, tmax: [N, 1]) --------------

def sphere_candidate_t_mm(h, c, a, tmin, tmax):
    """Nearest valid root of the sphere quadratic (sphere.hpp:18-39).
    The discriminant is one fused multiply-add, as the reference's CPU
    and TPU compilers emit it: h*h and a*c nearly cancel for the r=1000
    ground sphere, so one more rounding there moves t by ~1e-4."""
    disc = vecmath.fma(h, h, -(a * c))
    sq = vecmath.safe_sqrt(disc)
    inv_a = 1.0 / a
    root0 = (h - sq) * inv_a
    root1 = (h + sq) * inv_a
    ok0 = (root0 > tmin) & (root0 < tmax)
    ok1 = (root1 > tmin) & (root1 < tmax)
    root = torch.where(ok0, root0, root1)
    valid = (disc >= 0.0) & (ok0 | ok1)
    return torch.where(valid, root, T_MAX)


def triangle_candidate_t_mm(det, u_num, v_num, t_num, tmin, tmax):
    """Two-sided Moller-Trumbore (triangle.hpp:17-82 hit set)."""
    near_zero = torch.abs(det) < 1e-12
    inv_det = 1.0 / torch.where(near_zero, 1.0, det)
    u = u_num * inv_det
    v = v_num * inv_det
    t = t_num * inv_det
    valid = (~near_zero & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin) & (t < tmax))
    return torch.where(valid, t, T_MAX)


def _safe_inv(v):
    return 1.0 / torch.where(torch.abs(v) < 1e-30, 1e-30, v)


def box_candidate_t_mm(dlx, dly, dlz, olx, oly, olz, tmin, tmax):
    """Slab test against the local [-1,1]^3 cube (cube.hpp:44-86):
    entering hit when t_near > tmin, else the exit hit."""
    ix, iy, iz = _safe_inv(dlx), _safe_inv(dly), _safe_inv(dlz)
    ax0, ax1 = (-1.0 - olx) * ix, (1.0 - olx) * ix
    ay0, ay1 = (-1.0 - oly) * iy, (1.0 - oly) * iy
    az0, az1 = (-1.0 - olz) * iz, (1.0 - olz) * iz
    t_near = torch.maximum(torch.maximum(torch.minimum(ax0, ax1),
                                         torch.minimum(ay0, ay1)),
                           torch.minimum(az0, az1))
    t_far = torch.minimum(torch.minimum(torch.maximum(ax0, ax1),
                                        torch.maximum(ay0, ay1)),
                          torch.maximum(az0, az1))
    t = torch.where(t_near > tmin, t_near, t_far)
    valid = (t_near < t_far) & (t > tmin) & (t < tmax)
    return torch.where(valid, t, T_MAX)


# --- the exact oracle --------------------------------------------------------

def _sphere_t(center, radius, o, d, tmin, tmax):
    oc = center[None, :, :] - o[:, None, :]
    a = (d * d).sum(-1)[:, None]
    h = (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - (radius * radius)[None, :]
    disc = h * h - a * c
    sq = vecmath.safe_sqrt(disc)
    inv_a = 1.0 / a
    root0 = (h - sq) * inv_a
    root1 = (h + sq) * inv_a
    ok0 = (root0 > tmin) & (root0 < tmax)
    ok1 = (root1 > tmin) & (root1 < tmax)
    root = torch.where(ok0, root0, root1)
    valid = (disc >= 0.0) & (ok0 | ok1) & (radius[None, :] > 0.0)
    return torch.where(valid, root, T_MAX)


def _triangle_t(v0, e1, e2, o, d, tmin, tmax):
    d_b = d[:, None, :].expand(-1, v0.shape[0], -1)
    pvec = torch.linalg.cross(d_b, e2[None].expand_as(d_b), dim=-1)
    det = (e1[None] * pvec).sum(-1)
    near_zero = torch.abs(det) < 1e-12
    inv_det = 1.0 / torch.where(near_zero, 1.0, det)
    tvec = o[:, None, :] - v0[None, :, :]
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None].expand_as(tvec), dim=-1)
    v = (d_b * qvec).sum(-1) * inv_det
    t = (e2[None] * qvec).sum(-1) * inv_det
    valid = (~near_zero & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin) & (t < tmax))
    return torch.where(valid, t, T_MAX)


def _box_t(minv, trans, o, d, tmin, tmax):
    m = minv.reshape(-1, 3, 3)
    o_l = torch.einsum("cij,nj->nci", m, o) + trans[None]
    d_l = torch.einsum("cij,nj->nci", m, d)
    inv = _safe_inv(d_l)
    t0 = (-1.0 - o_l) * inv
    t1 = (1.0 - o_l) * inv
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    t = torch.where(t_near > tmin, t_near, t_far)
    valid = (t_near < t_far) & (t > tmin) & (t < tmax)
    return torch.where(valid, t, T_MAX)


def _scan_chunks(candidate_fn, cols, n_rows, o, d, tmin, best_t, best_idx):
    """Running closest hit over CHUNK-wide primitive chunks."""
    for c0 in range(0, n_rows, CHUNK):
        t = candidate_fn(*(c[c0:c0 + CHUNK] for c in cols), o, d, tmin,
                         best_t[:, None])
        cmin, carg = torch.min(t, dim=1)
        better = cmin < best_t
        best_t = torch.where(better, cmin, best_t)
        best_idx = torch.where(better, c0 + carg.to(torch.int32), best_idx)
    return best_t, best_idx


def intersect_brute(scene, o, d, tmin) -> Hit:
    """Closest hit over all primitives by the classic per-pair tests
    (hittable_list.hpp:28-41): the exact oracle. o, d f32[N, 3]."""
    n = o.shape[0]
    init_t = torch.full((n,), T_MAX, dtype=torch.float32, device=o.device)
    init_idx = torch.zeros((n,), dtype=torch.int32, device=o.device)
    sph, tri = scene.spheres, scene.triangles
    s_t, s_idx = _scan_chunks(_sphere_t, [sph.center, sph.radius], sph.count,
                              o, d, tmin, init_t, init_idx)
    t_t, t_idx = _scan_chunks(_triangle_t, [tri.v0, tri.e1, tri.e2],
                              tri.count, o, d, tmin, s_t, s_idx)
    ptype = torch.where(t_t < s_t, PRIM_TRIANGLE, PRIM_SPHERE).to(torch.int32)
    b_t, b_idx = t_t, t_idx
    if scene.boxes is not None:
        box = scene.boxes
        b_t, b_idx = _scan_chunks(_box_t, [box.minv, box.trans], box.count,
                                  o, d, tmin, t_t, t_idx)
        box_won = b_t < t_t
        ptype = torch.where(box_won, PRIM_BOX, ptype).to(torch.int32)
        t_idx = torch.where(box_won, b_idx, t_idx)
    return Hit(t=b_t, prim_type=ptype, prim_idx=t_idx, hit=b_t < T_MAX)


# --- hit-record decode (plain version of the decode kernel) ------------------

_PACK_COLS = 28


def _default_row(vals):
    r = np.zeros((_PACK_COLS,), np.float32)
    r[: len(vals)] = vals
    return r


# Benign stand-in rows for lanes of another primitive type: unit sphere,
# unit right triangle with +z normals, identity box.
_SPHERE_DEFAULT_ROW = _default_row([0, 0, 0, 1, 0])
_TRI_DEFAULT_ROW = _default_row(
    [0, 0, 0, 1, 0, 0, 0, 1, 0,
     0, 0, 1, 0, 0, 1, 0, 0, 1,
     0, 0, 1, 0, 0, 1,
     1, 0, 0, 0])
_BOX_DEFAULT_ROW = _default_row([1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0])


def _f32(x):
    return torch.as_tensor(x).to(torch.float32)


def _box_packed(scene):
    """[Nb, 13] f32: minv (9), trans (3), mat."""
    b = scene.boxes
    return torch.cat([_f32(b.minv), _f32(b.trans), _f32(b.mat)[:, None]],
                     dim=1)


def _packed_all(scene):
    """[Ns+Nt+Nb, 28] f32 shading rows: sphere center, radius, mat (cols
    0:5); triangle v0 e1 e2 n0 n1 n2 uv0 uv1 uv2 tangent mat (0:28); box
    minv trans mat (0:13)."""
    f32 = _f32
    s, t = scene.spheres, scene.triangles
    parts = [torch.cat([f32(s.center), f32(s.radius)[:, None],
                        f32(s.mat)[:, None]], dim=1),
             torch.cat([f32(t.v0), f32(t.e1), f32(t.e2), f32(t.n0), f32(t.n1),
                        f32(t.n2), f32(t.uv0), f32(t.uv1), f32(t.uv2),
                        f32(t.tangent), f32(t.mat)[:, None]], dim=1)]
    if scene.boxes is not None:
        parts.append(_box_packed(scene))
    parts = [torch.nn.functional.pad(p, (0, _PACK_COLS - p.shape[1]))
             for p in parts]
    return torch.cat(parts, dim=0)


def _hit_point(t, d, o, compiled: bool):
    """t d + o; with `compiled`, one fused multiply-add per component, the
    rounding of the reference's compiled (jitted) SoA record."""
    if compiled:
        return tuple(vecmath.fma(t, d[k], o[k]) for k in range(3))
    return soa.axpy(t, d, o)


def _sphere_record_soa(g, o, d, t, compiled: bool = False):
    """Sphere shading data (sphere.hpp:40-79); g = per-column [N] tuple.
    The uv arcs are the polynomial ones the decode kernel uses; with
    `compiled` (the unfused pool's make_record_soa) the exact arcs and the
    fused hit point of the reference's compiled record."""
    center = (g[0], g[1], g[2])
    radius = torch.clamp(torch.abs(g[3]), min=1e-6)
    p = _hit_point(t, d, o, compiled)
    outward = soa.scale(soa.sub(p, center), 1.0 / radius)
    front = soa.dot(d, outward) < 0.0
    normal = soa.where(front, outward, soa.neg(outward))

    if compiled:
        theta = vecmath.safe_arccos(-outward[1])
        phi = torch.atan2(-outward[2], outward[0]) + PI
    else:
        theta = vecmath.acos_poly(-outward[1])
        phi = vecmath.atan2_poly(-outward[2], outward[0]) + PI
    u = phi / phi.new_tensor(2.0 * PI)
    v = theta / theta.new_tensor(PI)

    # world-up x n = (nz, 0, -nx); pole fallback (0,0,1) x n = (-ny, nx, 0).
    zero = torch.zeros_like(normal[0])
    tan_a = (normal[2], zero, -normal[0])
    degenerate = soa.length_squared(tan_a) < 1e-3
    tan_b = (-normal[1], normal[0], zero)
    tangent = soa.normalize(soa.where(degenerate, tan_b, tan_a))
    bitangent = soa.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, u, v, g[4]


def _triangle_record_soa(g, o, d, t, compiled: bool = False):
    """Triangle shading data: barycentric-smooth normal, interpolated uv,
    face tangent (triangle.hpp:56-79); `compiled` as for the sphere."""
    v0 = (g[0], g[1], g[2])
    e1 = (g[3], g[4], g[5])
    e2 = (g[6], g[7], g[8])
    n0 = (g[9], g[10], g[11])
    n1 = (g[12], g[13], g[14])
    n2 = (g[15], g[16], g[17])
    tangent = (g[24], g[25], g[26])
    p = _hit_point(t, d, o, compiled)

    geo_n = soa.cross(e1, e2)
    area_sq = torch.clamp(soa.length_squared(geo_n), min=1e-24)
    rel = soa.sub(p, v0)
    c0 = soa.cross(e1, rel)
    c2 = soa.cross(rel, e2)
    u = soa.dot(geo_n, c2) / area_sq
    v = soa.dot(geo_n, c0) / area_sq
    w = 1.0 - u - v

    smooth = soa.normalize(tuple(
        w * n0[k] + u * n1[k] + v * n2[k] for k in range(3)))
    front = soa.dot(d, smooth) < 0.0
    normal = soa.where(front, smooth, soa.neg(smooth))

    uu = w * g[18] + u * g[20] + v * g[22]
    vv = w * g[19] + u * g[21] + v * g[23]
    bitangent = soa.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, uu, vv, g[27]


def _box_record_soa(g, o, d, t, compiled: bool = False):
    """Box shading data: face normal, uv and tangent from the local hit
    point (cube.hpp:100-142); `compiled` as for the sphere."""
    p = _hit_point(t, d, o, compiled)
    l = tuple(g[3 * k] * p[0] + g[3 * k + 1] * p[1] + g[3 * k + 2] * p[2]
              + g[9 + k] for k in range(3))
    ax, ay, az = torch.abs(l[0]), torch.abs(l[1]), torch.abs(l[2])
    axis0 = (ax >= ay) & (ax >= az)
    axis1 = ~axis0 & (ay >= az)
    dom = torch.where(axis0, l[0], torch.where(axis1, l[1], l[2]))
    sign = torch.sign(dom)
    pos = sign > 0.0

    row = tuple(torch.where(axis0, g[k], torch.where(axis1, g[3 + k], g[6 + k]))
                for k in range(3))
    outward = soa.normalize(soa.scale(row, sign))
    front = soa.dot(d, outward) < 0.0
    normal = soa.where(front, outward, soa.neg(outward))

    one = torch.ones_like(l[0])
    zero = torch.zeros_like(l[0])
    fu = (torch.where(axis0, zero, torch.where(axis1, one,
                                               torch.where(pos, one, -one))),
          zero,
          torch.where(axis0, one, zero))
    fv = (zero, torch.where(axis1, zero, one), torch.where(axis1, one, zero))
    u = soa.dot(l, fu) * 0.5 + 0.5
    v = soa.dot(l, fv) * 0.5 + 0.5

    tx = torch.where(axis0, zero,
                     torch.where(axis1, torch.where(pos, -one, one),
                                 torch.where(pos, one, -one)))
    tz = torch.where(axis0, torch.where(pos, -one, one), zero)
    tangent = soa.normalize(tuple(tx * g[k] + tz * g[6 + k] for k in range(3)))
    bitangent = soa.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, u, v, g[12]


# --- the chunked integrator's record decode (AoS) ----------------------------

def _sphere_record_from(g, o, d, t):
    """Sphere shading data (sphere.hpp:40-79); g = packed rows [N, 28].
    Exact arcs for the uv, unlike the decode kernel's polynomial ones."""
    center = g[:, 0:3]
    radius = torch.clamp(torch.abs(g[:, 3]), min=1e-6)
    p = vecmath.fma(t[:, None], d, o)
    outward = (p - center) / radius[:, None]
    front = vecmath.dot(d, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    theta = vecmath.safe_arccos(-outward[:, 1])
    phi = torch.atan2(-outward[:, 2], outward[:, 0]) + PI
    u = phi / (2.0 * PI)
    v = theta / PI
    # world-up x n, and (0, 0, 1) x n near the poles (sphere.hpp:50-59).
    up = normal.new_tensor([0.0, 1.0, 0.0]).expand_as(normal)
    alt = normal.new_tensor([0.0, 0.0, 1.0]).expand_as(normal)
    tangent = vecmath.cross(up, normal)
    degenerate = vecmath.length_squared(tangent) < 1e-3
    tangent = torch.where(degenerate[:, None], vecmath.cross(alt, normal),
                          tangent)
    tangent = vecmath.normalize(tangent)
    bitangent = vecmath.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, u, v, g[:, 4]


def _triangle_record_from(g, o, d, t):
    """Triangle shading data: barycentric-smooth normal, interpolated uv
    and the face tangent (triangle.hpp:56-79)."""
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    n0, n1, n2 = g[:, 9:12], g[:, 12:15], g[:, 15:18]
    uv0, uv1, uv2 = g[:, 18:20], g[:, 20:22], g[:, 22:24]
    tangent = g[:, 24:27]
    p = vecmath.fma(t[:, None], d, o)
    geo_n = vecmath.cross(e1, e2)
    area_sq = torch.clamp(vecmath.length_squared(geo_n), min=1e-24)
    rel = p - v0
    c0 = vecmath.cross(e1, rel)
    c2 = vecmath.cross(rel, e2)
    u = vecmath.dot(geo_n, c2) / area_sq
    v = vecmath.dot(geo_n, c0) / area_sq
    w = 1.0 - u - v
    smooth = vecmath.normalize(w[:, None] * n0 + u[:, None] * n1
                               + v[:, None] * n2)
    front = vecmath.dot(d, smooth) < 0.0
    normal = torch.where(front[:, None], smooth, -smooth)
    uv = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    bitangent = vecmath.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, uv[:, 0], uv[:, 1], g[:, 27]


# Per-face u and v axes and local tangents of the canonical [-1, 1]^3 cube
# (cube.hpp:100-142), rows indexed by face = axis * 2 + (sign > 0).
_BOX_FACE_U = ((0., 0., 1.), (0., 0., 1.), (1., 0., 0.), (1., 0., 0.),
               (-1., 0., 0.), (1., 0., 0.))
_BOX_FACE_V = ((0., 1., 0.), (0., 1., 0.), (0., 0., 1.), (0., 0., 1.),
               (0., 1., 0.), (0., 1., 0.))
_BOX_FACE_TAN = ((0., 0., 1.), (0., 0., -1.), (1., 0., 0.), (-1., 0., 0.),
                 (-1., 0., 0.), (1., 0., 0.))


def _box_record_from(g, o, d, t):
    """Box shading data: face normal, uv and tangent from the local hit
    point (cube.hpp:100-142). Normals and tangents transform by the rows
    of the world -> local matrix (its inverse transpose)."""
    m = g[:, 0:9].reshape(-1, 3, 3)
    p = vecmath.fma(t[:, None], d, o)
    l = (m * p[:, None, :]).sum(-1) + g[:, 9:12]
    axis = torch.argmax(torch.abs(l), dim=-1)   # first maximum on ties
    rows = torch.arange(l.shape[0], device=l.device)
    sign = torch.sign(l[rows, axis])
    face = axis * 2 + (sign > 0.0).to(torch.int64)
    outward = vecmath.normalize(sign[:, None] * m[rows, axis])
    front = vecmath.dot(d, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    table = lambda rows_: g.new_tensor(rows_)[face]
    u = vecmath.dot(l, table(_BOX_FACE_U)) * 0.5 + 0.5
    v = vecmath.dot(l, table(_BOX_FACE_V)) * 0.5 + 0.5
    tangent = vecmath.normalize((table(_BOX_FACE_TAN)[:, :, None] * m).sum(1))
    bitangent = vecmath.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, u, v, g[:, 12]


def make_record(scene, o, d, hit: Hit) -> HitRecord:
    """Shading records of the closest hits: one row gather from the packed
    table, then each primitive type's decoder on its own lanes (the other
    lanes see a benign default row). Misses decode with t = 1 and are
    masked by the caller."""
    t_safe = torch.where(hit.hit, hit.t, 1.0)
    ns, nt = scene.spheres.count, scene.triangles.count
    table = _packed_all(scene)
    base = torch.where(hit.prim_type == PRIM_TRIANGLE, ns,
                       torch.where(hit.prim_type == PRIM_BOX, ns + nt, 0))
    g = table[torch.clamp(hit.prim_idx + base, 0, table.shape[0] - 1).long()]

    def decode(fn, ptype, default):
        mask = (hit.prim_type == ptype)[:, None]
        return fn(torch.where(mask, g, g.new_tensor(default)), o, d, t_safe)

    def sel(mask, a, b):
        return torch.where(mask[:, None] if a.dim() == 2 else mask, b, a)

    is_tri = hit.prim_type == PRIM_TRIANGLE
    sp = decode(_sphere_record_from, PRIM_SPHERE, _SPHERE_DEFAULT_ROW)
    tp = decode(_triangle_record_from, PRIM_TRIANGLE, _TRI_DEFAULT_ROW)
    parts = tuple(sel(is_tri, a, b) for a, b in zip(sp, tp))
    if scene.boxes is not None:
        is_box = hit.prim_type == PRIM_BOX
        bp = decode(_box_record_from, PRIM_BOX, _BOX_DEFAULT_ROW)
        parts = tuple(sel(is_box, a, b) for a, b in zip(parts, bp))
    p, normal, tangent, bitangent, front, u, v, mat = parts
    return HitRecord(t=hit.t, p=p, normal=normal, tangent=tangent,
                     bitangent=bitangent, front_face=front, u=u, v=v,
                     mat=mat.long(), hit=hit.hit)


# --- closest-hit routing of the chunked integrator ---------------------------

# Scenes of this many primitives or more take the BVH (the reference's
# BVH_MIN_PRIMS): off the card on the chunked path (`intersect_dispatch`),
# and on every device in the fused pool, whose tables then carry the tree
# for its closest hit (fused_step.build_tables, csrc/bvh_hit.cu on the
# card).
BVH_MIN_PRIMS = 8192


def ray_feature_rows(o, d):
    """[16, N] ray features of o, d f32[N, 3], with the roundings of the
    reference's compiled AoS features: o x d with one fused multiply-add
    per component, each 3-term dot as fma(a2, b2, fma(a1, b1, a0 * b0))
    (where `ray_features` above has fma(a2, b2, fma(a0, b0, a1 * b1)))."""
    m = tuple(vecmath.fma(o[:, i], d[:, j], -(o[:, j] * d[:, i]))
              for i, j in ((1, 2), (2, 0), (0, 1)))
    od, oo, dd = (vecmath.fma(a[:, 2], b[:, 2],
                              vecmath.fma(a[:, 1], b[:, 1], a[:, 0] * b[:, 0]))
                  for a, b in ((o, d), (o, o), (d, d)))
    one = torch.ones_like(od)
    zero = torch.zeros_like(od)
    return torch.stack([d[:, 0], d[:, 1], d[:, 2], o[:, 0], o[:, 1], o[:, 2],
                        m[0], m[1], m[2], od, oo, one, dd, zero, zero, zero])


def intersect_dispatch(scene, device) -> str:
    """The chunked path's closest-hit route for rays on `device` (the
    fused pool routes on its own: past BVH_MIN_PRIMS its tables carry the
    BVH on every device, fused_step.build_tables):
      * on CUDA, "k4" (the prebuilt-feature closest hit of
        ops/closest_hit.py, its kernel) whenever the scene has coefficient
        tables, the counterpart of the reference's accelerator route;
      * elsewhere the reference's order: "bvh" (ops/traverse.py) when the
        scene has a BVH and BVH_MIN_PRIMS primitives or more, then "k4" in
        its plain version (the counterpart of the reference's "mm"), then
        "brute".
    A CUDA scene without tables takes the same "bvh" / "brute" order."""
    on_card = torch.device(device).type == "cuda"
    if on_card and scene.mm is not None:
        return "k4"
    if scene.bvh is not None and scene.primitive_count >= BVH_MIN_PRIMS:
        return "bvh"
    if scene.mm is not None:
        return "k4"
    return "brute"


def hit_tables(scene):
    """What `intersect` needs besides the scene, built once per scene: the
    closest-hit tables (ops/closest_hit.py ScanTables) when rays on the
    scene's device take the "k4" route, else None."""
    if intersect_dispatch(scene, scene.spheres.center.device) != "k4":
        return None
    from . import closest_hit

    return closest_hit.scan_tables(scene)


def intersect(scene, o, d, tmin: float, tables, sort_rays: bool = False) -> Hit:
    """Closest hits of the rays o, d f32[N, 3] beyond tmin, by the route
    `intersect_dispatch` gives for their device. tables: the scene's
    `hit_tables`, built once per scene by the caller.

    sort_rays (the "k4" route only; the others take the rays as they come):
    group the rays into coherent kernel blocks by (nearest 512-wide chunk,
    direction octant) before K4 and put the results back in ray order, the
    reference's option of intersect_brute_pallas
    (pallas_intersect.py:524-562). Scheduling only: the same hit per ray."""
    path = intersect_dispatch(scene, o.device)
    if path == "bvh":
        from . import traverse

        return traverse.intersect_bvh(scene, o, d, tmin)
    if path == "brute":
        return intersect_brute(scene, o, d, tmin)
    from . import closest_hit

    dest = None
    if sort_rays:
        order, dest = sort_order(scene, o, d)
        o, d = o[order], d[order]
    t, idx, typ = closest_hit.closest_hit_feats(
        ray_feature_rows(o, d).contiguous(), tmin, tables)
    if dest is not None:
        # Ray i's result sits at slot dest[i].
        t, idx, typ = t[dest], idx[dest], typ[dest]
    return Hit(t=t, prim_type=typ, prim_idx=idx, hit=t < T_MAX)


# --- the differentiable mode's detached intersection -------------------------
#
# Which primitive a ray hits is a discrete choice with no useful derivative.
# The detached-sampling estimator of the reference (intersect.py:771-874)
# runs the search on detached rays and tables (on the card that is K4, whose
# ctypes launch records nothing for autograd), then recomputes the hit
# distance of the chosen primitive in torch ops from the raw tables, so t
# carries gradients to that primitive's parameters and to the ray. Only the
# silhouette terms are dropped. The search scans the coefficient tables
# built with the scene: a fit that moves geometry keeps searching the old
# ones, as in the reference.

def _eps_signed(x, eps=1e-12):
    """x with |x| >= eps, keeping its sign (a division guard)."""
    return torch.where(torch.abs(x) < eps, torch.where(x < 0.0, -eps, eps), x)


def _diff_t_sphere(scene, o, d, idx, t_det):
    """t of the chosen sphere: the quadratic solved again (sphere.hpp:18-39),
    taking the root nearer the search's t."""
    s = scene.spheres
    oc = s.center[idx] - o
    radius = s.radius[idx]
    a = vecmath.length_squared(d)
    h = vecmath.dot(d, oc)
    c = vecmath.length_squared(oc) - radius * radius
    # h h - a c as the reference's compiled form rounds it (one fused
    # multiply-add). Chosen lanes have disc > 0, so the clamp's tie
    # gradient never arises.
    disc = vecmath.fma(h, h, -(a * c))
    sq = vecmath.safe_sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / _eps_signed(a)
    r0 = (h - sq) * inv_a
    r1 = (h + sq) * inv_a
    pick0 = torch.abs(r0.detach() - t_det) <= torch.abs(r1.detach() - t_det)
    return torch.where(pick0, r0, r1)


def _diff_t_triangle(scene, o, d, idx, t_det):
    """t of the chosen triangle (Moller-Trumbore, triangle.hpp:17-82)."""
    tr = scene.triangles
    pvec = vecmath.cross(d, tr.e2[idx])
    det = _eps_signed(vecmath.dot(tr.e1[idx], pvec))
    qvec = vecmath.cross(o - tr.v0[idx], tr.e1[idx])
    return vecmath.dot(tr.e2[idx], qvec) / det


def _diff_t_box(scene, o, d, idx, t_det):
    """t of the chosen affine-slab box: the local-frame slab distances
    (cube.hpp:44-86), taking entry or exit, whichever is nearer the
    search's t."""
    b = scene.boxes
    m = b.minv[idx].reshape(-1, 3, 3)
    lo = torch.einsum("nij,nj->ni", m, o) + b.trans[idx]
    ld = _eps_signed(torch.einsum("nij,nj->ni", m, d), 1e-30)
    inv = 1.0 / ld
    t0 = (-1.0 - lo) * inv
    t1 = (1.0 - lo) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    pickn = torch.abs(tn.detach() - t_det) <= torch.abs(tf.detach() - t_det)
    return torch.where(pickn, tn, tf)


def intersect_detached(scene, o, d, tmin: float, tables) -> Hit:
    """`intersect` for the differentiable mode: the search on detached
    inputs (K4 on the card), then t of each chosen primitive recomputed
    from the scene's tables, so t carries gradients to the primitive and
    to o, d. Hit lanes carry the recomputed value (the search's t to float
    rounding; the search's where it is not finite), as in the reference;
    prim_type, prim_idx and hit are constants, and misses keep the
    search's T_MAX. tables: the scene's `hit_tables`."""
    detached = tree_map(
        lambda x: x.detach() if isinstance(x, torch.Tensor) else x, scene)
    det = intersect(detached, o.detach(), d.detach(), tmin, tables)
    t_det = torch.where(det.hit, det.t, 1.0)
    idx = det.prim_idx.long()
    t = t_det
    for ptype, table, fn in ((PRIM_SPHERE, scene.spheres, _diff_t_sphere),
                             (PRIM_TRIANGLE, scene.triangles, _diff_t_triangle),
                             (PRIM_BOX, scene.boxes, _diff_t_box)):
        if table is not None and table.count:
            ti = fn(scene, o, d, torch.clamp(idx, 0, table.count - 1), t_det)
            t = torch.where(det.prim_type == ptype, ti, t)
    t = torch.where(torch.isfinite(t), t, t_det)
    return det._replace(t=torch.where(det.hit, t, det.t))


# --- sort_rays: the coherence permutation of the "k4" route -------------------

def _sort_key(o, d, bounds):
    """(major, minor) of each ray (reference _sort_key,
    pallas_intersect.py:432): major = the index of the nearest chunk AABB
    the ray overlaps (n_chunks when it overlaps none), minor = its
    direction octant."""
    c = bounds.shape[0]
    inv = 1.0 / torch.where(torch.abs(d) < 1e-30, 1e-30, d)
    tn = torch.full((o.shape[0], c), -float("inf"), device=o.device)
    tf = torch.full((o.shape[0], c), float("inf"), device=o.device)
    for ax in range(3):
        t0 = (bounds[None, :, ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        t1 = (bounds[None, :, 3 + ax] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        tn = torch.maximum(tn, torch.minimum(t0, t1))
        tf = torch.minimum(tf, torch.maximum(t0, t1))
    ok = (tn <= tf) & (tf > 0.0) & (bounds[None, :, 0] <= bounds[None, :, 3])
    first = torch.argmin(torch.where(ok, torch.clamp(tn, min=0.0), float("inf")),
                         dim=1)
    first = torch.where(ok.any(dim=1), first, c)
    octant = (((d[:, 0] > 0).long() << 2) | ((d[:, 1] > 0).long() << 1)
              | (d[:, 2] > 0).long())
    return first, octant


def _radix_order(minor, major):
    """(order, dest): the permutation that groups lanes by (major, octant
    minor) keeping lane order within a group, and its inverse
    (order[dest[i]] = i).
    The reference builds it with two stable counting-sort passes
    (_radix_order, pallas_intersect.py:484); one stable sort of the joint
    key gives the same permutation."""
    order = torch.sort(major * 8 + minor, stable=True).indices
    return order, _invert_perm(order)


def _invert_perm(order):
    dest = torch.empty_like(order)
    dest[order] = torch.arange(order.shape[0], device=order.device)
    return dest


def sort_order(scene, o, d):
    """(order, dest) of sort_rays for rays o, d f32[N, 3]: the key is taken
    on the reference's 512-wide chunk AABBs (_coarsen_bounds), so the
    permutation is the reference's bit for bit."""
    from . import closest_hit

    mm = scene.mm
    bounds = torch.cat([closest_hit.coarsen_bounds(b) for b in
                        (mm.sphere_bounds, mm.tri_bounds, mm.box_bounds)])
    major, minor = _sort_key(o, d, bounds)
    return _radix_order(minor, major)


# --- the unfused pool's side (SoA: vectors as (x, y, z) tuples of [N]) --------

class HitRecordSoa(NamedTuple):
    """HitRecord with its vectors as (x, y, z) tuples of f32[N]."""

    t: torch.Tensor
    p: tuple
    normal: tuple
    tangent: tuple
    bitangent: tuple
    front_face: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    mat: torch.Tensor         # i64[N]
    hit: torch.Tensor


def make_record_soa(scene, o, d, hit: Hit, packed=None) -> HitRecordSoa:
    """SoA twin of make_record (reference make_record_soa,
    intersect.py:1244): o, d are component tuples; the decoders take the
    compiled form (exact arcs, fused hit points). packed: the scene's `_packed_all` rows, built once per
    render by the caller (else here)."""
    if packed is None:
        packed = _packed_all(scene)
    t_safe = torch.where(hit.hit, hit.t, 1.0)
    ns, nt = scene.spheres.count, scene.triangles.count
    base = torch.where(hit.prim_type == PRIM_TRIANGLE, ns,
                       torch.where(hit.prim_type == PRIM_BOX, ns + nt, 0))
    row = torch.clamp(hit.prim_idx.long() + base, 0, packed.shape[0] - 1)
    g = packed[row]
    is_sph = hit.prim_type == PRIM_SPHERE
    is_tri = hit.prim_type == PRIM_TRIANGLE
    is_box = hit.prim_type == PRIM_BOX

    def sel_cols(mask, default, ncols):
        return tuple(torch.where(mask, g[:, k], float(default[k]))
                     for k in range(ncols)) + (None,) * (_PACK_COLS - ncols)

    def sel(mask, a, b):
        return soa.where(mask, b, a) if isinstance(a, tuple) else torch.where(mask, b, a)

    sp = _sphere_record_soa(sel_cols(is_sph, _SPHERE_DEFAULT_ROW, 5), o, d,
                            t_safe, compiled=True)
    tp = _triangle_record_soa(sel_cols(is_tri, _TRI_DEFAULT_ROW, 28), o, d,
                              t_safe, compiled=True)
    parts = tuple(sel(is_tri, a, b) for a, b in zip(sp, tp))
    if scene.boxes is not None:
        bp = _box_record_soa(sel_cols(is_box, _BOX_DEFAULT_ROW, 13), o, d,
                             t_safe, compiled=True)
        parts = tuple(sel(is_box, a, b) for a, b in zip(parts, bp))
    p, normal, tangent, bitangent, front, u, v, mat = parts
    return HitRecordSoa(t=hit.t, p=p, normal=normal, tangent=tangent,
                        bitangent=bitangent, front_face=front, u=u, v=v,
                        mat=mat.long(), hit=hit.hit)


def intersect_soa(scene, o, d, tmin: float, tables) -> Hit:
    """SoA twin of intersect (reference intersect_soa, intersect.py:1315):
    on CUDA the "k4" route runs K1 (closest_hit.closest_hit) on the rays' od
    rows, the reference's accelerator route intersect_brute_pallas_od;
    elsewhere the rays take `intersect`'s route."""
    if (o[0].device.type == "cuda"
            and intersect_dispatch(scene, o[0].device) == "k4"):
        from . import closest_hit

        t, idx, typ = closest_hit.closest_hit(
            torch.stack([*o, *d]).contiguous(), tmin, tables)
        return Hit(t=t, prim_type=typ, prim_idx=idx, hit=t < T_MAX)
    return intersect(scene, torch.stack(o, 1), torch.stack(d, 1), tmin, tables)
