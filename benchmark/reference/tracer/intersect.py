"""Frozen copy of raytracer_project_tpu_torch/ops/intersect.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import torch

from . import soa, vecmath

from .constants import PI, T_MAX

from .tree import to_device, tree_map

from .geometry import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE


RAY_FEATURE_DIM = 16


MM_PAD = 512


MM_FINE = 128


CHUNK = 128


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


_PACK_COLS = 28


def _default_row(vals):
    r = np.zeros((_PACK_COLS,), np.float32)
    r[: len(vals)] = vals
    return r


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

