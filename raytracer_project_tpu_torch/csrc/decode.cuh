// Hit-record decoders of K2 (csrc/decode.cu), shared with the P3 decode
// bisection probe (csrc/probe_decode.cu) and K3 fused
// (csrc/shade_advance.cu): the _RO_* row order, the sphere, triangle and
// box shading records from a packed 28-column row, the clipped row index
// of a table fetch, and decode_lane, one lane's whole hit record in
// registers.
#pragma once

#include "common.cuh"

enum {
  RO_HIT = 0, RO_T = 1, RO_N = 2, RO_TAN = 5, RO_BIT = 8, RO_FRONT = 11,
  RO_MTYPE = 12, RO_PARAM = 13, RO_BSTR = 14, RO_BASE = 15, RO_GU = 18,
  RO_GV = 19, RO_HASB = 20, RO_TEXROW = 21, RO_BUMPROW = 22, RO_ENVROW = 23,
};

#define PACK_COLS 28
#define DIELECTRIC 2.0f
#define KIND_IMAGE 0.0f
#define KIND_MISSING 2.0f

struct Record {
  V3 p, normal, tangent, bitangent;
  bool front;
  float u, v, mat;
};

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// sphere.hpp:40-79 (uv from the outward normal, polynomial arcs).
__device__ Record sphere_record(const float* g, V3 o, V3 d, float t) {
  Record r;
  V3 center = v3(g[0], g[1], g[2]);
  float radius = fmaxf(fabsf(g[3]), 1e-6f);
  r.p = axpy(t, d, o);
  V3 outward = scale(sub(r.p, center), 1.0f / radius);
  r.front = dot(d, outward) < 0.0f;
  r.normal = sel(r.front, outward, neg(outward));
  float theta = acos_poly(-outward.y);
  float phi = atan2_poly(-outward.z, outward.x) + PI_F;
  r.u = phi / TWO_PI_F;
  r.v = theta / PI_F;
  V3 n = r.normal;
  V3 tan_a = v3(n.z, 0.0f, -n.x);
  bool degenerate = dot(tan_a, tan_a) < 1e-3f;
  V3 tan_b = v3(-n.y, n.x, 0.0f);
  r.tangent = normalize(sel(degenerate, tan_b, tan_a));
  r.bitangent = cross(n, r.tangent);
  r.mat = g[4];
  return r;
}

// triangle.hpp:56-79 (barycentric-smooth normal, interpolated uv).
__device__ Record triangle_record(const float* g, V3 o, V3 d, float t) {
  Record r;
  V3 v0 = v3(g[0], g[1], g[2]);
  V3 e1 = v3(g[3], g[4], g[5]);
  V3 e2 = v3(g[6], g[7], g[8]);
  V3 n0 = v3(g[9], g[10], g[11]);
  V3 n1 = v3(g[12], g[13], g[14]);
  V3 n2 = v3(g[15], g[16], g[17]);
  r.tangent = v3(g[24], g[25], g[26]);
  r.p = axpy(t, d, o);
  V3 geo_n = cross(e1, e2);
  float area_sq = fmaxf(dot(geo_n, geo_n), 1e-24f);
  V3 rel = sub(r.p, v0);
  V3 c0 = cross(e1, rel);
  V3 c2 = cross(rel, e2);
  float u = dot(geo_n, c2) / area_sq;
  float v = dot(geo_n, c0) / area_sq;
  float w = 1.0f - u - v;
  V3 smooth = normalize(v3(w * n0.x + u * n1.x + v * n2.x,
                           w * n0.y + u * n1.y + v * n2.y,
                           w * n0.z + u * n1.z + v * n2.z));
  r.front = dot(d, smooth) < 0.0f;
  r.normal = sel(r.front, smooth, neg(smooth));
  r.u = w * g[18] + u * g[20] + v * g[22];
  r.v = w * g[19] + u * g[21] + v * g[23];
  r.bitangent = cross(r.normal, r.tangent);
  r.mat = g[27];
  return r;
}

// cube.hpp:100-142: face normal, uv and tangent from the local hit point.
__device__ Record box_record(const float* g, V3 o, V3 d, float t) {
  Record r;
  r.p = axpy(t, d, o);
  V3 p = r.p;
  float l[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    l[k] = g[3 * k] * p.x + g[3 * k + 1] * p.y + g[3 * k + 2] * p.z + g[9 + k];
  float ax = fabsf(l[0]), ay = fabsf(l[1]), az = fabsf(l[2]);
  bool axis0 = ax >= ay && ax >= az;
  bool axis1 = !axis0 && ay >= az;
  float dom = axis0 ? l[0] : (axis1 ? l[1] : l[2]);
  float sign = signf(dom);
  bool pos = sign > 0.0f;
  int rb = axis0 ? 0 : (axis1 ? 3 : 6);
  V3 outward = normalize(scale(v3(g[rb], g[rb + 1], g[rb + 2]), sign));
  r.front = dot(d, outward) < 0.0f;
  r.normal = sel(r.front, outward, neg(outward));
  V3 lv = v3(l[0], l[1], l[2]);
  V3 fu = v3(axis0 ? 0.0f : (axis1 ? 1.0f : (pos ? 1.0f : -1.0f)), 0.0f,
             axis0 ? 1.0f : 0.0f);
  V3 fv = v3(0.0f, axis1 ? 0.0f : 1.0f, axis1 ? 1.0f : 0.0f);
  r.u = dot(lv, fu) * 0.5f + 0.5f;
  r.v = dot(lv, fv) * 0.5f + 0.5f;
  float tx = axis0 ? 0.0f : (axis1 ? (pos ? -1.0f : 1.0f) : (pos ? 1.0f : -1.0f));
  float tz = axis0 ? (pos ? -1.0f : 1.0f) : 0.0f;
  r.tangent = normalize(v3(tx * g[0] + tz * g[6], tx * g[1] + tz * g[7],
                           tx * g[2] + tz * g[8]));
  r.bitangent = cross(r.normal, r.tangent);
  r.mat = g[12];
  return r;
}

__device__ __forceinline__ float clip0(float x, float hi) { return fminf(fmaxf(x, 0.0f), hi); }

__device__ __forceinline__ int row_index(float x, int n) {
  return (int)fminf(fmaxf(x, 0.0f), (float)(n - 1));
}

// The scene tables decode_lane reads (FusedTables of ops/fused_step.py).
struct DecodeTables {
  const float* aparams;  // [tmin, cos/sin yaw, tilt, roll, 0]
  const float* rectab;   // [n_rec, 28] packed primitive rows
  const float* mattab;   // [n_mat, 8]
  const float* texmeta;  // [n_tex, 10]
  int n_rec, n_mat, n_tex, n_spheres, n_tris, has_boxes, has_env;
  float ah, aw, eh, ew;  // atlas and equirect heights and widths
};

// One lane's hit record: the 24 _RO_* rows of K2, in registers.
struct Hit {
  bool hit;
  float t;
  V3 normal, tangent, bitangent;
  bool front;
  float mtype, param, bstr;
  float base[3];     // checker / solid / missing-cyan base color
  float gate_u, gate_v;
  bool has_bump;
  float texrow;      // flat atlas row, -1 = use the base color
  float bumprow;     // 0 without a bump map
  float envrow;      // equirect HDR row (0 unless has_env)
};

// From K1's closest hit (t, idx, type) of the ray (o, d): loads the packed
// primitive row, decodes the sphere, triangle or box shading record, loads
// the material row and the texture-metadata rows, resolves the base color
// or the image texel row, the bump row with its u/v crossing gates, and the
// HDR equirect row. Every fetch is one direct indexed load, which returns
// the f32 table entry exactly.
__device__ __forceinline__ Hit decode_lane(V3 o, V3 d, float t, int idx,
                                           int type, const DecodeTables& tb) {
  Hit h;
  h.hit = t < T_MAX_F;
  h.t = t;
  float t_safe = h.hit ? t : 1.0f;

  int base = type == 1 ? tb.n_spheres
                       : (type == 2 ? tb.n_spheres + tb.n_tris : 0);
  int row = min(max(idx + base, 0), tb.n_rec - 1);
  float g[PACK_COLS];
#pragma unroll
  for (int k = 0; k < PACK_COLS; ++k) g[k] = __ldg(tb.rectab + row * PACK_COLS + k);
  Record r;
  if (type == 1) {
    r = triangle_record(g, o, d, t_safe);
  } else if (type == 2 && tb.has_boxes) {
    r = box_record(g, o, d, t_safe);
  } else {
    r = sphere_record(g, o, d, t_safe);
  }
  h.normal = r.normal;
  h.tangent = r.tangent;
  h.bitangent = r.bitangent;
  h.front = r.front;

  const float* mrow = tb.mattab + 8 * row_index(r.mat, tb.n_mat);
  float solid[3] = {__ldg(mrow), __ldg(mrow + 1), __ldg(mrow + 2)};
  h.param = __ldg(mrow + 3);
  h.mtype = __ldg(mrow + 4);
  float tex_id = __ldg(mrow + 5), bump_id = __ldg(mrow + 6);
  h.bstr = __ldg(mrow + 7);

  // Texture row + non-image base color (textures.sample_soa semantics).
  const float* tmeta = tb.texmeta + 10 * row_index(tex_id, tb.n_tex);
  float kind = __ldg(tmeta), tw = __ldg(tmeta + 1), th = __ldg(tmeta + 2);
  float uu = r.u - floorf(r.u);
  float ti = clip0(floorf(uu * tw), fmaxf(tw - 1.0f, 0.0f));
  float tj = clip0(floorf(r.v * th), fmaxf(th - 1.0f, 0.0f));
  float texrow = (fmaxf(tex_id, 0.0f) * tb.ah + tj) * tb.aw + ti;
  bool is_diel = h.mtype == DIELECTRIC;
  bool is_image = kind == KIND_IMAGE && tex_id >= 0.0f && !is_diel;
  float inv_scale = __ldg(tmeta + 3);
  float cells = floorf(inv_scale * r.p.x) + floorf(inv_scale * r.p.y) +
                floorf(inv_scale * r.p.z);
  bool is_even = cells - 2.0f * floorf(cells * 0.5f) == 0.0f;
  const float cyan[3] = {0.0f, 1.0f, 1.0f};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float col = is_even ? __ldg(tmeta + 4 + c) : __ldg(tmeta + 7 + c);
    col = kind == KIND_MISSING ? cyan[c] : col;
    h.base[c] = (tex_id < 0.0f || is_diel) ? solid[c] : col;
  }
  h.texrow = is_image ? texrow : -1.0f;

  // Bump row + finite-difference crossing gates (sample_bump_deltas).
  const float* bmeta = tb.texmeta + 10 * row_index(bump_id, tb.n_tex);
  float bw = __ldg(bmeta + 1), bh = __ldg(bmeta + 2);
  float bwm = fmaxf(bw - 1.0f, 0.0f), bhm = fmaxf(bh - 1.0f, 0.0f);
  float bi = clip0(floorf(uu * bw), bwm);
  float bj = clip0(floorf(r.v * bh), bhm);
  float bumprow = (fmaxf(bump_id, 0.0f) * tb.ah + bj) * tb.aw + bi;
  const float delta = 1.0f / 1024.0f;
  float u2 = r.u + delta;
  float uu2 = u2 - floorf(u2);
  float bi2 = clip0(floorf(uu2 * bw), bwm);
  float bj2 = clip0(floorf((r.v + delta) * bh), bhm);
  h.has_bump = bump_id >= 0.0f;
  h.gate_u = (bi2 != bi && h.has_bump) ? 1.0f : 0.0f;
  h.gate_v = (bj2 != bj && h.has_bump) ? 1.0f : 0.0f;
  h.bumprow = h.has_bump ? bumprow : 0.0f;

  // HDR equirect row: yaw/tilt/roll, then polynomial arcs (camera.hpp:837-870).
  h.envrow = 0.0f;
  if (tb.has_env) {
    V3 e = normalize(d);
    const float* ap = tb.aparams;
    float cy = ap[1], sy = ap[2], cp = ap[3], sp = ap[4];
    float cr = ap[5], sr = ap[6];
    float ex = cy * e.x + sy * e.z, ez = -sy * e.x + cy * e.z;
    float ey = cp * e.y - sp * ez;
    ez = sp * e.y + cp * ez;
    float ex2 = cr * ex - sr * ey;
    ey = sr * ex + cr * ey;
    ex = ex2;
    float phi = atan2_poly(ez, ex) + PI_F;
    float theta = acos_poly(ey);
    float euu = phi / TWO_PI_F;
    euu = euu - floorf(euu);
    float ei = clip0(floorf(euu * tb.ew), tb.ew - 1.0f);
    float ej = clip0(floorf(theta / PI_F * tb.eh), tb.eh - 1.0f);
    h.envrow = ej * tb.ew + ei;
  }
  return h;
}
