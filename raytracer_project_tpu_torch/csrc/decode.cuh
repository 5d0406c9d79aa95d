// Hit-record decoders of K2 (csrc/decode.cu), shared with the P3 decode
// bisection probe (csrc/probe_decode.cu): the _RO_* row order, the sphere,
// triangle and box shading records from a packed 28-column row, and the
// clipped row index of a table fetch.
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
