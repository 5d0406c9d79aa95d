// K2, hit-record decode (replaces the Pallas kernel _decode_kernel with
// _onehot_rows, raytracer_project_tpu/ops/fused_step.py:326, :257).
//
// One thread per lane. From K1's closest hit it loads the packed 28-column
// primitive row, decodes the sphere, triangle or box shading record, loads
// the material row and the texture-metadata rows, resolves the checker /
// solid / missing-cyan base color or the image texel row, the bump row
// with its u/v crossing gates, and the HDR equirect row; it writes 24 rows
// of f32 [24, P] in the _RO_* order of ops/fused_step.py.
//
// The reference fetches table rows with one-hot matmuls on the MXU (TPU
// gathers are slow); here every fetch is one direct indexed load, which
// returns the f32 table entry exactly.
//
// Bound on the H100: bytes. Per lane it reads o, d (24 B) and the hit
// (12 B), and writes 24 f32 rows (96 B): 132 B/lane at 3.35 TB/s; the
// tables (a few tens of KB) stay in L1/L2.

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

__global__ void decode_kernel(const float* __restrict__ od,
                              const float* __restrict__ best_t,
                              const int* __restrict__ best_idx,
                              const int* __restrict__ best_type, int p,
                              const float* __restrict__ aparams,
                              const float* __restrict__ rectab, int n_rec,
                              const float* __restrict__ mattab, int n_mat,
                              const float* __restrict__ texmeta, int n_tex,
                              int n_spheres, int n_tris, int has_boxes,
                              float ah, float aw, int has_env, float eh,
                              float ew, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  V3 o = v3(od[i], od[p + i], od[2 * p + i]);
  V3 d = v3(od[3 * p + i], od[4 * p + i], od[5 * p + i]);
  float t = best_t[i];
  int type = best_type[i];
  bool hit = t < T_MAX_F;
  float t_safe = hit ? t : 1.0f;

  int base = type == 1 ? n_spheres : (type == 2 ? n_spheres + n_tris : 0);
  int row = min(max(best_idx[i] + base, 0), n_rec - 1);
  float g[PACK_COLS];
#pragma unroll
  for (int k = 0; k < PACK_COLS; ++k) g[k] = __ldg(rectab + row * PACK_COLS + k);
  Record r;
  if (type == 1) {
    r = triangle_record(g, o, d, t_safe);
  } else if (type == 2 && has_boxes) {
    r = box_record(g, o, d, t_safe);
  } else {
    r = sphere_record(g, o, d, t_safe);
  }

  const float* mrow = mattab + 8 * row_index(r.mat, n_mat);
  float solid[3] = {__ldg(mrow), __ldg(mrow + 1), __ldg(mrow + 2)};
  float param = __ldg(mrow + 3), mtype = __ldg(mrow + 4);
  float tex_id = __ldg(mrow + 5), bump_id = __ldg(mrow + 6);
  float bstr = __ldg(mrow + 7);

  // Texture row + non-image base color (textures.sample_soa semantics).
  const float* tmeta = texmeta + 10 * row_index(tex_id, n_tex);
  float kind = __ldg(tmeta), tw = __ldg(tmeta + 1), th = __ldg(tmeta + 2);
  float uu = r.u - floorf(r.u);
  float ti = clip0(floorf(uu * tw), fmaxf(tw - 1.0f, 0.0f));
  float tj = clip0(floorf(r.v * th), fmaxf(th - 1.0f, 0.0f));
  float texrow = (fmaxf(tex_id, 0.0f) * ah + tj) * aw + ti;
  bool is_diel = mtype == DIELECTRIC;
  bool is_image = kind == KIND_IMAGE && tex_id >= 0.0f && !is_diel;
  float inv_scale = __ldg(tmeta + 3);
  float cells = floorf(inv_scale * r.p.x) + floorf(inv_scale * r.p.y) +
                floorf(inv_scale * r.p.z);
  bool is_even = cells - 2.0f * floorf(cells * 0.5f) == 0.0f;
  const float cyan[3] = {0.0f, 1.0f, 1.0f};
  float base_color[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float col = is_even ? __ldg(tmeta + 4 + c) : __ldg(tmeta + 7 + c);
    col = kind == KIND_MISSING ? cyan[c] : col;
    base_color[c] = (tex_id < 0.0f || is_diel) ? solid[c] : col;
  }

  // Bump row + finite-difference crossing gates (sample_bump_deltas).
  const float* bmeta = texmeta + 10 * row_index(bump_id, n_tex);
  float bw = __ldg(bmeta + 1), bh = __ldg(bmeta + 2);
  float bwm = fmaxf(bw - 1.0f, 0.0f), bhm = fmaxf(bh - 1.0f, 0.0f);
  float bi = clip0(floorf(uu * bw), bwm);
  float bj = clip0(floorf(r.v * bh), bhm);
  float bumprow = (fmaxf(bump_id, 0.0f) * ah + bj) * aw + bi;
  const float delta = 1.0f / 1024.0f;
  float u2 = r.u + delta;
  float uu2 = u2 - floorf(u2);
  float bi2 = clip0(floorf(uu2 * bw), bwm);
  float bj2 = clip0(floorf((r.v + delta) * bh), bhm);
  bool has_bump = bump_id >= 0.0f;
  float gate_u = (bi2 != bi && has_bump) ? 1.0f : 0.0f;
  float gate_v = (bj2 != bj && has_bump) ? 1.0f : 0.0f;

  // HDR equirect row: yaw/tilt/roll, then polynomial arcs (camera.hpp:837-870).
  float envrow = 0.0f;
  if (has_env) {
    V3 e = normalize(d);
    float cy = aparams[1], sy = aparams[2], cp = aparams[3], sp = aparams[4];
    float cr = aparams[5], sr = aparams[6];
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
    float ei = clip0(floorf(euu * ew), ew - 1.0f);
    float ej = clip0(floorf(theta / PI_F * eh), eh - 1.0f);
    envrow = ej * ew + ei;
  }

  float vals[24] = {
      hit ? 1.0f : 0.0f, t,
      r.normal.x, r.normal.y, r.normal.z,
      r.tangent.x, r.tangent.y, r.tangent.z,
      r.bitangent.x, r.bitangent.y, r.bitangent.z,
      r.front ? 1.0f : 0.0f, mtype, param, bstr,
      base_color[0], base_color[1], base_color[2],
      gate_u, gate_v, has_bump ? 1.0f : 0.0f,
      is_image ? texrow : -1.0f,
      has_bump ? bumprow : 0.0f,
      envrow};
#pragma unroll
  for (int k = 0; k < 24; ++k) out[k * p + i] = vals[k];
}

extern "C" int decode_launch(const void* od, const void* t, const void* idx,
                             const void* type, int p, const void* aparams,
                             const void* rectab, int n_rec, const void* mattab,
                             int n_mat, const void* texmeta, int n_tex,
                             int n_spheres, int n_tris, int has_boxes, float ah,
                             float aw, int has_env, float eh, float ew,
                             void* out, void* stream) {
  const int block = 256;
  int grid = (p + block - 1) / block;
  if (grid > 0) {
    decode_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)od, (const float*)t, (const int*)idx, (const int*)type,
        p, (const float*)aparams, (const float*)rectab, n_rec,
        (const float*)mattab, n_mat, (const float*)texmeta, n_tex, n_spheres,
        n_tris, has_boxes, ah, aw, has_env, eh, ew, (float*)out);
  }
  return (int)cudaGetLastError();
}
