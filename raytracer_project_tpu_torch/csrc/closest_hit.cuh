// Device functions of the closest-hit scan (K1 and K4, csrc/closest_hit.cu),
// shared with the P1 ablation probe (csrc/probe_a1_ablate.cu): the 16-term
// fmaf dots, the sphere/triangle/box epilogues, the ray features, the
// per-chunk AABB test and the per-warp culled scan of one table.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define T_MAX_F 1e30f
#define NFEAT 16
#define CHUNK_PRIMS 512

struct Table {
  const float* coeff;   // [16, G, cols]
  const float* bounds;  // [cols / 512, 6] chunk AABBs (min xyz, max xyz)
  int cols;
  int count;
};

__device__ __forceinline__ float dot16(const float* __restrict__ f,
                                       const float* __restrict__ c,
                                       int stride) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < NFEAT; ++k) acc = fmaf(f[k], __ldg(c + k * stride), acc);
  return acc;
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

__device__ __forceinline__ float safe_inv(float v) {
  return 1.0f / (fabsf(v) < 1e-30f ? 1e-30f : v);
}

// Epilogues: the reference's sphere_candidate_t_mm, triangle_candidate_t_mm
// and box_candidate_t_mm for one (ray, primitive) pair.
__device__ __forceinline__ float sphere_epi(float h, float c, float a,
                                            float tmin, float tmax) {
  // One fused multiply-add, as the reference compiles it: h*h and a*c
  // nearly cancel for the r=1000 ground sphere.
  float disc = fmaf(h, h, -(a * c));
  float sq = safe_sqrt(disc);
  float inv_a = 1.0f / a;
  float root0 = (h - sq) * inv_a;
  float root1 = (h + sq) * inv_a;
  bool ok0 = (root0 > tmin) && (root0 < tmax);
  bool ok1 = (root1 > tmin) && (root1 < tmax);
  float root = ok0 ? root0 : root1;
  return (disc >= 0.0f && (ok0 || ok1)) ? root : T_MAX_F;
}

__device__ __forceinline__ float tri_epi(float det, float un, float vn,
                                         float tn, float tmin, float tmax) {
  bool near_zero = fabsf(det) < 1e-12f;
  float inv_det = 1.0f / (near_zero ? 1.0f : det);
  float u = un * inv_det;
  float v = vn * inv_det;
  float t = tn * inv_det;
  bool valid = !near_zero && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f &&
               t > tmin && t < tmax;
  return valid ? t : T_MAX_F;
}

__device__ __forceinline__ float box_epi(const float* dl, const float* ol,
                                         float tmin, float tmax) {
  float tn = -CUDART_INF_F, tf = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float inv = safe_inv(dl[k]);
    float a0 = (-1.0f - ol[k]) * inv;
    float a1 = (1.0f - ol[k]) * inv;
    tn = fmaxf(tn, fminf(a0, a1));
    tf = fminf(tf, fmaxf(a0, a1));
  }
  float t = tn > tmin ? tn : tf;
  bool valid = tn < tf && t > tmin && t < tmax;
  return valid ? t : T_MAX_F;
}

// Ray features [d, o, o x d, o.d, |o|^2, 1, |d|^2, 0, 0, 0], with the
// products fused into the sums as the plain version (ops/intersect.py
// ray_features) and the reference's compiler fuse them.
__device__ __forceinline__ void ray_features(const float o[3], const float d[3],
                                             float f[NFEAT]) {
  f[0] = d[0]; f[1] = d[1]; f[2] = d[2];
  f[3] = o[0]; f[4] = o[1]; f[5] = o[2];
  f[6] = fmaf(o[1], d[2], -(o[2] * d[1]));
  f[7] = fmaf(o[2], d[0], -(o[0] * d[2]));
  f[8] = fmaf(o[0], d[1], -(o[1] * d[0]));
  f[9] = fmaf(o[2], d[2], fmaf(o[0], d[0], o[1] * d[1]));
  f[10] = fmaf(o[2], o[2], fmaf(o[0], o[0], o[1] * o[1]));
  f[11] = 1.0f;
  f[12] = fmaf(d[2], d[2], fmaf(d[0], d[0], d[1] * d[1]));
  f[13] = 0.0f; f[14] = 0.0f; f[15] = 0.0f;
}

// Whether this ray can reach the chunk's AABB before best_t (aabb.hpp:44-66);
// inverted (empty) boxes never pass.
__device__ __forceinline__ bool chunk_reachable(const float* b, const float o[3],
                                                const float inv_d[3],
                                                float best_t) {
  float lo[3] = {__ldg(b + 0), __ldg(b + 1), __ldg(b + 2)};
  float hi[3] = {__ldg(b + 3), __ldg(b + 4), __ldg(b + 5)};
  if (!(lo[0] <= hi[0])) return false;
  float tn = -CUDART_INF_F, tf = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t0 = (lo[k] - o[k]) * inv_d[k];
    float t1 = (hi[k] - o[k]) * inv_d[k];
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  return tn <= tf && tf > 0.0f && tn < best_t;
}

template <int G>
__device__ __forceinline__ void scan_table(const Table& tab, int ptype,
                                           const float f[NFEAT], float tmin,
                                           const float o[3],
                                           const float inv_d[3], bool lane_ok,
                                           float& best_t, int& best_idx,
                                           int& best_type) {
  const int stride = G * tab.cols;  // feature stride in the table
  const float a = f[12];
  for (int c0 = 0; c0 < tab.count; c0 += CHUNK_PRIMS) {
    bool reach = lane_ok &&
                 chunk_reachable(tab.bounds + 6 * (c0 / CHUNK_PRIMS), o, inv_d,
                                 best_t);
    if (!__any_sync(0xffffffffu, reach)) continue;
    int end = min(c0 + CHUNK_PRIMS, tab.count);
    for (int j = c0; j < end; ++j) {
      float y[G];
#pragma unroll
      for (int g = 0; g < G; ++g) y[g] = dot16(f, tab.coeff + g * tab.cols + j, stride);
      float t;
      if constexpr (G == 2) {
        t = sphere_epi(y[0], y[1], a, tmin, best_t);
      } else if constexpr (G == 4) {
        t = tri_epi(y[0], y[1], y[2], y[3], tmin, best_t);
      } else {
        t = box_epi(y, y + 3, tmin, best_t);
      }
      if (t < best_t) {
        best_t = t;
        best_idx = j;
        best_type = ptype;
      }
    }
  }
}
