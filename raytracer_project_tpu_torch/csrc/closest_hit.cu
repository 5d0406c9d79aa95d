// K1, closest hit (replaces the Pallas kernel _closest_hit_kernel_od with
// scan_tables and feats_rows_from_od, raytracer_project_tpu/ops/
// pallas_intersect.py:272, :110, :254), entry closest_hit_od; and K4, the
// closest hit over prebuilt features (replaces _closest_hit_kernel,
// pallas_intersect.py:228), entry closest_hit_feats.
//
// One thread per ray. K1 builds the 16 ray features in registers, K4 loads
// them from f32[16, N] rows (thread i reads column i of each row, so a
// warp's loads coalesce). The sphere, triangle and box coefficient tables
// ([16, G, C_pad] f32, feature-major) are scanned in index order, one primitive at a time, with
// a strict `<` against the running best: the first minimal index wins
// within a 512-wide chunk, the earlier chunk or table on ties -- the
// reference's order. Rows past each table's count are never read.
//
// Bound on the H100: f32 operations (unculled on the showcase tables, about
// 40k FLOP of dots over the nonzero coefficients and 29k of epilogues per
// ray, against 36 B of traffic for K1 and 76 B for K4; ops/closest_hit.py). The dots are
// explicit fmaf() chains in f32: tensor cores in TF32 or bf16 would corrupt
// the hit set. Every thread of a warp reads the same coefficient at the
// same time, so the loads are broadcasts served from L1. Each warp skips a
// 512-wide chunk whose AABB none of its rays can reach before its current
// best t (the reference culls per 512-ray block the same way); a skipped
// chunk cannot hold a closer hit, so culling never changes a result.
//
// Both entries share the __device__ function closest_hit_scan.

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

// Closest hit of one ray over the three tables; every thread of the warp
// must call it (lane_ok = false for threads past the last ray).
__device__ void closest_hit_scan(const float f[NFEAT], float tmin,
                                 const Table& sph, const Table& tri,
                                 const Table& box, bool lane_ok, float& best_t,
                                 int& best_idx, int& best_type) {
  const float o[3] = {f[3], f[4], f[5]};
  float inv_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) inv_d[k] = 1.0f / (fabsf(f[k]) < 1e-30f ? 1e-30f : f[k]);
  best_t = T_MAX_F;
  best_idx = 0;
  best_type = 0;
  scan_table<2>(sph, 0, f, tmin, o, inv_d, lane_ok, best_t, best_idx, best_type);
  scan_table<4>(tri, 1, f, tmin, o, inv_d, lane_ok, best_t, best_idx, best_type);
  scan_table<6>(box, 2, f, tmin, o, inv_d, lane_ok, best_t, best_idx, best_type);
}

__global__ void closest_hit_od_kernel(const float* __restrict__ od, int p,
                                      float tmin, Table sph, Table tri,
                                      Table box, float* __restrict__ out_t,
                                      int* __restrict__ out_idx,
                                      int* __restrict__ out_type) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool lane_ok = i < p;
  int ii = lane_ok ? i : p - 1;
  float o[3] = {od[ii], od[p + ii], od[2 * p + ii]};
  float d[3] = {od[3 * p + ii], od[4 * p + ii], od[5 * p + ii]};
  float f[NFEAT];
  ray_features(o, d, f);
  float best_t;
  int best_idx, best_type;
  closest_hit_scan(f, tmin, sph, tri, box, lane_ok, best_t, best_idx, best_type);
  if (lane_ok) {
    out_t[i] = best_t;
    out_idx[i] = best_idx;
    out_type[i] = best_type;
  }
}

__global__ void closest_hit_feats_kernel(const float* __restrict__ feats,
                                         int n, float tmin, Table sph,
                                         Table tri, Table box,
                                         float* __restrict__ out_t,
                                         int* __restrict__ out_idx,
                                         int* __restrict__ out_type) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool lane_ok = i < n;
  int ii = lane_ok ? i : n - 1;
  float f[NFEAT];
#pragma unroll
  for (int k = 0; k < NFEAT; ++k) f[k] = feats[(size_t)k * n + ii];
  float best_t;
  int best_idx, best_type;
  closest_hit_scan(f, tmin, sph, tri, box, lane_ok, best_t, best_idx, best_type);
  if (lane_ok) {
    out_t[i] = best_t;
    out_idx[i] = best_idx;
    out_type[i] = best_type;
  }
}

extern "C" int closest_hit_od(const void* od, int p, float tmin,
                              const void* scoeff, int s_cols,
                              const void* sbounds, int n_s,
                              const void* tcoeff, int t_cols,
                              const void* tbounds, int n_t,
                              const void* bcoeff, int b_cols,
                              const void* bbounds, int n_b, void* out_t,
                              void* out_idx, void* out_type, void* stream) {
  Table sph{(const float*)scoeff, (const float*)sbounds, s_cols, n_s};
  Table tri{(const float*)tcoeff, (const float*)tbounds, t_cols, n_t};
  Table box{(const float*)bcoeff, (const float*)bbounds, b_cols, n_b};
  const int block = 128;
  int grid = (p + block - 1) / block;
  if (grid > 0) {
    closest_hit_od_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)od, p, tmin, sph, tri, box, (float*)out_t,
        (int*)out_idx, (int*)out_type);
  }
  return (int)cudaGetLastError();
}

extern "C" int closest_hit_feats(const void* feats, int n, float tmin,
                                 const void* scoeff, int s_cols,
                                 const void* sbounds, int n_s,
                                 const void* tcoeff, int t_cols,
                                 const void* tbounds, int n_t,
                                 const void* bcoeff, int b_cols,
                                 const void* bbounds, int n_b, void* out_t,
                                 void* out_idx, void* out_type, void* stream) {
  Table sph{(const float*)scoeff, (const float*)sbounds, s_cols, n_s};
  Table tri{(const float*)tcoeff, (const float*)tbounds, t_cols, n_t};
  Table box{(const float*)bcoeff, (const float*)bbounds, b_cols, n_b};
  const int block = 128;
  int grid = (n + block - 1) / block;
  if (grid > 0) {
    closest_hit_feats_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)feats, n, tmin, sph, tri, box, (float*)out_t,
        (int*)out_idx, (int*)out_type);
  }
  return (int)cudaGetLastError();
}
