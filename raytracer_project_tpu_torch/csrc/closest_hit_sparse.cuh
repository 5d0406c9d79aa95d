// Device code of the compact-row closest-hit scan (K1 and K4,
// csrc/closest_hit.cu): the structural slot lists, the sparse fmaf dots,
// the asynchronous tile copies and the tile scan, one ray per thread.
// The epilogues, ray features and AABB test are those of closest_hit.cuh.
#pragma once

#include "closest_hit.cuh"

#define SCAN_THREADS 128
// Features the scan reads: 13-15 multiply structural zeros only.
#define SCAN_FEATS 13
// Rows staged at a time, and the width of the tile AABBs the block culls
// with: the tables' own fine AABBs (ops/closest_hit.py SCAN_TILE).
#define SCAN_TILE 128
// float4s in the widest compact row (a box's 24 floats).
#define MAX_ROW_F4 6
#define RING_STAGES 2

// Feature slots k of each output's structural nonzeros, ascending
// (ops/closest_hit.py SLOTS). A compact row holds them output after
// output; the offsets below are where each output's run starts.
template <int... K>
struct Slots {};
using SphereH = Slots<0, 1, 2, 9>;          // row floats 0-3
using SphereC = Slots<3, 4, 5, 10, 11>;     // 4-8
using TriDet = Slots<0, 1, 2>;              // 0-2
using TriUV = Slots<0, 1, 2, 6, 7, 8>;      // u_num 3-8, v_num 9-14
using TriT = Slots<3, 4, 5, 11>;            // 15-18
using BoxDl = Slots<0, 1, 2>;               // dl x, y, z: 0-2, 3-5, 6-8
using BoxOl = Slots<3, 4, 5, 11>;           // ol x, y, z: 9-12, 13-16, 17-20

// float4s per compact row of a table with G outputs (ROW_WIDTHS / 4).
template <int G>
__host__ __device__ constexpr int row_f4() {
  return G == 2 ? 3 : (G == 4 ? 5 : 6);
}

struct Rows {
  const float4* rows;   // [count, row_f4<G>] compact rows
  const float* bounds;  // [tiles, 6] AABB of each SCAN_TILE-row tile
  int count;
};

// sum_k f[k] * c[OFF + q] over the slots in order, one fmaf each from +0:
// the dense 16-term chain's value whenever the skipped coefficients are 0
// and the features finite.
template <int OFF, int... K>
__device__ __forceinline__ float sparse_dot(const float* f, const float* c,
                                            Slots<K...>) {
  float acc = 0.0f;
  int q = OFF;
  ((acc = fmaf(f[K], c[q++], acc)), ...);
  return acc;
}

// sphere_epi with 1 / a computed once per ray (the same value).
__device__ __forceinline__ float sphere_epi_inv(float h, float c, float a,
                                                float inv_a, float tmin,
                                                float tmax) {
  float disc = fmaf(h, h, -(a * c));
  float sq = safe_sqrt(disc);
  float root0 = (h - sq) * inv_a;
  float root1 = (h + sq) * inv_a;
  bool ok0 = (root0 > tmin) && (root0 < tmax);
  bool ok1 = (root1 > tmin) && (root1 < tmax);
  float root = ok0 ? root0 : root1;
  return (disc >= 0.0f && (ok0 || ok1)) ? root : T_MAX_F;
}

// The ray a thread holds: features 0-12, 1 / |d|^2, whether the lane is
// real, and its running best.
struct ScanRay {
  float f[SCAN_FEATS];
  float inv_a;
  bool ok;
  float best_t;
  int best_idx;
  int best_type;
};

// Whether the thread's ray is real and reaches the AABB b before its best t.
__device__ __forceinline__ bool reaches(const float* b, const ScanRay& ray) {
  const float o[3] = {ray.f[3], ray.f[4], ray.f[5]};
  float inv_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) inv_d[k] = safe_inv(ray.f[k]);
  return ray.ok && chunk_reachable(b, o, inv_d, ray.best_t);
}

// One compact row c (primitive j of type ptype) against the thread's ray.
template <int G>
__device__ __forceinline__ void eval_row(const float* c, int j, int ptype,
                                         float tmin, ScanRay& ray) {
  const float* f = ray.f;
  float t;
  if constexpr (G == 2) {
    t = sphere_epi_inv(sparse_dot<0>(f, c, SphereH{}),
                       sparse_dot<4>(f, c, SphereC{}), f[12], ray.inv_a, tmin,
                       ray.best_t);
  } else if constexpr (G == 4) {
    t = tri_epi(sparse_dot<0>(f, c, TriDet{}), sparse_dot<3>(f, c, TriUV{}),
                sparse_dot<9>(f, c, TriUV{}), sparse_dot<15>(f, c, TriT{}),
                tmin, ray.best_t);
  } else {
    const float dl[3] = {sparse_dot<0>(f, c, BoxDl{}),
                         sparse_dot<3>(f, c, BoxDl{}),
                         sparse_dot<6>(f, c, BoxDl{})};
    const float ol[3] = {sparse_dot<9>(f, c, BoxOl{}),
                         sparse_dot<13>(f, c, BoxOl{}),
                         sparse_dot<17>(f, c, BoxOl{})};
    t = box_epi(dl, ol, tmin, ray.best_t);
  }
  if (t < ray.best_t) {
    ray.best_t = t;
    ray.best_idx = j;
    ray.best_type = ptype;
  }
}

// The n_rows staged rows of a tile (first primitive j0), in index order;
// each row is read as float4 broadcasts from shared memory.
template <int G>
__device__ __forceinline__ void scan_tile(const float4* __restrict__ tile_rows,
                                          int n_rows, int j0, int ptype,
                                          float tmin, ScanRay& ray) {
  constexpr int W4 = row_f4<G>();
#pragma unroll 1
  for (int j = 0; j < n_rows; ++j) {
    float c[4 * W4];
#pragma unroll
    for (int q = 0; q < W4; ++q) {
      float4 v = tile_rows[j * W4 + q];
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
    eval_row<G>(c, j0 + j, ptype, tmin, ray);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
