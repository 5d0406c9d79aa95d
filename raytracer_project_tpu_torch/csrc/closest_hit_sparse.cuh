// Device code of the compact-row closest-hit scan (K1 and K4,
// csrc/closest_hit.cu; P1, csrc/probe_a1_ablate.cu): the structural slot
// lists, the sparse fmaf dots, the asynchronous tile copies and the tile
// scan kernel, one ray per thread, templated on the P1 ablation it runs.
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
// The ring's shared memory: 24 KB a block.
#define RING_BYTES (RING_STAGES * SCAN_TILE * MAX_ROW_F4 * 16)

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

// What the scan runs: K1 and K4 the closest hit (SCAN_FULL); the P1 probe
// (csrc/probe_a1_ablate.cu) each of the four, to split K1's time. Every
// branch on the variant is `if constexpr` or a constant, so SCAN_FULL's
// code is the scan's own.
//   SCAN_FULL      the closest hit: dots, epilogues, the block's and the
//                  warp's cull.
//   SCAN_CHEAPEPI  every structural dot, t = the raw group-0 dot, no
//                  epilogue; the other dots are summed into a sink that
//                  only an `opaque` launch stores, so nvcc keeps them. The
//                  running minimum is still what the culls compare with.
//   SCAN_NODOTS    no row copy, no row load, no FMA: the epilogues run on
//                  zeros the compiler cannot see ((j * G + g) & opaque,
//                  opaque 0 at run time). The culls, an empty cp.async
//                  group per tile with its wait, and both barriers per
//                  tile stay. nvcc drops the unused ring, so its launch
//                  reserves RING_BYTES of dynamic shared memory instead:
//                  every variant holds as many blocks per SM.
//   SCAN_NOCULL    SCAN_FULL staging and scanning every tile: neither the
//                  block's skip in next_tile nor the warp's.
enum ScanVariant {
  SCAN_FULL = 0,
  SCAN_CHEAPEPI = 1,
  SCAN_NODOTS = 2,
  SCAN_NOCULL = 3
};

// The G dot outputs of compact row c (primitive j) for the ray features f.
template <int G, int VARIANT>
__device__ __forceinline__ void row_outputs(const float* c, const float* f,
                                            int j, int opaque, float (&y)[G]) {
  if constexpr (VARIANT == SCAN_NODOTS) {
#pragma unroll
    for (int g = 0; g < G; ++g) y[g] = __int_as_float((j * G + g) & opaque);
  } else if constexpr (G == 2) {
    y[0] = sparse_dot<0>(f, c, SphereH{});
    y[1] = sparse_dot<4>(f, c, SphereC{});
  } else if constexpr (G == 4) {
    y[0] = sparse_dot<0>(f, c, TriDet{});
    y[1] = sparse_dot<3>(f, c, TriUV{});
    y[2] = sparse_dot<9>(f, c, TriUV{});
    y[3] = sparse_dot<15>(f, c, TriT{});
  } else {
    y[0] = sparse_dot<0>(f, c, BoxDl{});
    y[1] = sparse_dot<3>(f, c, BoxDl{});
    y[2] = sparse_dot<6>(f, c, BoxDl{});
    y[3] = sparse_dot<9>(f, c, BoxOl{});
    y[4] = sparse_dot<13>(f, c, BoxOl{});
    y[5] = sparse_dot<17>(f, c, BoxOl{});
  }
}

// One compact row c (primitive j of type ptype) against the thread's ray.
template <int G, int VARIANT>
__device__ __forceinline__ void eval_row(const float* c, int j, int ptype,
                                         float tmin, int opaque, ScanRay& ray,
                                         float& sink) {
  float y[G];
  row_outputs<G, VARIANT>(c, ray.f, j, opaque, y);
  float t;
  if constexpr (VARIANT == SCAN_CHEAPEPI) {
    t = y[0];
#pragma unroll
    for (int g = 1; g < G; ++g) sink += y[g];
  } else if constexpr (G == 2) {
    t = sphere_epi_inv(y[0], y[1], ray.f[12], ray.inv_a, tmin, ray.best_t);
  } else if constexpr (G == 4) {
    t = tri_epi(y[0], y[1], y[2], y[3], tmin, ray.best_t);
  } else {
    t = box_epi(y, y + 3, tmin, ray.best_t);
  }
  if (t < ray.best_t) {
    ray.best_t = t;
    ray.best_idx = j;
    ray.best_type = ptype;
  }
}

// The n_rows staged rows of a tile (first primitive j0), in index order;
// each row is read as float4 broadcasts from shared memory.
template <int G, int VARIANT>
__device__ __forceinline__ void scan_tile(const float4* __restrict__ tile_rows,
                                          int n_rows, int j0, int ptype,
                                          float tmin, int opaque, ScanRay& ray,
                                          float& sink) {
  constexpr int W4 = row_f4<G>();
#pragma unroll 1
  for (int j = 0; j < n_rows; ++j) {
    float c[4 * W4];
    if constexpr (VARIANT != SCAN_NODOTS) {
#pragma unroll
      for (int q = 0; q < W4; ++q) {
        float4 v = tile_rows[j * W4 + q];
        c[4 * q] = v.x;
        c[4 * q + 1] = v.y;
        c[4 * q + 2] = v.z;
        c[4 * q + 3] = v.w;
      }
    }
    eval_row<G, VARIANT>(c, j0 + j, ptype, tmin, opaque, ray, sink);
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

// The compact-row scan of csrc/closest_hit.cu's design notes: one ray per
// thread, SCAN_TILE-row tiles staged through the two-stage ring, a tile
// skipped by the block and by each warp that none of its rays reaches.
// rays: od f32[6, n] (FROM_OD, K1's features formed here) or features
// f32[16, n] (rows 0-12 read). K1 and K4 run <FROM_OD, SCAN_FULL, false>
// with opaque 0. PROBE (P1) stores t and writes idx and type as 0, as the
// reference probe does; `opaque` (0 at run time) keeps the tracked index,
// type and sink alive, so every variant does K1's bookkeeping.
// 6 blocks of 128 threads per SM (at most 85 registers) for every variant:
// left to itself ptxas gives the FULL scan 48 registers and spills.
template <bool FROM_OD, int VARIANT = SCAN_FULL, bool PROBE = false>
__global__ void __launch_bounds__(SCAN_THREADS, 6)
    tile_scan_kernel(const float* __restrict__ rays, int n, float tmin,
                     Rows sph, Rows tri, Rows box, float* __restrict__ out_t,
                     int* __restrict__ out_idx, int* __restrict__ out_type,
                     int opaque) {
  __shared__ float4 ring[RING_STAGES][SCAN_TILE * MAX_ROW_F4];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * SCAN_THREADS + tid;
  ScanRay ray;
  ray.ok = i < n;
  const int ii = ray.ok ? i : n - 1;
  if constexpr (FROM_OD) {
    const float o[3] = {rays[ii], rays[n + ii], rays[2 * n + ii]};
    const float d[3] = {rays[3 * n + ii], rays[4 * n + ii], rays[5 * n + ii]};
    float f[NFEAT];
    ray_features(o, d, f);
#pragma unroll
    for (int k = 0; k < SCAN_FEATS; ++k) ray.f[k] = f[k];
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_FEATS; ++k) ray.f[k] = rays[(size_t)k * n + ii];
  }
  ray.inv_a = 1.0f / ray.f[12];
  ray.best_t = T_MAX_F;
  ray.best_idx = 0;
  ray.best_type = 0;
  float sink = 0.0f;

  // Tiles are numbered through the three tables in scan order.
  const int n0 = (sph.count + SCAN_TILE - 1) / SCAN_TILE;
  const int n1 = (tri.count + SCAN_TILE - 1) / SCAN_TILE;
  const int total = n0 + n1 + (box.count + SCAN_TILE - 1) / SCAN_TILE;
  auto which_of = [&](int g) { return g < n0 ? 0 : (g < n0 + n1 ? 1 : 2); };
  auto first_of = [&](int w) { return w == 0 ? 0 : (w == 1 ? n0 : n0 + n1); };
  auto rows_of = [&](int w) {
    return w == 0 ? sph.rows : (w == 1 ? tri.rows : box.rows);
  };
  auto bounds_of = [&](int w) {
    return w == 0 ? sph.bounds : (w == 1 ? tri.bounds : box.bounds);
  };
  auto count_of = [&](int w) {
    return w == 0 ? sph.count : (w == 1 ? tri.count : box.count);
  };
  // The first tile from g on that some ray of the block reaches (with the
  // best t so far: a later, smaller best t only culls more).
  auto next_tile = [&](int g) {
    if constexpr (VARIANT != SCAN_NOCULL) {
      for (; g < total; ++g) {
        const int w = which_of(g);
        const float* b = bounds_of(w) + 6 * (g - first_of(w));
        if (__syncthreads_or(reaches(b, ray))) break;
      }
    }
    return g;
  };
  auto stage = [&](int g, int s) {
    if constexpr (VARIANT != SCAN_NODOTS) {
      const int w = which_of(g);
      const int t0 = (g - first_of(w)) * SCAN_TILE;
      const int w4 =
          w == 0 ? row_f4<2>() : (w == 1 ? row_f4<4>() : row_f4<6>());
      const int n4 = min(SCAN_TILE, count_of(w) - t0) * w4;
      const float4* src = rows_of(w) + (size_t)t0 * w4;
      float4* dst = ring[s];
      for (int q = tid; q < n4; q += SCAN_THREADS) cp_async16(dst + q, src + q);
    }
    cp_async_commit();
  };

  int cur = next_tile(0);
  if (cur < total) stage(cur, 0);
  for (int s = 0; cur < total; s ^= 1) {
    const int nxt = next_tile(cur + 1);
    if (nxt < total) {
      stage(nxt, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int w = which_of(cur);
    const int k = cur - first_of(w);
    if (VARIANT == SCAN_NOCULL ||
        __any_sync(0xffffffffu, reaches(bounds_of(w) + 6 * k, ray))) {
      const float4* rows = ring[s];
      const int t0 = k * SCAN_TILE;
      const int nr = min(SCAN_TILE, count_of(w) - t0);
      if (w == 0) {
        scan_tile<2, VARIANT>(rows, nr, t0, 0, tmin, opaque, ray, sink);
      } else if (w == 1) {
        scan_tile<4, VARIANT>(rows, nr, t0, 1, tmin, opaque, ray, sink);
      } else {
        scan_tile<6, VARIANT>(rows, nr, t0, 2, tmin, opaque, ray, sink);
      }
    }
    // Every warp is done with stage s before the next tile is copied there.
    __syncthreads();
    cur = nxt;
  }

  if (ray.ok) {
    out_t[i] = ray.best_t;
    if constexpr (PROBE) {
      out_idx[i] = opaque ? ray.best_idx ^ __float_as_int(sink) : 0;
      out_type[i] = opaque ? ray.best_type : 0;
    } else {
      out_idx[i] = ray.best_idx;
      out_type[i] = ray.best_type;
    }
  }
}
