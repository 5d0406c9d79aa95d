// K1, closest hit (replaces the Pallas kernel _closest_hit_kernel_od with
// scan_tables and feats_rows_from_od, raytracer_project_tpu/ops/
// pallas_intersect.py:272, :110, :254), entry closest_hit_od; and K4, the
// closest hit over prebuilt features (replaces _closest_hit_kernel,
// pallas_intersect.py:228), entry closest_hit_feats.
//
// Each ray's closest hit over the sphere, triangle and box tables, scanned
// in index order with a strict `<` against the running best: the first
// minimal index wins, the earlier table on ties -- the reference's order.
// Rows past each table's count are never read.
//
// Bound on the H100: f32 operations (unculled on the showcase tables, about
// 40k FLOP of dots over the nonzero coefficients and 29k of epilogues per
// ray, against 36 B of traffic for K1 and 76 B for K4; ops/closest_hit.py).
// What the design does about it:
//   * Structural zeros. build_mm_tables fills fixed feature slots per output:
//     9 of a sphere's 32 coefficients, 19 of a triangle's 64, 21 of a box's
//     96. The kernels read compact rows of those slots only (12, 20 and 24
//     floats, built once per scene by ops/closest_hit.py scan_tables), so
//     the dots do 49 FMAs per sphere, triangle and box where the dense
//     16-term dots do 192. In an fmaf chain that starts at +0 a term with a
//     zero coefficient leaves the sum as it is (acc + (+-0) is acc for a
//     nonzero acc, +0 + (+-0) is +0 under round-to-nearest, and the chain
//     never reaches -0), so the chain over the slots in
//     ascending order equals the dense chain on every finite feature: the
//     new entries equal the dense ones bit for bit on such lanes. On a
//     lane with a non-finite feature they may differ: the dense chain turns
//     NaN through inf * 0, the compact one skips that product
//     (ops/closest_hit.py says what such a lane gets).
//   * A shared-memory ring. A block of 128 threads stages the compact rows
//     SCAN_TILE = 128 primitives at a time (the tables' own fine AABBs)
//     through two stages of 16-byte cp.async copies, 24 KB in all: the next
//     tile that some ray of the block reaches is copied while the warps scan
//     the current one. The rows are read back as float4 broadcasts, one load
//     for every 3-4 FMAs, where the dense scan pays one L1 load per FMA.
//   * One ray per thread. Holding 2 or 4 rays per thread (each row reused
//     for every ray) and staging 256- or 512-row tiles measured slower on
//     the H100 for K1 and K4 (PERF.md): the epilogues, with their IEEE
//     divisions and square roots, are most of what is left, and they gain
//     from more resident warps, not from row reuse.
//   * Culling. A block stages a tile only if some ray of it reaches the
//     tile's AABB before its best t (__syncthreads_or), and each warp skips
//     a staged tile that none of its rays reaches; a skipped tile cannot
//     hold a closer hit, so culling never changes a result.
// No tensor cores: the product is [rays, 16] x [16, G * prims] with K = 16
// and only about a quarter of the coefficients nonzero; at f32 accuracy it
// would need the bf16 digit split (the reference's splitk_dot), six digit
// products per term, 989 TFLOP/s / (3.9 * 6) ~ 42 TFLOP/s of useful work,
// below the 67 TFLOP/s f32 rate the zero-skipping scan can approach; and an
// MMA sums in its own order, so the result would no longer be the fmaf
// chain's, bit for bit.
//
// The dense 16-term scan of the first port (closest_hit_scan, one ray per
// thread, coefficients read through L1, a per-warp cull over 512-wide
// chunks) stays as entries closest_hit_od_dense / closest_hit_feats_dense:
// the yardstick the new entries are held to and timed against.

#include "closest_hit_sparse.cuh"

// --- the compact-row scan ----------------------------------------------------

// 6 blocks of 128 threads per SM (at most 85 registers): left to itself
// ptxas gives the kernel 48 registers and spills.
template <bool FROM_OD>
__global__ void __launch_bounds__(SCAN_THREADS, 6)
    tile_scan_kernel(const float* __restrict__ rays, int n, float tmin,
                     Rows sph, Rows tri, Rows box, float* __restrict__ out_t,
                     int* __restrict__ out_idx, int* __restrict__ out_type) {
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
    for (; g < total; ++g) {
      const int w = which_of(g);
      const float* b = bounds_of(w) + 6 * (g - first_of(w));
      if (__syncthreads_or(reaches(b, ray))) break;
    }
    return g;
  };
  auto stage = [&](int g, int s) {
    const int w = which_of(g);
    const int t0 = (g - first_of(w)) * SCAN_TILE;
    const int w4 = w == 0 ? row_f4<2>() : (w == 1 ? row_f4<4>() : row_f4<6>());
    const int n4 = min(SCAN_TILE, count_of(w) - t0) * w4;
    const float4* src = rows_of(w) + (size_t)t0 * w4;
    float4* dst = ring[s];
    for (int q = tid; q < n4; q += SCAN_THREADS) cp_async16(dst + q, src + q);
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
    if (__any_sync(0xffffffffu, reaches(bounds_of(w) + 6 * k, ray))) {
      const float4* rows = ring[s];
      const int t0 = k * SCAN_TILE;
      const int nr = min(SCAN_TILE, count_of(w) - t0);
      if (w == 0) {
        scan_tile<2>(rows, nr, t0, 0, tmin, ray);
      } else if (w == 1) {
        scan_tile<4>(rows, nr, t0, 1, tmin, ray);
      } else {
        scan_tile<6>(rows, nr, t0, 2, tmin, ray);
      }
    }
    // Every warp is done with stage s before the next tile is copied there.
    __syncthreads();
    cur = nxt;
  }

  if (ray.ok) {
    out_t[i] = ray.best_t;
    out_idx[i] = ray.best_idx;
    out_type[i] = ray.best_type;
  }
}

template <bool FROM_OD>
static int tile_scan(const void* rays, int n, float tmin, const void* srows,
                     const void* sbounds, int n_s, const void* trows,
                     const void* tbounds, int n_t, const void* brows,
                     const void* bbounds, int n_b, void* out_t, void* out_idx,
                     void* out_type, void* stream) {
  Rows sph{(const float4*)srows, (const float*)sbounds, n_s};
  Rows tri{(const float4*)trows, (const float*)tbounds, n_t};
  Rows box{(const float4*)brows, (const float*)bbounds, n_b};
  const int grid = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  if (grid > 0) {
    tile_scan_kernel<FROM_OD><<<grid, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rays, n, tmin, sph, tri, box, (float*)out_t,
        (int*)out_idx, (int*)out_type);
  }
  return (int)cudaGetLastError();
}

// rays: od f32[6, p]; each table's compact rows, SCAN_TILE-row tile AABBs
// and count.
extern "C" int closest_hit_od(const void* od, int p, float tmin,
                              const void* srows, const void* sbounds, int n_s,
                              const void* trows, const void* tbounds, int n_t,
                              const void* brows, const void* bbounds, int n_b,
                              void* out_t, void* out_idx, void* out_type,
                              void* stream) {
  return tile_scan<true>(od, p, tmin, srows, sbounds, n_s, trows, tbounds, n_t,
                         brows, bbounds, n_b, out_t, out_idx, out_type, stream);
}

// As closest_hit_od on features f32[16, n] (rows 0-12 read).
extern "C" int closest_hit_feats(const void* feats, int n, float tmin,
                                 const void* srows, const void* sbounds, int n_s,
                                 const void* trows, const void* tbounds, int n_t,
                                 const void* brows, const void* bbounds, int n_b,
                                 void* out_t, void* out_idx, void* out_type,
                                 void* stream) {
  return tile_scan<false>(feats, n, tmin, srows, sbounds, n_s, trows, tbounds,
                          n_t, brows, bbounds, n_b, out_t, out_idx, out_type,
                          stream);
}

// --- the dense 16-term scan (the yardstick) -----------------------------------

// Closest hit of one ray over the three [16, G, cols] tables; every thread
// of the warp must call it (lane_ok = false for threads past the last ray).
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

__global__ void closest_hit_od_dense_kernel(const float* __restrict__ od, int p,
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

__global__ void closest_hit_feats_dense_kernel(const float* __restrict__ feats,
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

extern "C" int closest_hit_od_dense(const void* od, int p, float tmin,
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
    closest_hit_od_dense_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)od, p, tmin, sph, tri, box, (float*)out_t,
        (int*)out_idx, (int*)out_type);
  }
  return (int)cudaGetLastError();
}

extern "C" int closest_hit_feats_dense(const void* feats, int n, float tmin,
                                       const void* scoeff, int s_cols,
                                       const void* sbounds, int n_s,
                                       const void* tcoeff, int t_cols,
                                       const void* tbounds, int n_t,
                                       const void* bcoeff, int b_cols,
                                       const void* bbounds, int n_b, void* out_t,
                                       void* out_idx, void* out_type,
                                       void* stream) {
  Table sph{(const float*)scoeff, (const float*)sbounds, s_cols, n_s};
  Table tri{(const float*)tcoeff, (const float*)tbounds, t_cols, n_t};
  Table box{(const float*)bcoeff, (const float*)bbounds, b_cols, n_b};
  const int block = 128;
  int grid = (n + block - 1) / block;
  if (grid > 0) {
    closest_hit_feats_dense_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)feats, n, tmin, sph, tri, box, (float*)out_t,
        (int*)out_idx, (int*)out_type);
  }
  return (int)cudaGetLastError();
}
