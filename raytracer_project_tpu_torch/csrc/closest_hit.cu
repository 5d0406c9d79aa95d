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

// --- the compact-row scan (tile_scan_kernel, csrc/closest_hit_sparse.cuh) ---

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
        (int*)out_idx, (int*)out_type, 0);
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
