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

#include "closest_hit.cuh"

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
