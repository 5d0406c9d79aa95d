// P1, the closest-hit ablation probe (replaces the Pallas kernel `kernel` of
// make_kernel, tools/probe_a1_ablate.py:43, call :119): K1's scan with one
// of its costs taken away, to split K1's time into dots, epilogues and
// culling. Like the reference probe it writes the best t of each ray over
// the sphere, triangle and box tables; idx and type are written as 0.
//
// Entry probe_a1_ablate: K1's own compact-row scan, tile_scan_kernel of
// csrc/closest_hit_sparse.cuh instantiated <from od, VARIANT, probe> for
// the four variants of that header's ScanVariant (full, cheapepi, nodots,
// nocull). `full` is K1's code (the same template, the same 6-block
// launch bounds and 24 KB ring; only the store of idx and type differs,
// and its SASS has K1's instruction count and registers),
// so its t is K1's bit for bit; `nocull` gives the same t. What each
// variant takes away, and how the ablated work is kept honest against
// nvcc (the opaque zeros of nodots, the sink of cheapepi), is written
// there.
//
// Bound on the H100: f32 operations, as K1 (36 B of traffic per ray and
// the compact rows).
//
// Entry probe_a1_ablate_dense: the probe of the first port, on the dense
// 16-term scan of csrc/closest_hit.cuh (one ray per thread, coefficients
// read through L1, a per-warp cull over 512-wide chunks), kept as the
// yardstick the new probe is timed against, as K1 kept
// closest_hit_od_dense. One kernel ablate_kernel<VARIANT>, block 128:
//
//   FULL      the dense scan: the best t of each ray.
//   CHEAPEPI  every dot computed, t = the raw group-0 dot, no epilogue; the
//             running minimum is still the cull's best t.
//   NODOTS    the epilogues on dot outputs that are zero, made without a
//             coefficient load or an FMA.
//   NOCULL    FULL without the per-warp chunk skip: every chunk is scanned.
//
// Each table is scanned up to `count` columns: the tables' counts on the
// card, or their padded width C_pad (the reference probe's work, which
// scans the padding of the last chunk). NODOTS' zeros are
// (j * G + g) & opaque, with `opaque` a launch argument that is 0 (two
// integer operations per output, a value the compiler cannot see), and
// CHEAPEPI sums its unused dots into a sink that is stored to idx only
// when `opaque` is non-zero.

#include "closest_hit_sparse.cuh"

// rays od f32[6, p]; each table's compact rows, SCAN_TILE-row tile AABBs
// and count (K1's closest_hit_od arguments), then the ScanVariant.
extern "C" int probe_a1_ablate(int variant, const void* od, int p, float tmin,
                               const void* srows, const void* sbounds, int n_s,
                               const void* trows, const void* tbounds, int n_t,
                               const void* brows, const void* bbounds, int n_b,
                               int opaque, void* out_t, void* out_idx,
                               void* out_type, void* stream) {
  Rows sph{(const float4*)srows, (const float*)sbounds, n_s};
  Rows tri{(const float4*)trows, (const float*)tbounds, n_t};
  Rows box{(const float4*)brows, (const float*)bbounds, n_b};
  const int grid = (p + SCAN_THREADS - 1) / SCAN_THREADS;
  if (grid == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define SCAN_LAUNCH(V)                                                     \
  tile_scan_kernel<true, V, true>                                          \
      <<<grid, SCAN_THREADS, V == SCAN_NODOTS ? RING_BYTES : 0, s>>>(      \
          (const float*)od, p, tmin, sph, tri, box, (float*)out_t,         \
          (int*)out_idx, (int*)out_type, opaque)
  switch (variant) {
    case SCAN_FULL: SCAN_LAUNCH(SCAN_FULL); break;
    case SCAN_CHEAPEPI: SCAN_LAUNCH(SCAN_CHEAPEPI); break;
    case SCAN_NODOTS: SCAN_LAUNCH(SCAN_NODOTS); break;
    case SCAN_NOCULL: SCAN_LAUNCH(SCAN_NOCULL); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef SCAN_LAUNCH
  return (int)cudaGetLastError();
}

// --- the dense yardstick -----------------------------------------------------

enum { FULL = 0, CHEAPEPI = 1, NODOTS = 2, NOCULL = 3 };

template <int G, int VARIANT>
__device__ __forceinline__ void ablate_table(const Table& tab, const float f[NFEAT],
                                             float tmin, const float o[3],
                                             const float inv_d[3], bool lane_ok,
                                             int opaque, float& best_t,
                                             float& sink) {
  const int stride = G * tab.cols;
  const float a = f[12];
  for (int c0 = 0; c0 < tab.count; c0 += CHUNK_PRIMS) {
    if constexpr (VARIANT != NOCULL) {
      bool reach = lane_ok &&
                   chunk_reachable(tab.bounds + 6 * (c0 / CHUNK_PRIMS), o, inv_d,
                                   best_t);
      if (!__any_sync(0xffffffffu, reach)) continue;
    }
    int end = min(c0 + CHUNK_PRIMS, tab.count);
    for (int j = c0; j < end; ++j) {
      float y[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if constexpr (VARIANT == NODOTS) {
          y[g] = __int_as_float((j * G + g) & opaque);
        } else {
          y[g] = dot16(f, tab.coeff + g * tab.cols + j, stride);
        }
      }
      float t;
      if constexpr (VARIANT == CHEAPEPI) {
        t = y[0];
#pragma unroll
        for (int g = 1; g < G; ++g) sink += y[g];
      } else if constexpr (G == 2) {
        t = sphere_epi(y[0], y[1], a, tmin, best_t);
      } else if constexpr (G == 4) {
        t = tri_epi(y[0], y[1], y[2], y[3], tmin, best_t);
      } else {
        t = box_epi(y, y + 3, tmin, best_t);
      }
      if (t < best_t) best_t = t;
    }
  }
}

template <int VARIANT>
__global__ void ablate_kernel(const float* __restrict__ od, int p, float tmin,
                              Table sph, Table tri, Table box, int opaque,
                              float* __restrict__ out_t,
                              int* __restrict__ out_idx,
                              int* __restrict__ out_type) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool lane_ok = i < p;
  int ii = lane_ok ? i : p - 1;
  float o[3] = {od[ii], od[p + ii], od[2 * p + ii]};
  float d[3] = {od[3 * p + ii], od[4 * p + ii], od[5 * p + ii]};
  float f[NFEAT];
  ray_features(o, d, f);
  const float of[3] = {f[3], f[4], f[5]};
  float inv_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) inv_d[k] = 1.0f / (fabsf(f[k]) < 1e-30f ? 1e-30f : f[k]);
  float best_t = T_MAX_F, sink = 0.0f;
  ablate_table<2, VARIANT>(sph, f, tmin, of, inv_d, lane_ok, opaque, best_t, sink);
  ablate_table<4, VARIANT>(tri, f, tmin, of, inv_d, lane_ok, opaque, best_t, sink);
  ablate_table<6, VARIANT>(box, f, tmin, of, inv_d, lane_ok, opaque, best_t, sink);
  if (lane_ok) {
    out_t[i] = best_t;
    out_idx[i] = opaque ? __float_as_int(sink) : 0;
    out_type[i] = 0;
  }
}

extern "C" int probe_a1_ablate_dense(int variant, const void* od, int p,
                                     float tmin, const void* scoeff, int s_cols,
                                     const void* sbounds, int n_s,
                                     const void* tcoeff, int t_cols,
                                     const void* tbounds, int n_t,
                                     const void* bcoeff, int b_cols,
                                     const void* bbounds, int n_b, int opaque,
                                     void* out_t, void* out_idx, void* out_type,
                                     void* stream) {
  Table sph{(const float*)scoeff, (const float*)sbounds, s_cols, n_s};
  Table tri{(const float*)tcoeff, (const float*)tbounds, t_cols, n_t};
  Table box{(const float*)bcoeff, (const float*)bbounds, b_cols, n_b};
  const int block = 128;
  int grid = (p + block - 1) / block;
  if (grid == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define ABLATE_LAUNCH(V)                                                       \
  ablate_kernel<V><<<grid, block, 0, s>>>((const float*)od, p, tmin, sph, tri, \
                                          box, opaque, (float*)out_t,          \
                                          (int*)out_idx, (int*)out_type)
  switch (variant) {
    case FULL: ABLATE_LAUNCH(FULL); break;
    case CHEAPEPI: ABLATE_LAUNCH(CHEAPEPI); break;
    case NODOTS: ABLATE_LAUNCH(NODOTS); break;
    case NOCULL: ABLATE_LAUNCH(NOCULL); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ABLATE_LAUNCH
  return (int)cudaGetLastError();
}
