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
