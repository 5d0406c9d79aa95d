// P1, the closest-hit ablation probe (replaces the Pallas kernel `kernel` of
// make_kernel, tools/probe_a1_ablate.py:43, call :119): K1's scan with one
// of its three costs taken away, to split K1's time into dots, epilogues
// and culling. Entry probe_a1_ablate, one kernel ablate_kernel<VARIANT>:
//
//   FULL      K1's scan (csrc/closest_hit.cuh): the best t of each ray.
//   CHEAPEPI  every dot computed, t = the raw group-0 dot, no epilogue; the
//             running minimum is still the cull's best t.
//   NODOTS    the epilogues on dot outputs that are zero, made without a
//             coefficient load or an FMA.
//   NOCULL    FULL without the per-warp chunk skip: every chunk is scanned.
//
// Like the reference probe it writes the best t only; idx and type are
// written as 0. One thread per ray, K1's block of 128, the same fmaf dots
// and the same per-warp cull, so FULL's t is bit-equal to K1's.
//
// Each table is scanned up to `count` columns: the tables' counts on the
// card (K1's work), or their padded width C_pad (the reference probe's
// work, which scans the padding of the last chunk).
//
// Keeping the ablated work honest: nvcc would fold NODOTS' epilogue on a
// constant 0 into T_MAX, and drop the G - 1 unused dots of CHEAPEPI. So
// NODOTS' zeros are (j * G + g) & opaque, with `opaque` a launch argument
// that is 0 (two integer operations per output, a value the compiler
// cannot see), and CHEAPEPI sums its unused dots into a sink that is
// stored to idx only when `opaque` is non-zero.
//
// Bound on the H100: f32 operations, as K1 (36 B of traffic per ray).

#include "closest_hit.cuh"

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

extern "C" int probe_a1_ablate(int variant, const void* od, int p, float tmin,
                               const void* scoeff, int s_cols,
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
