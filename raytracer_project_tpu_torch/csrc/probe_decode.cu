// P3, the decode bisection probe (replaces the Pallas kernel `kernel` of
// main, tools/probe_decode.py:55, call :152): K2 (csrc/decode.cu) cut into
// prefixes, to see what each part of the decode costs. Each stage writes
// 24 f32 rows [24, P] in the reference probe's order:
//
//   0 (d0)  hit, t, then the fetched packed row's columns 0..21;
//   1 (d1)  hit, t, normal, tangent, bitangent, front, u, v, mat (the
//           sphere/triangle/box record of csrc/decode.cuh), then the
//           fetched columns 0..8;
//   2 (d2)  d1's first 15 rows, then material columns 0, 3, 4, the texture
//           metadata columns 0..3 of the material's texture, the texture id
//           and material column 6.
//
// The reference's d3 is K2 itself (decode_launch of csrc/decode.cu). The
// row of a hit is clipped to [0, n_rec - 1] and fetched from the f32
// [n_rec, 28] table, as K2 does.
//
// Bound on the H100: bytes. Per lane d0 reads the hit (12 B) and d1/d2
// also o, d (24 B); every stage writes 24 f32 rows (96 B).
//
// Entry probe_decode_stage, stage_kernel<STAGE>: a lane loads its packed
// row as seven 16 B loads (six for d0) beside its o, d, so the gathers of a
// lane are in flight together, and keeps the row in registers. box_record
// reads three entries of the row at a run-time offset (the dominant axis);
// handed a register array it would make the compiler copy the whole row to
// a stack frame in every lane, so a box lane passes it the row in the
// table instead. The record calls are K2's, built with --fmad=false. The
// lanes are not binned by primitive type: on the H100 the first port's
// stage kernel ran as fast on the probe's hits in pool order as on the
// same hits sorted by type.

#include "decode.cuh"

#define STAGE_BLOCK 128

template <int STAGE>
__global__ void __launch_bounds__(STAGE_BLOCK)
stage_kernel(const float* __restrict__ od, const float* __restrict__ best_t,
             const int* __restrict__ best_idx, const int* __restrict__ best_type,
             int p, const float* __restrict__ rectab, int n_rec,
             const float* __restrict__ mattab, int n_mat,
             const float* __restrict__ texmeta, int n_tex, int n_spheres,
             int n_tris, int has_boxes, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  float t = __ldg(best_t + i);
  int type = __ldg(best_type + i);
  bool hit = t < T_MAX_F;
  int base = type == 1 ? n_spheres : (type == 2 ? n_spheres + n_tris : 0);
  int row = min(max(__ldg(best_idx + i) + base, 0), n_rec - 1);
  const float* grow = rectab + row * PACK_COLS;
  // d0 writes columns 0..21 of the row: six of its seven 16 B pieces.
  constexpr int PIECES = STAGE == 0 ? 6 : PACK_COLS / 4;
  float g[PACK_COLS];
#pragma unroll
  for (int j = 0; j < PIECES; ++j) {
    float4 v = __ldg(reinterpret_cast<const float4*>(grow) + j);
    g[4 * j] = v.x;
    g[4 * j + 1] = v.y;
    g[4 * j + 2] = v.z;
    g[4 * j + 3] = v.w;
  }

  float vals[24];
  vals[0] = hit ? 1.0f : 0.0f;
  vals[1] = t;
  if constexpr (STAGE == 0) {
#pragma unroll
    for (int k = 0; k < 22; ++k) vals[2 + k] = g[k];
  } else {
    V3 o = v3(__ldg(od + i), __ldg(od + p + i), __ldg(od + 2 * p + i));
    V3 d = v3(__ldg(od + 3 * p + i), __ldg(od + 4 * p + i),
              __ldg(od + 5 * p + i));
    float t_safe = hit ? t : 1.0f;
    Record r;
    if (type == 1) {
      r = triangle_record(g, o, d, t_safe);
    } else if (type == 2 && has_boxes) {
      r = box_record(grow, o, d, t_safe);
    } else {
      r = sphere_record(g, o, d, t_safe);
    }
    float rec[13] = {r.normal.x, r.normal.y, r.normal.z,
                     r.tangent.x, r.tangent.y, r.tangent.z,
                     r.bitangent.x, r.bitangent.y, r.bitangent.z,
                     r.front ? 1.0f : 0.0f, r.u, r.v, r.mat};
#pragma unroll
    for (int k = 0; k < 13; ++k) vals[2 + k] = rec[k];
    if constexpr (STAGE == 1) {
#pragma unroll
      for (int k = 0; k < 9; ++k) vals[15 + k] = g[k];
    } else {
      const float* mrow = mattab + 8 * row_index(r.mat, n_mat);
      float tex_id = __ldg(mrow + 5);
      const float* tmeta = texmeta + 10 * row_index(tex_id, n_tex);
      float tail[9] = {__ldg(mrow), __ldg(mrow + 3), __ldg(mrow + 4),
                       __ldg(tmeta), __ldg(tmeta + 1), __ldg(tmeta + 2),
                       __ldg(tmeta + 3), tex_id, __ldg(mrow + 6)};
#pragma unroll
      for (int k = 0; k < 9; ++k) vals[15 + k] = tail[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 24; ++k) out[k * p + i] = vals[k];
}

extern "C" int probe_decode_stage(int stage, const void* od, const void* t,
                                  const void* idx, const void* type, int p,
                                  const void* rectab, int n_rec,
                                  const void* mattab, int n_mat,
                                  const void* texmeta, int n_tex,
                                  int n_spheres, int n_tris, int has_boxes,
                                  void* out, void* stream) {
  int grid = (p + STAGE_BLOCK - 1) / STAGE_BLOCK;
  if (grid == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define STAGE_LAUNCH(S)                                                        \
  stage_kernel<S><<<grid, STAGE_BLOCK, 0, s>>>(                                \
      (const float*)od, (const float*)t, (const int*)idx, (const int*)type, p, \
      (const float*)rectab, n_rec, (const float*)mattab, n_mat,                \
      (const float*)texmeta, n_tex, n_spheres, n_tris, has_boxes, (float*)out)
  switch (stage) {
    case 0: STAGE_LAUNCH(0); break;
    case 1: STAGE_LAUNCH(1); break;
    case 2: STAGE_LAUNCH(2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef STAGE_LAUNCH
  return (int)cudaGetLastError();
}
