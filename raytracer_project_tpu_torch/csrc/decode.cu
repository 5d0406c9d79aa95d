// K2, hit-record decode (replaces the Pallas kernel _decode_kernel with
// _onehot_rows, raytracer_project_tpu/ops/fused_step.py:326, :257).
//
// One thread per lane: decode_lane (csrc/decode.cuh) from K1's closest hit
// loads the packed 28-column primitive row, decodes the sphere, triangle
// or box shading record, loads the material row and the texture-metadata
// rows, resolves the checker / solid / missing-cyan base color or the
// image texel row, the bump row with its u/v crossing gates, and the HDR
// equirect row; the kernel writes them as 24 rows of f32 [24, P] in the
// _RO_* order of ops/fused_step.py.
//
// The main path no longer runs this kernel: K3 fused (csrc/shade_advance.cu)
// calls decode_lane in registers. It stays as the P3 probe's d3 and as the
// yardstick K3 fused is timed against.
//
// The reference fetches table rows with one-hot matmuls on the MXU (TPU
// gathers are slow); here every fetch is one direct indexed load, which
// returns the f32 table entry exactly.
//
// Bound on the H100: bytes. Per lane it reads o, d (24 B) and the hit
// (12 B), and writes 24 f32 rows (96 B): 132 B/lane at 3.35 TB/s; the
// tables (a few tens of KB) stay in L1/L2.

#include "decode.cuh"

__global__ void decode_kernel(const float* __restrict__ od,
                              const float* __restrict__ best_t,
                              const int* __restrict__ best_idx,
                              const int* __restrict__ best_type, int p,
                              DecodeTables tb, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  V3 o = v3(od[i], od[p + i], od[2 * p + i]);
  V3 d = v3(od[3 * p + i], od[4 * p + i], od[5 * p + i]);
  Hit h = decode_lane(o, d, best_t[i], best_idx[i], best_type[i], tb);
  float vals[24] = {
      h.hit ? 1.0f : 0.0f, h.t,
      h.normal.x, h.normal.y, h.normal.z,
      h.tangent.x, h.tangent.y, h.tangent.z,
      h.bitangent.x, h.bitangent.y, h.bitangent.z,
      h.front ? 1.0f : 0.0f, h.mtype, h.param, h.bstr,
      h.base[0], h.base[1], h.base[2],
      h.gate_u, h.gate_v, h.has_bump ? 1.0f : 0.0f,
      h.texrow, h.bumprow, h.envrow};
#pragma unroll
  for (int k = 0; k < 24; ++k) out[k * p + i] = vals[k];
}

extern "C" int decode_launch(const void* od, const void* t, const void* idx,
                             const void* type, int p, const void* aparams,
                             const void* rectab, int n_rec, const void* mattab,
                             int n_mat, const void* texmeta, int n_tex,
                             int n_spheres, int n_tris, int has_boxes, float ah,
                             float aw, int has_env, float eh, float ew,
                             void* out, void* stream) {
  const int block = 256;
  int grid = (p + block - 1) / block;
  if (grid > 0) {
    DecodeTables tb{(const float*)aparams, (const float*)rectab,
                    (const float*)mattab, (const float*)texmeta, n_rec, n_mat,
                    n_tex, n_spheres, n_tris, has_boxes, has_env, ah, aw, eh,
                    ew};
    decode_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)od, (const float*)t, (const int*)idx, (const int*)type,
        p, tb, (float*)out);
  }
  return (int)cudaGetLastError();
}
