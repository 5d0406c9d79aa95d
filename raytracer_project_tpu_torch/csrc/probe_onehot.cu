// P2 and P4, the one-hot row-fetch probes (replace the Pallas kernels
// `kernel` of tools/probe_onehot.py:22, call :47, and of
// tools/probe_onehot2.py:52 and :71, call :93). Entry probe_onehot, one
// kernel onehot_kernel<PLAIN, TRANSPOSED, MATRIX>: for every lane i,
//
//   out_k[i] = table[int(idx[i]), k % 28] + t[i]     (k < n_out)
//
// with idx an f32 truncated to i32 and 0 fetched for a row outside
// [0, n_rows) (a one-hot row that matches no table row). The flags are the
// layouts P4 compares: the table as [n_rows, 28] or TRANSPOSED [28, n_rows];
// the outputs as n_out separate vectors or one MATRIX [n_out, p]; PLAIN
// writes t + k and fetches nothing. P2 is P4's `col` layout
// (<false, false, false>).
//
// The reference fetches with windowed one-hot matmuls on the MXU, whose
// window bounds the one-hot transient; here a fetch is one indexed load of
// the f32 entry, exact, so the window changes nothing and is not passed.
// The output vectors' pointers travel by value in the kernel's parameter
// block (at most MAX_OUT of them), so a launch copies nothing to the card.
//
// Bound on the H100: bytes. Per lane t and idx in (8 B; 4 B for PLAIN) and
// n_out f32 out; the table (172 KB at 1,536 rows) is read once.

#include <cuda_runtime.h>

#define COLS 28
#define MAX_OUT 32

struct OutPtrs {
  float* p[MAX_OUT];
};

template <bool PLAIN, bool TRANSPOSED, bool MATRIX>
__global__ void onehot_kernel(const float* __restrict__ t,
                              const float* __restrict__ idx,
                              const float* __restrict__ table, int n_rows,
                              int n_out, OutPtrs outs,
                              float* __restrict__ out_mat, int p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  float ti = t[i];
  int row = 0;
  bool in_table = false;
  if constexpr (!PLAIN) {
    row = (int)idx[i];  // truncation toward zero, as astype(int32)
    in_table = row >= 0 && row < n_rows;
  }
  for (int k = 0; k < n_out; ++k) {
    float v;
    if constexpr (PLAIN) {
      v = ti + (float)k;
    } else {
      int c = k % COLS;
      float g = 0.0f;
      if (in_table) g = __ldg(TRANSPOSED ? table + c * n_rows + row : table + row * COLS + c);
      v = g + ti;
    }
    if constexpr (MATRIX) {
      out_mat[(size_t)k * p + i] = v;
    } else {
      outs.p[k][i] = v;
    }
  }
}

extern "C" int probe_onehot(int plain, int transposed, int matrix,
                            const void* t, const void* idx, const void* table,
                            int n_rows, int n_out, const void* out_ptrs,
                            void* out_mat, int p, void* stream) {
  if (n_out < 0 || n_out > MAX_OUT) return (int)cudaErrorInvalidValue;
  OutPtrs outs{};
  if (!matrix) {
    for (int k = 0; k < n_out; ++k) outs.p[k] = ((float* const*)out_ptrs)[k];
  }
  const int block = 256;
  int grid = (p + block - 1) / block;
  if (grid == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int flags = (plain ? 4 : 0) | (transposed ? 2 : 0) | (matrix ? 1 : 0);
#define ONEHOT_LAUNCH(P, T, M)                                               \
  onehot_kernel<P, T, M><<<grid, block, 0, s>>>(                             \
      (const float*)t, (const float*)idx, (const float*)table, n_rows, n_out, \
      outs, (float*)out_mat, p)
  switch (flags) {
    case 0: ONEHOT_LAUNCH(false, false, false); break;
    case 1: ONEHOT_LAUNCH(false, false, true); break;
    case 2: ONEHOT_LAUNCH(false, true, false); break;
    case 3: ONEHOT_LAUNCH(false, true, true); break;
    case 4: ONEHOT_LAUNCH(true, false, false); break;
    case 5: ONEHOT_LAUNCH(true, false, true); break;
    default: return (int)cudaErrorInvalidValue;  // PLAIN ignores the table
  }
#undef ONEHOT_LAUNCH
  return (int)cudaGetLastError();
}
