// P2 and P4, the one-hot row-fetch probes (replace the Pallas kernels
// `kernel` of tools/probe_onehot.py:22, call :47, and of
// tools/probe_onehot2.py:52 and :71, call :93). For every lane i,
//
//   out_k[i] = table[int(idx[i]), k % 28] + t[i]     (k < n_out)
//
// with idx an f32 truncated to i32 and 0 fetched for a row outside
// [0, n_rows) (a one-hot row that matches no table row). The layouts P4
// compares: the table as [n_rows, 28] or TRANSPOSED [28, n_rows]; the
// outputs as n_out separate vectors or one MATRIX [n_out, p]; PLAIN writes
// t + k and fetches nothing. P2 is P4's `col` layout.
//
// The reference fetches with windowed one-hot matmuls on the MXU, whose
// window bounds the one-hot transient; here a fetch is an indexed load of
// the f32 entry, exact, so the window changes nothing and is not passed.
// The output vectors' pointers travel by value in the kernel's parameter
// block (at most MAX_OUT of them), so a launch copies nothing to the card.
//
// Bound on the H100: bytes. Per lane t and idx in (8 B; 4 B for PLAIN) and
// n_out f32 out; the table (172 KB at 1,536 rows) is read once.
//
// Entry probe_onehot, fetch_kernel<PLAIN, TRANSPOSED, MATRIX, STAGED>: a
// lane issues every table load before its first store (a row-major row as
// seven 16 B loads, a transposed row as up to 28 scalar loads), and the
// output loop is unrolled to MAX_OUT under k < n_out, so each output's
// pointer is a constant offset into the parameter block and each value a
// register. That leaves the gathers themselves: every lane's rows are
// random, so each SM pulls most of the table through L1 a sector at a time
// (a transposed row costs 24 of them, a row-major one 7). STAGED copies
// the table into shared memory first, with asynchronous 16 B copies all in
// flight at once (a transposed table only the columns read; one block of
// STAGED_BLOCK threads per SM walking the lanes), and gathers from there:
// one copy of the table per SM for every gather through L1. The copy costs
// the same whatever the lanes, so the entry stages once a launch gathers
// enough (STAGE_GATHERS). A bulk copy by the Tensor Memory Accelerator, one
// thread issuing 16 KB pieces on one barrier, was slower; streaming stores
// changed nothing measurable. The wrapper takes the table 16 B aligned.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define COLS 28
#define MAX_OUT 32
#define FETCH_BLOCK 128
#define STAGED_BLOCK 1024
// Auto staging (staged < 0): stage once a launch gathers at least this many
// table pieces (lanes x 16 B loads a row-major row, x columns transposed).
// On the H100 at 700 W with 24 outputs, staging started to pay between
// 65,536 and 131,072 lanes row-major (7 gathers a lane) and between 8,192
// and 32,768 transposed (24 a lane): between 4.6e5 and 7.9e5 in both.
#define STAGE_GATHERS (1 << 19)

struct OutPtrs {
  float* p[MAX_OUT];
};

// 16 B pieces of the table that STAGED copies: a row-major table whole, a
// transposed one its first n_cols rows (rounded up to a piece, which stays
// inside the table: its 28 rows hold whole pieces).
__host__ __device__ __forceinline__ int staged_pieces(bool transposed,
                                                      int n_rows, int n_cols) {
  return transposed ? (n_cols * n_rows + 3) / 4 : n_rows * (COLS / 4);
}

template <bool STAGED, typename T>
__device__ __forceinline__ T load(const T* ptr) {
  if constexpr (STAGED) {
    return *ptr;
  } else {
    return __ldg(ptr);
  }
}

template <bool PLAIN, bool TRANSPOSED, bool MATRIX, bool STAGED>
__global__ void __launch_bounds__(STAGED ? STAGED_BLOCK : FETCH_BLOCK)
fetch_kernel(const float* __restrict__ t, const float* __restrict__ idx,
             const float* __restrict__ table, int n_rows, int n_out,
             const __grid_constant__ OutPtrs outs,
             float* __restrict__ out_mat, int p) {
  extern __shared__ float4 staged[];
  const float* tab = table;
  const int n_cols = min(n_out, COLS);
  if constexpr (STAGED) {
    // Asynchronous 16 B copies, all in flight at once; a transposed table
    // only its first n_cols rows (the columns read).
    const float4* src = reinterpret_cast<const float4*>(table);
    for (int j = threadIdx.x; j < staged_pieces(TRANSPOSED, n_rows, n_cols);
         j += blockDim.x)
      __pipeline_memcpy_async(staged + j, src + j, sizeof(float4));
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    tab = reinterpret_cast<const float*>(staged);
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += gridDim.x * blockDim.x) {
    const float ti = __ldg(t + i);
    float g[COLS];
    if constexpr (!PLAIN) {
      int row = (int)__ldg(idx + i);  // truncation toward zero, as astype(int32)
      bool in_table = row >= 0 && row < n_rows;
      int cols = in_table ? n_cols : 0;
      if constexpr (TRANSPOSED) {
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          g[c] = c < cols ? load<STAGED>(tab + c * n_rows + row) : 0.0f;
      } else {
        const float4* r4 = reinterpret_cast<const float4*>(tab + row * COLS);
#pragma unroll
        for (int j = 0; j < COLS / 4; ++j) {
          float4 v = 4 * j < cols ? load<STAGED>(r4 + j)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          g[4 * j] = v.x;
          g[4 * j + 1] = v.y;
          g[4 * j + 2] = v.z;
          g[4 * j + 3] = v.w;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_OUT; ++k) {
      if (k < n_out) {
        float v;
        if constexpr (PLAIN) {
          v = ti + (float)k;
        } else {
          v = g[k % COLS] + ti;
        }
        if constexpr (MATRIX) {
          out_mat[(size_t)k * p + i] = v;
        } else {
          outs.p[k][i] = v;
        }
      }
    }
  }
}

static int out_ptrs(int matrix, int n_out, const void* ptrs, OutPtrs* outs) {
  if (n_out < 0 || n_out > MAX_OUT) return (int)cudaErrorInvalidValue;
  *outs = OutPtrs{};
  if (!matrix) {
    for (int k = 0; k < n_out; ++k) outs->p[k] = ((float* const*)ptrs)[k];
  }
  return 0;
}

// Whether STAGED's copy of the table fits a block's shared memory.
static bool fits_shared(bool transposed, int n_rows, int n_cols) {
  int dev, smem_max;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return 16LL * staged_pieces(transposed, n_rows, n_cols) <= smem_max;
}

template <bool PLAIN, bool TRANSPOSED, bool MATRIX, bool STAGED>
static int fetch_launch(const float* t, const float* idx, const float* table,
                        int n_rows, int n_out, const OutPtrs& outs,
                        float* out_mat, int p, cudaStream_t s) {
  auto kernel = fetch_kernel<PLAIN, TRANSPOSED, MATRIX, STAGED>;
  if constexpr (STAGED) {
    int n_cols = min(n_out, COLS), dev, sms;
    if (!fits_shared(TRANSPOSED, n_rows, n_cols))
      return (int)cudaErrorInvalidValue;
    size_t smem = (size_t)staged_pieces(TRANSPOSED, n_rows, n_cols) *
                  sizeof(float4);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    int grid = min(sms, (p + STAGED_BLOCK - 1) / STAGED_BLOCK);
    kernel<<<grid, STAGED_BLOCK, smem, s>>>(t, idx, table, n_rows, n_out, outs,
                                             out_mat, p);
  } else {
    kernel<<<(p + FETCH_BLOCK - 1) / FETCH_BLOCK, FETCH_BLOCK, 0, s>>>(
        t, idx, table, n_rows, n_out, outs, out_mat, p);
  }
  return (int)cudaGetLastError();
}

// staged: 0 in place, 1 staged, < 0 staged where the launch gathers at
// least STAGE_GATHERS pieces and the table fits a block's shared memory.
extern "C" int probe_onehot(int plain, int transposed, int matrix, int staged,
                            const void* t, const void* idx, const void* table,
                            int n_rows, int n_out, const void* out_ptrs_,
                            void* out_mat, int p, void* stream) {
  OutPtrs outs;
  int err = out_ptrs(matrix, n_out, out_ptrs_, &outs);
  if (err) return err;
  if (p == 0) return (int)cudaGetLastError();
  if (staged < 0) {
    int n_cols = min(n_out, COLS);
    long long gathers = (long long)p * (transposed ? n_cols : (n_cols + 3) / 4);
    staged = !plain && gathers >= STAGE_GATHERS &&
             fits_shared(transposed, n_rows, n_cols);
  }
  cudaStream_t s = (cudaStream_t)stream;
  int flags = (staged ? 8 : 0) | (plain ? 4 : 0) | (transposed ? 2 : 0) |
              (matrix ? 1 : 0);
#define FETCH_LAUNCH(P, T, M, S)                                              \
  return fetch_launch<P, T, M, S>((const float*)t, (const float*)idx,          \
                                  (const float*)table, n_rows, n_out, outs,    \
                                  (float*)out_mat, p, s)
  switch (flags) {
    case 0: FETCH_LAUNCH(false, false, false, false);
    case 1: FETCH_LAUNCH(false, false, true, false);
    case 2: FETCH_LAUNCH(false, true, false, false);
    case 3: FETCH_LAUNCH(false, true, true, false);
    case 4: FETCH_LAUNCH(true, false, false, false);
    case 5: FETCH_LAUNCH(true, false, true, false);
    case 8: FETCH_LAUNCH(false, false, false, true);
    case 9: FETCH_LAUNCH(false, false, true, true);
    case 10: FETCH_LAUNCH(false, true, false, true);
    case 11: FETCH_LAUNCH(false, true, true, true);
    default: return (int)cudaErrorInvalidValue;  // PLAIN has no table to stage
  }
#undef FETCH_LAUNCH
}
