// The closest hit over a threaded BVH (entry bvh_closest_hit), the fused
// pool's closest hit for scenes of BVH_MIN_PRIMS primitives or more. It
// replaces no TPU kernel: the JAX package walks its BVH with XLA ops
// (raytracer_project_tpu/ops/traverse.py, no pallas_call), and the port's
// plain twin is ops/traverse.py intersect_flat. It was added because K1's
// tile scan (csrc/closest_hit.cu) tests every ray against every 128-row
// tile's box and runs the epilogues of every tile it keeps, so its work per
// ray grows with the scene: 1.44-1.54 ms a launch on the funnel's 25,090
// primitives, 4.5x the showcase's time (PERF.md).
//
// What it computes is K1's answer. Each thread holds one ray (od f32[6, n])
// and walks ops/bvh.py's flat tree in its threaded order: on a box hit from
// node i to i + 1, otherwise to escape[i] (-1 ends the walk). The box test
// is the slab test against [tmin, best t so far] with the inverse direction
// clamped at 1e-20 (ops/traverse.py). A leaf's slots name (type, row) of
// K1's compact rows (ScanTables.rows), and each is tested with K1's own
// dots and epilogues (csrc/closest_hit_sparse.cuh row_outputs,
// sphere_epi_inv, tri_epi, box_epi) on K1's ray features, so a primitive
// that both kernels find has the same t, bit for bit. Ties on t go to
// K1's winner whatever the visiting order: the earlier type (sphere,
// triangle, box), then the lower row. To see a tie the epilogues take
// tmax one ulp above the best t (their value does not depend on tmax, only
// whether they keep it), and the box test keeps a node its ray enters at
// exactly the best t. The node boxes are padded when they are packed
// (ops/bvh.py kernel_records), so the rounding of the slab test never
// drops a primitive that the epilogue would hit.
//
// Bound on the H100: latency of dependent loads. A ray reads one 32-byte
// node record a step and, at a leaf, one compact row per slot (48, 80 or
// 96 bytes) at addresses that no other ray of the warp shares once paths
// part; the epilogues are K1's (15, 12 and 35 operations). The algorithmic
// traffic is K1's, 36 B a ray and the geometry once (benchmark/roofline).
// What the design does about it: node records are two aligned float4s
// (bounds, escape, first and count) read through the read-only path, one
// 16-byte load each half; the compact rows are read as float4s the same
// way; the walk needs no stack, so a thread's state is one node index and
// its running best, and many warps stay resident to hide the loads. A
// near-first stack order or a wider tree would visit fewer nodes; that is
// later work.

#include "closest_hit_sparse.cuh"

#define BVH_THREADS 128
// A leaf's word: (first slot << LEAF_SHIFT) | count; 0 for an inner node.
#define LEAF_SHIFT 8
#define LEAF_COUNT_MASK 0xff

// The compact row `row` of a table with G outputs against the thread's ray,
// under K1's tie rule.
template <int G>
__device__ __forceinline__ void test_row(const float4* __restrict__ rows,
                                         int row, int ptype, float tmin,
                                         ScanRay& ray) {
  constexpr int W4 = row_f4<G>();
  float c[4 * W4];
  const float4* src = rows + (size_t)row * W4;
#pragma unroll
  for (int q = 0; q < W4; ++q) {
    const float4 v = __ldg(src + q);
    c[4 * q] = v.x;
    c[4 * q + 1] = v.y;
    c[4 * q + 2] = v.z;
    c[4 * q + 3] = v.w;
  }
  float y[G];
  row_outputs<G, SCAN_FULL>(c, ray.f, row, 0, y);
  const float tmax = nextafterf(ray.best_t, CUDART_INF_F);
  float t;
  if constexpr (G == 2) {
    t = sphere_epi_inv(y[0], y[1], ray.f[12], ray.inv_a, tmin, tmax);
  } else if constexpr (G == 4) {
    t = tri_epi(y[0], y[1], y[2], y[3], tmin, tmax);
  } else {
    t = box_epi(y, y + 3, tmin, tmax);
  }
  const bool tie = t == ray.best_t && t < T_MAX_F &&
                   (ptype < ray.best_type ||
                    (ptype == ray.best_type && row < ray.best_idx));
  if (t < ray.best_t || tie) {
    ray.best_t = t;
    ray.best_idx = row;
    ray.best_type = ptype;
  }
}

// nodes: [NN] pairs of float4 (min xyz, escape as int bits), (max xyz, leaf
// word as int bits); slots: [P] (row << 2) | type; the three tables'
// compact rows.
__global__ void __launch_bounds__(BVH_THREADS)
    bvh_hit_kernel(const float* __restrict__ od, int n, float tmin,
                   const float4* __restrict__ nodes,
                   const int* __restrict__ slots,
                   const float4* __restrict__ srows,
                   const float4* __restrict__ trows,
                   const float4* __restrict__ brows, float* __restrict__ out_t,
                   int* __restrict__ out_idx, int* __restrict__ out_type) {
  const int i = blockIdx.x * BVH_THREADS + threadIdx.x;
  if (i >= n) return;
  const float o[3] = {od[i], od[n + i], od[2 * n + i]};
  const float d[3] = {od[3 * n + i], od[4 * n + i], od[5 * n + i]};
  ScanRay ray;
  {
    float f[NFEAT];
    ray_features(o, d, f);
#pragma unroll
    for (int k = 0; k < SCAN_FEATS; ++k) ray.f[k] = f[k];
  }
  ray.inv_a = 1.0f / ray.f[12];
  ray.ok = true;
  ray.best_t = T_MAX_F;
  ray.best_idx = 0;
  ray.best_type = 0;
  float inv_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dk = fabsf(d[k]) < 1e-20f ? (d[k] < 0.0f ? -1e-20f : 1e-20f)
                                          : d[k];
    inv_d[k] = 1.0f / dk;
  }

  int node = 0;
  while (node >= 0) {
    const float4 lo = __ldg(nodes + 2 * node);
    const float4 hi = __ldg(nodes + 2 * node + 1);
    const float x0 = (lo.x - o[0]) * inv_d[0], x1 = (hi.x - o[0]) * inv_d[0];
    const float y0 = (lo.y - o[1]) * inv_d[1], y1 = (hi.y - o[1]) * inv_d[1];
    const float z0 = (lo.z - o[2]) * inv_d[2], z1 = (hi.z - o[2]) * inv_d[2];
    const float tn = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)),
                           fmaxf(fminf(z0, z1), tmin));
    const float tf = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)),
                           fminf(fmaxf(z0, z1), ray.best_t));
    const bool hit = tn <= tf;
    const int word = __float_as_int(hi.w);
    if (hit && word != 0) {
      const int first = word >> LEAF_SHIFT;
      const int end = first + (word & LEAF_COUNT_MASK);
      for (int s = first; s < end; ++s) {
        const int ref = __ldg(slots + s);
        const int ptype = ref & 3;
        const int row = ref >> 2;
        if (ptype == 0) {
          test_row<2>(srows, row, 0, tmin, ray);
        } else if (ptype == 1) {
          test_row<4>(trows, row, 1, tmin, ray);
        } else {
          test_row<6>(brows, row, 2, tmin, ray);
        }
      }
    }
    node = (hit && word == 0) ? node + 1 : __float_as_int(lo.w);
  }
  out_t[i] = ray.best_t;
  out_idx[i] = ray.best_idx;
  out_type[i] = ray.best_type;
}

extern "C" int bvh_closest_hit(const void* od, int n, float tmin,
                               const void* nodes, const void* slots,
                               const void* srows, const void* trows,
                               const void* brows, void* out_t, void* out_idx,
                               void* out_type, void* stream) {
  const int grid = (n + BVH_THREADS - 1) / BVH_THREADS;
  if (grid > 0) {
    bvh_hit_kernel<<<grid, BVH_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)od, n, tmin, (const float4*)nodes, (const int*)slots,
        (const float4*)srows, (const float4*)trows, (const float4*)brows,
        (float*)out_t, (int*)out_idx, (int*)out_type);
  }
  return (int)cudaGetLastError();
}
