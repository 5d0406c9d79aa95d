// The closest hit over a BVH (entry bvh_closest_hit), the fused pool's
// closest hit for scenes of BVH_MIN_PRIMS primitives or more. It replaces
// no TPU kernel: the JAX package walks its BVH with XLA ops
// (raytracer_project_tpu/ops/traverse.py, no pallas_call), and the port's
// plain twin is ops/traverse.py intersect_flat. It was added because K1's
// tile scan (csrc/closest_hit.cu) tests every ray against every 128-row
// tile's box and runs the epilogues of every tile it keeps, so its work per
// ray grows with the scene: 1.44-1.54 ms a launch on the funnel's 25,090
// primitives, 4.5x the showcase's time (PERF.md).
//
// What it computes is K1's answer. Each thread holds one ray (od f32[6, n])
// and walks ops/bvh.py's two-box records (kernel_records) near child first,
// the while-while traversal of Aila and Laine ("Understanding the
// Efficiency of Ray Traversal on GPUs", HPG 2009) on a binary tree: an
// inner node's record holds both children's boxes and references (a record
// index, or ~((first slot << LEAF_SHIFT) | count) for a leaf); a visit
// tests both boxes, goes to the child hit nearer (smaller entry t) and
// pushes the other with its entry t onto the thread's stack; with no child
// hit, and after a leaf, it pops, dropping entries whose entry t exceeds the
// best t so far without a load. The box test is the slab test against
// [tmin, best t so far] with the inverse direction clamped at 1e-20
// (ops/traverse.py). A leaf's slots name (type, row) of K1's compact rows
// (ScanTables.rows), and each is tested with K1's own dots and epilogues
// (csrc/closest_hit_sparse.cuh row_outputs, sphere_epi_inv, tri_epi,
// box_epi) on K1's ray features, so a primitive that both kernels find has
// the same t, bit for bit. Ties on t go to K1's winner whatever the
// visiting order: the earlier type (sphere, triangle, box), then the lower
// row. To see a tie the epilogues take tmax one ulp above the best t (their
// value does not depend on tmax, only whether they keep it), and the box
// test and the pop keep a node its ray enters at exactly the best t. The
// boxes are padded when they are packed (ops/bvh.py kernel_records), so the
// rounding of the slab test never drops a primitive that the epilogue would
// hit.
//
// Bound on the H100: latency of dependent loads. A visit reads one 64-byte
// record and, at a leaf, one compact row per slot (48, 80 or 96 bytes) at
// addresses that no other ray of the warp shares once paths part; the
// epilogues are K1's (15, 12 and 35 operations). The algorithmic traffic is
// K1's, 36 B a ray and the geometry once (benchmark/roofline). What the
// design does about it: both children's boxes come in one visit, four
// aligned float4s loaded together through the read-only path; the near
// child first shrinks the best t early, so the box tests and the pops cull
// the far subtrees; leaves are small (ops/bvh.py HIT_LEAF_SIZE), so few
// slots are loaded and tested past the closest hit; the stack is the
// thread's own (local memory, at most one entry per level of the path), so
// many warps stay resident to hide the loads.
//
// The counting walk (counted_walk_kernel, entry bvh_walk_counted) is the
// same loop, which also writes per ray the records visited, the pushes, the
// pops culled by best t and the slots tested; only the tools run it, and
// its name keeps out of the one that the traces read as the closest hit.

#include <climits>

#include "closest_hit_sparse.cuh"

#define BVH_THREADS 128
// A leaf's word: (first slot << LEAF_SHIFT) | count.
#define LEAF_SHIFT 8
#define LEAF_COUNT_MASK 0xff
// Stack entries a thread holds: one per inner level of its path at most
// (ops/bvh.py STACK_MAX; kernel_records refuses deeper trees), and the
// sentinel under them.
#define BVH_STACK 64
// The sentinel's reference: no leaf's (first + count <= 2^23 slots).
#define WALK_DONE INT_MIN

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

// Slots [first, first + count) of a leaf against the thread's ray.
__device__ __forceinline__ void test_leaf(
    int word, const int* __restrict__ slots, const float4* __restrict__ srows,
    const float4* __restrict__ trows, const float4* __restrict__ brows,
    float tmin, ScanRay& ray) {
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

// The slab test of the box (lo.xyz, hi.xyz) against [tmin, best t]: the
// entry t, and whether the ray meets the box there (an entry at exactly the
// best t counts).
__device__ __forceinline__ bool slab(const float4 lo, const float4 hi,
                                     const float (&o)[3],
                                     const float (&inv_d)[3], float tmin,
                                     float best_t, float& tn) {
  const float x0 = (lo.x - o[0]) * inv_d[0], x1 = (hi.x - o[0]) * inv_d[0];
  const float y0 = (lo.y - o[1]) * inv_d[1], y1 = (hi.y - o[1]) * inv_d[1];
  const float z0 = (lo.z - o[2]) * inv_d[2], z1 = (hi.z - o[2]) * inv_d[2];
  tn = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), tmin));
  const float tf = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)),
                         fminf(fmaxf(z0, z1), best_t));
  return tn <= tf;
}

// The walk of ray i. nodes: [NR] records of four float4s: (left min xyz,
// left ref), (left max xyz, right ref), (right min xyz, 0), (right max xyz,
// 0), refs as int bits; record 0 is the root's. slots: [P] (row << 2) |
// type. COUNT: write counts [4, n] (records visited, pushes, pops culled,
// slots tested).
template <bool COUNT>
__device__ __forceinline__ void walk(
    int i, const float* __restrict__ od, int n, float tmin,
    const float4* __restrict__ nodes, const int* __restrict__ slots,
    const float4* __restrict__ srows, const float4* __restrict__ trows,
    const float4* __restrict__ brows, float* __restrict__ out_t,
    int* __restrict__ out_idx, int* __restrict__ out_type,
    int* __restrict__ counts) {
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
  int c[4] = {0, 0, 0, 0};
  // Entries (ref, entry t as int bits), the sentinel at the bottom.
  int2 stack[BVH_STACK + 1];
  stack[0] = make_int2(WALK_DONE, __float_as_int(-CUDART_INF_F));
  int sp = 0;
  // The next entry that its t does not put past the best t.
  auto pop = [&]() {
    int2 e = stack[sp--];
    while (__int_as_float(e.y) > ray.best_t) {
      e = stack[sp--];
      if constexpr (COUNT) ++c[2];
    }
    return e.x;
  };

  int ref = 0;
  while (ref != WALK_DONE) {
    while (ref >= 0) {
      const float4* rec = nodes + 4 * ref;
      const float4 l_lo = __ldg(rec), l_hi = __ldg(rec + 1);
      const float4 r_lo = __ldg(rec + 2), r_hi = __ldg(rec + 3);
      if constexpr (COUNT) ++c[0];
      float tl, tr;
      const bool hl = slab(l_lo, l_hi, o, inv_d, tmin, ray.best_t, tl);
      const bool hr = slab(r_lo, r_hi, o, inv_d, tmin, ray.best_t, tr);
      const int lref = __float_as_int(l_lo.w), rref = __float_as_int(l_hi.w);
      if (hl && hr) {
        const bool right_first = tr < tl;
        ref = right_first ? rref : lref;
        stack[++sp] = right_first ? make_int2(lref, __float_as_int(tl))
                                  : make_int2(rref, __float_as_int(tr));
        if constexpr (COUNT) ++c[1];
      } else if (hl || hr) {
        ref = hl ? lref : rref;
      } else {
        ref = pop();
      }
    }
    if (ref == WALK_DONE) break;
    if constexpr (COUNT) c[3] += ~ref & LEAF_COUNT_MASK;
    test_leaf(~ref, slots, srows, trows, brows, tmin, ray);
    ref = pop();
  }
  out_t[i] = ray.best_t;
  out_idx[i] = ray.best_idx;
  out_type[i] = ray.best_type;
  if constexpr (COUNT) {
#pragma unroll
    for (int k = 0; k < 4; ++k) counts[k * n + i] = c[k];
  }
}

// The fused pool's closest hit.
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
  walk<false>(i, od, n, tmin, nodes, slots, srows, trows, brows, out_t,
              out_idx, out_type, nullptr);
}

// The same walk, counting.
__global__ void __launch_bounds__(BVH_THREADS)
    counted_walk_kernel(const float* __restrict__ od, int n, float tmin,
                        const float4* __restrict__ nodes,
                        const int* __restrict__ slots,
                        const float4* __restrict__ srows,
                        const float4* __restrict__ trows,
                        const float4* __restrict__ brows,
                        float* __restrict__ out_t, int* __restrict__ out_idx,
                        int* __restrict__ out_type, int* __restrict__ counts) {
  const int i = blockIdx.x * BVH_THREADS + threadIdx.x;
  if (i >= n) return;
  walk<true>(i, od, n, tmin, nodes, slots, srows, trows, brows, out_t,
             out_idx, out_type, counts);
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

extern "C" int bvh_walk_counted(const void* od, int n, float tmin,
                                const void* nodes, const void* slots,
                                const void* srows, const void* trows,
                                const void* brows, void* out_t, void* out_idx,
                                void* out_type, void* counts, void* stream) {
  const int grid = (n + BVH_THREADS - 1) / BVH_THREADS;
  if (grid > 0) {
    counted_walk_kernel<<<grid, BVH_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)od, n, tmin, (const float4*)nodes, (const int*)slots,
        (const float4*)srows, (const float4*)trows, (const float4*)brows,
        (float*)out_t, (int*)out_idx, (int*)out_type, (int*)counts);
  }
  return (int)cudaGetLastError();
}
