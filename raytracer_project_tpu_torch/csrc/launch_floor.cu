// An empty kernel, the floor under the times of the small kernels (the
// P2-P4 probes, K2, K3): the kernel table times it with the same timer
// (tools.time_ms) over the same grid, so a kernel's time less this floor
// is what its work costs. It replaces no TPU kernel and no render path launches it. Entry
// launch_floor: ceil(n / 128) blocks of 128 threads that do nothing.

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int launch_floor(int n, void* stream) {
  const int grid = (n + 127) / 128;
  if (grid > 0) empty_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
