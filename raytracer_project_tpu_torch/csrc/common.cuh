// Per-lane f32 helpers shared by decode.cu and shade_advance.cu. Each one
// repeats, operation for operation, the PyTorch expression of the plain
// versions (core/soa.py, core/vecmath.py), so that a kernel compiled with
// --fmad=false rounds as they do.
#pragma once

#include <cuda_runtime.h>

#define PI_F 3.14159274f        // f32(pi)
#define HALF_PI_F 1.57079637f   // f32(pi / 2)
#define TWO_PI_F 6.28318548f    // f32(2 pi)
#define T_MAX_F 1e30f

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
// s * a + b
__device__ __forceinline__ V3 axpy(float s, V3 a, V3 b) {
  return v3(s * a.x + b.x, s * a.y + b.y, s * a.z + b.z);
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

// Safe unit vector, 0 for |a|^2 < 1e-24 (core/soa.normalize).
__device__ __forceinline__ V3 normalize(V3 a) {
  float l2 = dot(a, a);
  const float eps2 = 1e-24f;
  float inv = l2 < eps2 ? 0.0f : 1.0f / sqrtf(fmaxf(l2, eps2));
  return scale(a, inv);
}

__device__ __forceinline__ float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Polynomial arctan2 / arccos of the reference (core/vecmath.py:114-139).
__device__ __forceinline__ float atan2_poly(float y, float x) {
  float ax = fabsf(x), ay = fabsf(y);
  float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  float z = lo / fmaxf(hi, 1e-30f);
  float z2 = z * z;
  float a = z * (0.99997726f + z2 * (-0.33262347f + z2 * (0.19354346f +
                 z2 * (-0.11643287f + z2 * (0.05265332f + z2 * -0.01172120f)))));
  a = ay > ax ? HALF_PI_F - a : a;
  a = x < 0.0f ? PI_F - a : a;
  return y < 0.0f ? -a : a;
}

__device__ __forceinline__ float acos_poly(float x) {
  float xc = clampf(x, -1.0f, 1.0f);
  float s = sqrtf(fmaxf(1.0f - xc * xc, 0.0f));
  return atan2_poly(s, xc);
}
