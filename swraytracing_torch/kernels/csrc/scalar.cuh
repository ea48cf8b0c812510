// Scalar helpers shared by the march kernels (march.cuh, march_rays.cu):
// float32/float64 overloads of the math calls, and the floored modulo.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float fmod_(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_(double a, double b) { return fmod(a, b); }
__device__ __forceinline__ float floor_(float a) { return floorf(a); }
__device__ __forceinline__ double floor_(double a) { return floor(a); }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }

// Floored modulo, as torch.remainder and jnp.mod: the result takes the
// sign of n, and can be exactly n for a tiny negative x.
template <typename T>
__device__ __forceinline__ T floored_mod(T x, T n) {
  T r = fmod_(x, n);
  if (r != T(0) && ((r < T(0)) != (n < T(0)))) r += n;
  return r;
}

}  // namespace
