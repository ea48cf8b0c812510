// Device helpers of the frozen-flow ray marches (march_rays.cu, K4, and
// march_xka.cu): the node-major grid layout, its loads, the integer wrap
// and the Lagrange weights, as both kernels compute them.
//
// The grids arrive node-major, (nx, ny, NODE): the fields of one node side
// by side, one aligned 32-byte sector a node in float32 (two in float64).
// K4 reads six fields (u, v, u_x, u_y, v_x, v_y) and leaves lanes 6 and 7
// as padding; the x-k-a march puts the depth factor H in lane 6.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int NODE = 8;  // elements per grid node in F, 16-byte aligned

// The six fields of one node.
__device__ __forceinline__ void load_node(const float* __restrict__ p,
                                          float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y;
}
__device__ __forceinline__ void load_node(const double* __restrict__ p,
                                          double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  const double2 c = __ldg(reinterpret_cast<const double2*>(p) + 2);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y, v[4] = c.x, v[5] = c.y;
}

// Floored integer modulo (n > 0): C's % truncates toward zero.
__device__ __forceinline__ int wrap_index(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Lagrange basis weights for nodes -ORDER..ORDER+1 at fractional position
// fr: products over ascending j, divided by the constant denominator.
template <typename T, int ORDER>
__device__ __forceinline__ void lagrange(T fr, T* w) {
  constexpr int S = 2 * ORDER + 2;
  T a[S];
#pragma unroll
  for (int j = 0; j < S; ++j) a[j] = fr - T(j - ORDER);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    double denom = 1.0;
    T p = T(0);
    bool first = true;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (j == i) continue;
      denom *= double(i - j);
      p = first ? a[j] : p * a[j];
      first = false;
    }
    w[i] = p / T(denom);
  }
}

// The velocity (lanes 0 and 1) of one node.
__device__ __forceinline__ void load_uv(const float* __restrict__ p,
                                        float* v) {
  const float2 a = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = a.x, v[1] = a.y;
}
__device__ __forceinline__ void load_uv(const double* __restrict__ p,
                                        double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = a.x, v[1] = a.y;
}

// The seven fields (lanes 0..6) of one node.
__device__ __forceinline__ void load_node7(const float* __restrict__ p,
                                           float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y;
  v[6] = b.z;
}
__device__ __forceinline__ void load_node7(const double* __restrict__ p,
                                           double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  const double2 c = __ldg(reinterpret_cast<const double2*>(p) + 2);
  const double2 d = __ldg(reinterpret_cast<const double2*>(p) + 3);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y, v[4] = c.x, v[5] = c.y;
  v[6] = d.x;
}

}  // namespace
