// Fused ray march through a frozen gridded flow for Hopper (sm_90a): every
// packet takes all `nsteps` Strang steps (half drift, kick, half drift) in
// one launch.
//
// Replaces the TPU Pallas kernel `_march_kernel` (launched by
// `march_rays_pallas`) of swraytracing_tpu/ops/pallas_ray.py. Its plain
// PyTorch version is `march_rays_reference` in
// swraytracing_torch/ops/march_rays.py (symplectic_step on a GriddedFlow);
// the arithmetic below follows that version operation for operation:
// the cell is floored_mod(x / dx, nx) with a division, the Lagrange
// weights are products over ascending nodes divided by the constant
// denominator, the 2-D weight wx*wy multiplies each stencil value, the
// kick uses the pre-kick position and wavevector for all six fields, and
// omega is recomputed after the kick. Scalars arrive as doubles and are
// rounded to the working type where the plain version rounds them
// (0.5*dt and dt are formed in double first). The two differ by fused
// multiply-adds, by the order of the 36-term stencil sum and, on a CUDA
// tensor, by PyTorch turning a division by a Python scalar (the weights'
// denominators) into a multiplication by its reciprocal.
//
// Design. The TPU kernel holds the six grids in fast memory per block of
// packets, which limits it to grids of about 192^2. Here one thread owns
// one packet and keeps x, k in registers over all steps, so device memory
// sees the packet state once in and once out; the grids (6 MB at 512^2 in
// float32) are read through L1/L2 with __ldg, 36 nodes per step. Packets
// sit anywhere on the grid, so a warp shares few cache lines and the
// number of 32-byte sectors a step touches is what costs. The wrapper
// therefore hands the grids over node-major, (nx, ny, 8) with the six
// fields of a node side by side and two lanes of padding: a node is one
// aligned 32-byte sector in float32 (two in float64) read by 16-byte
// loads, 36 sectors a step, where the field-major (6, nx, ny) layout
// touches about 58 with 216 scalar loads. The last block masks its ragged
// tail (the TPU wrapper pads with dummy packets).
//
// Bound on this card: operations by the count of adds and multiplies,
// since the bytes that must move are only the packet state and the grids
// once. What really holds it is the cache traffic of the stencil reads,
// which that bound does not count.

#include <cuda_runtime.h>
#include <math.h>

#include "scalar.cuh"

namespace {

template <typename T>
struct RayArgs {
  const T* F;   // (nx, ny, NODE): u, v, ux, uy, vx, vy, then padding
  const T* x0;  // (2, Np)
  const T* k0;  // (2, Np)
  T* xo;        // (2, Np)
  T* ko;        // (2, Np)
  long long np;
  int nx, ny;
  double dx, dy, dt, f2, gH;
  int nsteps;
};

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

template <typename T, int ORDER>
__global__ void __launch_bounds__(256) march_rays_kernel(RayArgs<T> A) {
  constexpr int S = 2 * ORDER + 2;
  const long long pkt = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (pkt >= A.np) return;  // ragged last block
  T x0 = A.x0[pkt], x1 = A.x0[A.np + pkt];
  T k0 = A.k0[pkt], k1 = A.k0[A.np + pkt];
  const int nx = A.nx, ny = A.ny;
  const T dx = T(A.dx), dy = T(A.dy);
  const T dt = T(A.dt), hdt = T(0.5 * A.dt);
  const T f2 = T(A.f2), gH = T(A.gH);
  const T* __restrict__ F = A.F;

  for (int step = 0; step < A.nsteps; ++step) {
    // phi1(dt/2): free drift at the group velocity gH k / omega
    T om = sqrt_(f2 + gH * (k0 * k0 + k1 * k1));
    x0 = x0 + hdt * (gH * k0 / om);
    x1 = x1 + hdt * (gH * k1 / om);

    // phi2(dt): flow kick, all six fields at the pre-kick position
    const T xl = floored_mod(x0 / dx, T(nx));
    const T yl = floored_mod(x1 / dy, T(ny));
    const T i0f = floor_(xl), j0f = floor_(yl);
    T wx[S], wy[S];
    lagrange<T, ORDER>(xl - i0f, wx);
    lagrange<T, ORDER>(yl - j0f, wy);
    // floor(mod) can be exactly n (a tiny negative x): the integer wrap
    // below folds it, and the nodes left of 0 and right of n - 1
    const int i0 = int(i0f), j0 = int(j0f);
    long long row[S];
    int col[S];
#pragma unroll
    for (int a = 0; a < S; ++a) {
      row[a] = (long long)wrap_index(i0 + a - ORDER, nx) * ny * NODE;
      col[a] = wrap_index(j0 + a - ORDER, ny) * NODE;
    }
    T acc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int a = 0; a < S; ++a) {
#pragma unroll
      for (int b = 0; b < S; ++b) {
        const T w2 = wx[a] * wy[b];
        T v[6];
        load_node(F + row[a] + col[b], v);
#pragma unroll
        for (int f = 0; f < 6; ++f) acc[f] += v[f] * w2;
      }
    }
    // u, v, ux, uy, vx, vy = acc[0..5]
    const T r0 = acc[2] * k0 + acc[4] * k1;
    const T r1 = acc[3] * k0 + acc[5] * k1;
    x0 = x0 + dt * acc[0];
    x1 = x1 + dt * acc[1];
    k0 = k0 - dt * r0;
    k1 = k1 - dt * r1;

    // phi1(dt/2) with omega of the kicked wavevector
    om = sqrt_(f2 + gH * (k0 * k0 + k1 * k1));
    x0 = x0 + hdt * (gH * k0 / om);
    x1 = x1 + hdt * (gH * k1 / om);
  }
  A.xo[pkt] = x0;
  A.xo[A.np + pkt] = x1;
  A.ko[pkt] = k0;
  A.ko[A.np + pkt] = k1;
}

// order: the stencil half-width, nodes -order..order+1 (1, 2 or 3).
// Returns cudaGetLastError() after the launch, or -1 for a configuration
// with no kernel.
template <typename T>
int launch(const void* F, const void* x0, const void* k0, void* xo, void* ko,
           long long np, int nx, int ny, double dx, double dy, double dt,
           double f2, double gH, int nsteps, int order, int threads,
           void* stream) {
  if (threads < 32 || threads > 256 || threads % 32 || nx < 1 || ny < 1 ||
      nsteps < 0 || np < 0)
    return -1;
  if (np == 0) return 0;
  RayArgs<T> A;
  A.F = (const T*)F;
  A.x0 = (const T*)x0;
  A.k0 = (const T*)k0;
  A.xo = (T*)xo;
  A.ko = (T*)ko;
  A.np = np;
  A.nx = nx;
  A.ny = ny;
  A.dx = dx;
  A.dy = dy;
  A.dt = dt;
  A.f2 = f2;
  A.gH = gH;
  A.nsteps = nsteps;
  const long long blocks = (np + threads - 1) / threads;
  if (blocks > 2147483647LL) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 1:
      march_rays_kernel<T, 1><<<(unsigned)blocks, threads, 0, s>>>(A);
      break;
    case 2:
      march_rays_kernel<T, 2><<<(unsigned)blocks, threads, 0, s>>>(A);
      break;
    case 3:
      march_rays_kernel<T, 3><<<(unsigned)blocks, threads, 0, s>>>(A);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int swr_march_rays_f32(const void* F, const void* x0,
                                  const void* k0, void* xo, void* ko,
                                  long long np, int nx, int ny, double dx,
                                  double dy, double dt, double f2, double gH,
                                  int nsteps, int order, int threads,
                                  void* stream) {
  return launch<float>(F, x0, k0, xo, ko, np, nx, ny, dx, dy, dt, f2, gH,
                       nsteps, order, threads, stream);
}

extern "C" int swr_march_rays_f64(const void* F, const void* x0,
                                  const void* k0, void* xo, void* ko,
                                  long long np, int nx, int ny, double dx,
                                  double dy, double dt, double f2, double gH,
                                  int nsteps, int order, int threads,
                                  void* stream) {
  return launch<double>(F, x0, k0, xo, ko, np, nx, ny, dx, dy, dt, f2, gH,
                        nsteps, order, threads, stream);
}
