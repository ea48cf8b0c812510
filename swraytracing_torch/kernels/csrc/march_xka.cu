// Fused x-k-a ray march through a frozen RSW restart frame for Hopper
// (sm_90a): every packet takes `nsteps` steps of the step_packet_xka
// stepper (position, wavevector and wave action, with the depth factor
// H = 1 + eta_g) with its state in registers, in one launch per segment
// of steps, the packets ordered by the cell they stand in. A member of
// the K4 family (march_rays.cu): the same node-major grids, loads, cell,
// Lagrange weights, cell keys and orderings (rays_stencil.cuh).
//
// No TPU kernel computes this step (the JAX package steps it with plain
// array code). Its plain PyTorch version is `march_xka_reference` in
// swraytracing_torch/ops/march_rays.py, nsteps calls of
// models/rays.rk4_xka_step on a GriddedFlow of the six velocity grids and
// the depth grid H; the arithmetic below follows that version operation
// for operation:
//   C = gH H(x) k / sqrt(f^2 + gH H(x) |k|^2), frozen over the step;
//   x: RK4 on dx/dt = U(x) + C, U at x, x + x1/2, x + x2/2, x + x3;
//   at the new position xn: U, grad U and H, then
//   om = sqrt(f^2 + gH H |k|^2), c = gH H k / om,
//   div C = (k f v - l f u - cx^2 - cy^2) / om,
//   grad omega = (f |k|^2 v / (2 om), -f |k|^2 u / (2 om)) (cg_sw.m);
//   k: RK4 on dk/dt = -((grad U)^T k + grad omega), the terms frozen;
//   a: RK4 on da/dt = -a div C.
// Scalars arrive as doubles and are rounded to the working type where the
// plain version rounds them. The two differ by fused multiply-adds, by the
// order of the 36-term stencil sums and, on a CUDA tensor, by PyTorch
// turning a division by a Python scalar into a multiplication by its
// reciprocal.
//
// Evaluations. A step interpolates four times: the velocity alone at the
// three inner stages of the position RK4 (lanes 0 and 1, one 8- or
// 16-byte load a node), and all seven grids at the new position (two or
// four 16-byte loads a node). The velocity and H at the step's own
// position are the previous step's evaluation at its new position, kept
// in registers: a segment's first step evaluates them once, with the same
// seven-grid code, so a packet's arithmetic does not depend on where a
// segment starts, and the segmented, ordered march gives the bits of one
// unordered launch, as K4's does.
//
// Bound on this card: like K4, by the cache lines a warp's stencil loads
// touch (four stencils a step here, one in K4), so the wrapper orders the
// packets by cell before every segment with K4's counting sort, and the
// march reads and writes each packet's x, k and a through that
// permutation.

#include <cuda_runtime.h>
#include <math.h>

#include "rays_stencil.cuh"
#include "scalar.cuh"

namespace {

template <typename T>
struct XkaArgs {
  const T* F;   // (nx, ny, NODE): u, v, ux, uy, vx, vy, H, padding
  const T* x0;  // (2, Np)
  const T* k0;  // (2, Np)
  const T* a0;  // (Np,)
  T* xo;        // (2, Np)
  T* ko;        // (2, Np)
  T* ao;        // (Np,)
  const int* perm;  // (Np,) thread p marches packet perm[p]; null: packet p
  long long np;
  int nx, ny;
  double dx, dy, dt, f, f2, gH;
  int nsteps;
};

// Interpolate NF lanes (2: u, v; 7: all seven grids) of F at (px, py):
// K4's cell, weights and stencil sum, field by field in the same order.
template <typename T, int ORDER, int NF>
__device__ __forceinline__ void eval_at(const T* __restrict__ F, T px, T py,
                                        int nx, int ny, T dx, T dy, T* acc) {
  constexpr int S = 2 * ORDER + 2;
  const T xl = floored_mod(px / dx, T(nx));
  const T yl = floored_mod(py / dy, T(ny));
  const T i0f = floor_(xl), j0f = floor_(yl);
  T wx[S], wy[S];
  lagrange<T, ORDER>(xl - i0f, wx);
  lagrange<T, ORDER>(yl - j0f, wy);
  const int i0 = int(i0f), j0 = int(j0f);
  long long row[S];
  int col[S];
#pragma unroll
  for (int a = 0; a < S; ++a) {
    row[a] = (long long)wrap_index(i0 + a - ORDER, nx) * ny * NODE;
    col[a] = wrap_index(j0 + a - ORDER, ny) * NODE;
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = T(0);
#pragma unroll
  for (int a = 0; a < S; ++a) {
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const T w2 = wx[a] * wy[b];
      T v[NF];
      if constexpr (NF == 2) {
        load_uv(F + row[a] + col[b], v);
      } else {
        load_node7(F + row[a] + col[b], v);
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[f] += v[f] * w2;
    }
  }
}

// x0, k0, a0 may be xo, ko, ao: a thread reads and writes its own packet.
template <typename T, int ORDER>
__global__ void __launch_bounds__(256) march_xka_kernel(XkaArgs<T> A) {
  const long long thread = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (thread >= A.np) return;  // ragged last block
  const long long pkt = A.perm ? A.perm[thread] : thread;
  T x0 = A.x0[pkt], x1 = A.x0[A.np + pkt];
  T k0 = A.k0[pkt], k1 = A.k0[A.np + pkt];
  T a = A.a0[pkt];
  const int nx = A.nx, ny = A.ny;
  const T dx = T(A.dx), dy = T(A.dy), dt = T(A.dt);
  const T f = T(A.f), f2 = T(A.f2), gH = T(A.gH);
  const T* __restrict__ F = A.F;

  // u, v, u_x, u_y, v_x, v_y, H at the packet's position
  T e[7];
  if (A.nsteps > 0) eval_at<T, ORDER, 7>(F, x0, x1, nx, ny, dx, dy, e);

  for (int step = 0; step < A.nsteps; ++step) {
    // group velocity with the depth at x, frozen over the step
    const T gHH = gH * e[6];
    const T K2 = k0 * k0 + k1 * k1;
    const T om0 = sqrt_(f2 + gHH * K2);
    const T c0 = gHH * k0 / om0, c1 = gHH * k1 / om0;

    // position RK4 on dx/dt = U(x) + C
    T uv[2];
    const T p10 = dt * (e[0] + c0), p11 = dt * (e[1] + c1);
    eval_at<T, ORDER, 2>(F, x0 + T(0.5) * p10, x1 + T(0.5) * p11, nx, ny,
                         dx, dy, uv);
    const T p20 = dt * (uv[0] + c0), p21 = dt * (uv[1] + c1);
    eval_at<T, ORDER, 2>(F, x0 + T(0.5) * p20, x1 + T(0.5) * p21, nx, ny,
                         dx, dy, uv);
    const T p30 = dt * (uv[0] + c0), p31 = dt * (uv[1] + c1);
    eval_at<T, ORDER, 2>(F, x0 + p30, x1 + p31, nx, ny, dx, dy, uv);
    const T p40 = dt * (uv[0] + c0), p41 = dt * (uv[1] + c1);
    x0 = x0 + (p10 + T(2) * p20 + T(2) * p30 + p40) / T(6);
    x1 = x1 + (p11 + T(2) * p21 + T(2) * p31 + p41) / T(6);

    // everything at the new position: the next step's start too
    eval_at<T, ORDER, 7>(F, x0, x1, nx, ny, dx, dy, e);
    const T gHn = gH * e[6];
    const T om = sqrt_(f2 + gHn * K2);
    const T cx = gHn * k0 / om, cy = gHn * k1 / om;
    const T divC = (k0 * f * e[1] - k1 * f * e[0] - cx * cx - cy * cy) / om;
    const T gox = f * K2 * e[1] / (T(2) * om);
    const T goy = -f * K2 * e[0] / (T(2) * om);

    // k: RK4 on dk/dt = -((grad U)^T k + grad omega), U_x..V_y = e[2..5]
    const T q10 = -dt * ((e[2] * k0 + e[4] * k1) + gox);
    const T q11 = -dt * ((e[3] * k0 + e[5] * k1) + goy);
    T s0 = k0 + T(0.5) * q10, s1 = k1 + T(0.5) * q11;
    const T q20 = -dt * ((e[2] * s0 + e[4] * s1) + gox);
    const T q21 = -dt * ((e[3] * s0 + e[5] * s1) + goy);
    s0 = k0 + T(0.5) * q20, s1 = k1 + T(0.5) * q21;
    const T q30 = -dt * ((e[2] * s0 + e[4] * s1) + gox);
    const T q31 = -dt * ((e[3] * s0 + e[5] * s1) + goy);
    s0 = k0 + q30, s1 = k1 + q31;
    const T q40 = -dt * ((e[2] * s0 + e[4] * s1) + gox);
    const T q41 = -dt * ((e[3] * s0 + e[5] * s1) + goy);
    k0 = k0 + (q10 + T(2) * q20 + T(2) * q30 + q40) / T(6);
    k1 = k1 + (q11 + T(2) * q21 + T(2) * q31 + q41) / T(6);

    // a: RK4 on da/dt = -a div C
    const T r1 = dt * (-a * divC);
    const T r2 = dt * (-(a + T(0.5) * r1) * divC);
    const T r3 = dt * (-(a + T(0.5) * r2) * divC);
    const T r4 = dt * (-(a + r3) * divC);
    a = a + (r1 + T(2) * r2 + T(2) * r3 + r4) / T(6);
  }
  A.xo[pkt] = x0;
  A.xo[A.np + pkt] = x1;
  A.ko[pkt] = k0;
  A.ko[A.np + pkt] = k1;
  A.ao[pkt] = a;
}

// order: the stencil half-width, nodes -order..order+1 (1, 2 or 3).
// Returns cudaGetLastError() after the launch, or -1 for a configuration
// with no kernel.
template <typename T>
int launch(const void* F, const void* x0, const void* k0, const void* a0,
           void* xo, void* ko, void* ao, const void* perm, long long np,
           int nx, int ny, double dx, double dy, double dt, double f,
           double gH, int nsteps, int order, int threads, void* stream) {
  if (threads < 32 || threads > 256 || threads % 32 || nx < 1 || ny < 1 ||
      nsteps < 0 || np < 0)
    return -1;
  if (np == 0) return 0;
  XkaArgs<T> A;
  A.F = (const T*)F;
  A.x0 = (const T*)x0;
  A.k0 = (const T*)k0;
  A.a0 = (const T*)a0;
  A.xo = (T*)xo;
  A.ko = (T*)ko;
  A.ao = (T*)ao;
  A.perm = (const int*)perm;
  A.np = np;
  A.nx = nx;
  A.ny = ny;
  A.dx = dx;
  A.dy = dy;
  A.dt = dt;
  A.f = f;
  A.f2 = f * f;
  A.gH = gH;
  A.nsteps = nsteps;
  const long long blocks = (np + threads - 1) / threads;
  if (blocks > 2147483647LL) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (order) {
    case 1:
      march_xka_kernel<T, 1><<<(unsigned)blocks, threads, 0, s>>>(A);
      break;
    case 2:
      march_xka_kernel<T, 2><<<(unsigned)blocks, threads, 0, s>>>(A);
      break;
    case 3:
      march_xka_kernel<T, 3><<<(unsigned)blocks, threads, 0, s>>>(A);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// F: (nx, ny, 8) node-major grids u, v, ux, uy, vx, vy, H and padding;
// x0, k0 (2, Np), a0 (Np,); perm: (Np,) int32 permutation (thread p
// marches packet perm[p]) or null.
extern "C" int swr_march_xka_f32(const void* F, const void* x0,
                                 const void* k0, const void* a0, void* xo,
                                 void* ko, void* ao, const void* perm,
                                 long long np, int nx, int ny, double dx,
                                 double dy, double dt, double f, double gH,
                                 int nsteps, int order, int threads,
                                 void* stream) {
  return launch<float>(F, x0, k0, a0, xo, ko, ao, perm, np, nx, ny, dx, dy,
                       dt, f, gH, nsteps, order, threads, stream);
}

extern "C" int swr_march_xka_f64(const void* F, const void* x0,
                                 const void* k0, const void* a0, void* xo,
                                 void* ko, void* ao, const void* perm,
                                 long long np, int nx, int ny, double dx,
                                 double dy, double dt, double f, double gH,
                                 int nsteps, int order, int threads,
                                 void* stream) {
  return launch<double>(F, x0, k0, a0, xo, ko, ao, perm, np, nx, ny, dx, dy,
                        dt, f, gH, nsteps, order, threads, stream);
}
