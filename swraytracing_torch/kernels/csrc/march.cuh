// Fused wave-packet march for Hopper (sm_90a): every substep and stage of
// the ray ODE over one flow step, for all packets, in one launch.
//
// Replaces the TPU Pallas kernel `_march_kernel` (launched by
// `march_pallas`) of swraytracing_tpu/ops/pallas_window.py, and computes
// what `_march_core` there computes. Its plain PyTorch version is
// `march_reference` in swraytracing_torch/ops/march_window.py; the
// arithmetic below follows it operation for operation (same Lagrange
// products, y-then-x contraction, same stage formulas), so the two differ
// only by fused multiply-adds and by skipping the window entries whose
// weight is exactly zero.
//
// Bound on this card: bytes. A packet needs its window row of both
// snapshots once (2K values, about 1 KB at nf=2, margin 1, float32)
// against a few thousand floating-point operations.
//
// Design. The TPU kernel keeps packets on vector lanes and shifts the six
// stencil weights into the SW-wide window with select-sums, because a
// lane cannot index on its own; for the same reason the JAX package
// gathers every packet's row into a second array before its kernel runs.
// A GPU thread can index: one thread owns one packet, computes its 6
// (+6 derivative) weights per axis in registers and contracts only the
// live 6x6 sub-window at offset (di+m, dj+m) of its row, blending the two
// snapshots as it reads. Two things keep the bytes near what must move:
//
//  * The row by cell. p1 and p2 are the cell-window arrays themselves,
//    (ncells, K) rows of K = nf * SW^2 elements, and a packet's row is
//    row oi*ny + oj of each: no gathered copy is written or read back.
//
//  * Staging (template parameter STAGED). A thread reading its own row
//    touches 32 different sectors per warp instruction, at every one of
//    the 36 x nf x 2 reads of every stage.
//    Instead each warp first copies its 32 packets' rows into shared
//    memory, the 32 lanes together reading consecutive elements of ONE
//    row, so device memory is read once per row and fully coalesced;
//    every stage then contracts from shared memory. A packet's row is
//    2K + 1 elements apart from the next: the odd stride spreads the
//    lanes' reads of one component over all banks. It costs the 16-byte
//    alignment of the rows, so the copies are element-sized; they are
//    asynchronous copies (cp.async) that go from device to shared memory
//    without passing through registers, all of a warp's rows in flight at
//    once. (Staging through registers, 16-byte loads and scalar stores in
//    batches of 8 rows, took twice the kernel's time: a warp waited out
//    the memory latency four times, and then stored.) Staging is per warp
//    (__syncwarp, no block barrier), so the only limit on a block is that
//    its warps' rows fit in shared memory; lanes past the last packet stay
//    for the copy and skip only their own march.
//
// Which of the two a launch takes is the caller's rule on (2K, element
// size) alone (march_route in march_window.py): staged while a warp's
// rows fit in an SM's shared memory, else direct per-thread loads. A
// staged launch that does not fit is refused, not rerouted.
// march_ring.cuh runs the same packets through a third route, in which
// producer warps of a persistent block copy the rows into a ring of slots
// while consumer warps march; the rule gives it the row sizes at which the
// ring holds four consumer warps (float32 at K <= 128).
//
// Members. The same kernel marches the members of an ensemble in one
// launch (B5: `_march_kernel` under `jax.vmap` in the JAX package's
// parallel/ensemble.py): blockIdx.y is the member, whose window arrays,
// packets, cells and overflow counts start at fixed member strides, and
// whose substep length the kernel reads from a float64 device array and
// rounds to T as the single-member launch rounds its argument. A member
// is the same computation as a single-member launch on its own arrays,
// so its results are the same bits. The single-member entries launch one
// member (gridDim.y = 1) with the substep length as an argument.
//
// This header holds the kernel; march_f32.cu, march_f64.cu (direct),
// march_staged_f32.cu, march_staged_f64.cu (staged) and march_ring_f32.cu,
// march_ring_f64.cu (ring, with march_ring.cuh) instantiate it for one
// scalar type and route each, with the single-member and the ensemble
// entry, so the six compile side by side.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "scalar.cuh"

namespace {

enum { RK23 = 0, RK4 = 1, SYMPLECTIC = 2 };

template <typename T>
struct MarchArgs {
  const T* p1;          // snapshot-1 windows, (ncells, K)
  const T* p2;          // snapshot-2 windows, (ncells, K)
  const T* xk;          // (4, Np)
  const int* oi;        // (Np,)
  const int* oj;        // (Np,)
  T* out;               // (4, Np)
  int* ov;              // (Np,)
  long long np;
  double sub_dt;
  const double* sub_dt_e;  // (E,) per member, or null: sub_dt for all
  long long member_win;    // elements from one member's windows to the next
  int nx, ny;
  double inv_dx, inv_dy, f2, gH;
  int margin, nsub;
};

// Lagrange basis weights for nodes -2..3 at fractional position fr, and
// their derivatives. Products run over ascending j and multiply by the
// reciprocal of the constant denominator, as the plain version does.
template <typename T>
__device__ __forceinline__ void lagrange(T fr, T* w, T* dw, bool want_dw) {
  const T a[6] = {fr - T(-2), fr - T(-1), fr - T(0),
                  fr - T(1),  fr - T(2),  fr - T(3)};
  const T rd[6] = {T(1.0 / -120.0), T(1.0 / 24.0),  T(1.0 / -12.0),
                   T(1.0 / 12.0),   T(1.0 / -24.0), T(1.0 / 120.0)};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T p = T(0);
    bool first = true;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (j == i) continue;
      p = first ? a[j] : p * a[j];
      first = false;
    }
    w[i] = p * rd[i];
  }
  if (!want_dw) return;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = T(0);
    bool first_s = true;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      if (m == i) continue;
      T p = T(0);
      bool first = true;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (j == i || j == m) continue;
        p = first ? a[j] : p * a[j];
        first = false;
      }
      s = first_s ? p : s + p;
      first_s = false;
    }
    dw[i] = s * rd[i];
  }
}

// Interpolate the time-blended fields at (x0, x1) from this packet's
// windows r1, r2 (in shared memory with unit stride when STAGED, else in
// device memory). F = [u, v, ux, uy, vx, vy]. Returns the margin excess.
template <typename T, bool GRAD, bool STAGED>
__device__ __forceinline__ int eval_fields(const MarchArgs<T>& A,
                                           const T* __restrict__ r1,
                                           const T* __restrict__ r2,
                                           T x0, T x1, double alpha_d,
                                           int oi, int oj, T* F) {
  const int nx = A.nx, ny = A.ny, m = A.margin;
  const int sw = 6 + 2 * m;
  const T inv_dx = T(A.inv_dx), inv_dy = T(A.inv_dy);
  const T xl = floored_mod(x0 * inv_dx, T(nx));
  const T yl = floored_mod(x1 * inv_dy, T(ny));
  const T i0f = floor_(xl), j0f = floor_(yl);
  const T fx = xl - i0f, fy = yl - j0f;
  int i0 = int(i0f), j0 = int(j0f);
  if (i0 >= nx) i0 -= nx;  // floor(mod) floating-point edge
  if (j0 >= ny) j0 -= ny;
  int di = i0 - oi;
  if (di > nx / 2) di -= nx;
  if (di < -(nx / 2)) di += nx;
  int dj = j0 - oj;
  if (dj > ny / 2) dj -= ny;
  if (dj < -(ny / 2)) dj += ny;
  const int ov = max(max(abs(di), abs(dj)) - m, 0);  // before the clamp
  di = min(max(di, -m), m);
  dj = min(max(dj, -m), m);

  T wx[6], wy[6], dwx[6], dwy[6];
  lagrange(fx, wx, dwx, GRAD);
  lagrange(fy, wy, dwy, GRAD);

  const T alpha = T(alpha_d);
  const T oma = T(1.0 - alpha_d);
  constexpr int NF = GRAD ? 2 : 6;
  T val[NF], gx[NF], gy[NF];  // sum_x ty*wx, sum_x ty*dwx, sum_x tdy*wx
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    T acc = T(0), accx = T(0), accy = T(0);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const int base = (f * sw + di + m + a) * sw + dj + m;
      T ty = T(0), tdy = T(0);
#pragma unroll
      for (int b = 0; b < 6; ++b) {  // y first
        const int at = base + b;
        const T v = STAGED ? oma * r1[at] + alpha * r2[at]
                           : oma * __ldg(r1 + at) + alpha * __ldg(r2 + at);
        ty += v * wy[b];
        if (GRAD) tdy += v * dwy[b];
      }
      acc += ty * wx[a];               // then x
      if (GRAD) {
        accx += ty * dwx[a];
        accy += tdy * wx[a];
      }
    }
    val[f] = acc;
    gx[f] = accx;
    gy[f] = accy;
  }
  if (GRAD) {
    F[0] = val[0];
    F[1] = val[1];
    F[2] = gx[0] * inv_dx;
    F[3] = gy[0] * inv_dy;
    F[4] = gx[1] * inv_dx;
    F[5] = gy[1] * inv_dy;
  } else {
#pragma unroll
    for (int f = 0; f < 6; ++f) F[f] = val[f < NF ? f : 0];
  }
  return ov;
}

// Right-hand side of the ray ODE: d = [dx0, dx1, dk0, dk1].
template <typename T, bool GRAD, bool STAGED>
__device__ __forceinline__ int rhs(const MarchArgs<T>& A,
                                   const T* __restrict__ r1,
                                   const T* __restrict__ r2, T x0, T x1,
                                   T k0, T k1, double alpha, int oi, int oj,
                                   T* d) {
  T F[6];
  const int ov =
      eval_fields<T, GRAD, STAGED>(A, r1, r2, x0, x1, alpha, oi, oj, F);
  const T f2 = T(A.f2), gH = T(A.gH);
  const T om = sqrt_(f2 + gH * (k0 * k0 + k1 * k1));
  const T inv = T(1) / om;
  d[0] = F[0] + gH * k0 * inv;
  d[1] = F[1] + gH * k1 * inv;
  d[2] = -(F[2] * k0 + F[4] * k1);
  d[3] = -(F[3] * k0 + F[5] * k1);
  return ov;
}

// Copy the rows of this warp's `nrows` packets (lane r holds `row` of
// packet r, a row of K elements) from p1, p2 into shared memory at `dst`,
// packet r at dst + r*stride: K elements of snapshot 1, then K of
// snapshot 2. The lanes copy consecutive elements of one row with
// asynchronous element-sized copies (cp.async), so an instruction reads 32
// consecutive elements of device memory and writes them to 32 different
// banks, no register holds the data, and all of the warp's rows are in
// flight at once. Returns when this thread's copies have landed; the caller's
// __syncwarp() makes the other lanes' visible.
template <typename T>
__device__ __forceinline__ void stage_rows(const MarchArgs<T>& A, T* dst,
                                           int stride, int K, long long row,
                                           int nrows, int lane) {
  for (int r = 0; r < nrows; ++r) {
    // every lane takes part in the shuffle: nrows is the same for all
    const long long at = __shfl_sync(0xffffffffu, row, r) * K;
    T* s = dst + r * stride;
    for (int c = lane; c < K; c += 32) {
      __pipeline_memcpy_async(s + c, A.p1 + at + c, sizeof(T));
      __pipeline_memcpy_async(s + K + c, A.p2 + at + c, sizeof(T));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Every substep and stage of one flow step for the packet `pkt` of the
// member A points at, from its window rows r1, r2 (in shared memory when
// STAGED), and its results written to out and ov. The staged and the ring
// kernels (march_ring.cuh) both march a packet through this one function,
// so the two give the same bits.
template <typename T, bool GRAD, int STEPPER, bool STAGED>
__device__ __forceinline__ void march_packet(const MarchArgs<T>& A,
                                             const T* __restrict__ r1,
                                             const T* __restrict__ r2, int oi,
                                             int oj, long long pkt) {
  T x0 = A.xk[pkt], x1 = A.xk[A.np + pkt];
  T k0 = A.xk[2 * A.np + pkt], k1 = A.xk[3 * A.np + pkt];
  const T h = T(A.sub_dt);
  const int n = A.nsub;
  const double da = 1.0 / n;
  int ovt = 0;  // the MAX over stages and substeps, not a sum

  // the right-hand side on this packet's windows
  const auto f = [&](T xa, T xb, T ka, T kb, double alpha, T* out) {
    return rhs<T, GRAD, STAGED>(A, r1, r2, xa, xb, ka, kb, alpha, oi, oj,
                                out);
  };

  for (int i = 0; i < n; ++i) {
    const double a0 = double(i) / n;
    if (STEPPER == RK23) {
      T d[4], e[4], g[4];
      int o = f(x0, x1, k0, k1, a0, d);
      const T hh = T(0.5) * h;
      o = max(o, f(x0 + hh * d[0], x1 + hh * d[1], k0 + hh * d[2],
                   k1 + hh * d[3], a0 + 0.5 * da, e));
      const T hq = T(0.75) * h;
      o = max(o, f(x0 + hq * e[0], x1 + hq * e[1], k0 + hq * e[2],
                   k1 + hq * e[3], a0 + 0.75 * da, g));
      const T c = h / T(9);
      x0 = x0 + c * (T(2) * d[0] + T(3) * e[0] + T(4) * g[0]);
      x1 = x1 + c * (T(2) * d[1] + T(3) * e[1] + T(4) * g[1]);
      k0 = k0 + c * (T(2) * d[2] + T(3) * e[2] + T(4) * g[2]);
      k1 = k1 + c * (T(2) * d[3] + T(3) * e[3] + T(4) * g[3]);
      ovt = max(ovt, o);
    } else if (STEPPER == RK4) {
      T d[4], e[4], g[4], q[4];
      int o = f(x0, x1, k0, k1, a0, d);
      const T hh = T(0.5) * h;
      o = max(o, f(x0 + hh * d[0], x1 + hh * d[1], k0 + hh * d[2],
                   k1 + hh * d[3], a0 + 0.5 * da, e));
      o = max(o, f(x0 + hh * e[0], x1 + hh * e[1], k0 + hh * e[2],
                   k1 + hh * e[3], a0 + 0.5 * da, g));
      o = max(o, f(x0 + h * g[0], x1 + h * g[1], k0 + h * g[2],
                   k1 + h * g[3], a0 + da, q));
      const T c = h / T(6);
      x0 = x0 + c * (d[0] + T(2) * (e[0] + g[0]) + q[0]);
      x1 = x1 + c * (d[1] + T(2) * (e[1] + g[1]) + q[1]);
      k0 = k0 + c * (d[2] + T(2) * (e[2] + g[2]) + q[2]);
      k1 = k1 + c * (d[3] + T(2) * (e[3] + g[3]) + q[3]);
      ovt = max(ovt, o);
    } else {  // SYMPLECTIC: Strang half drift, kick, half drift
      const T f2 = T(A.f2), gH = T(A.gH);
      T om = sqrt_(f2 + gH * (k0 * k0 + k1 * k1));
      T cinv = T(0.5) * h * gH / om;
      x0 = x0 + cinv * k0;
      x1 = x1 + cinv * k1;
      T F[6];
      const int o = eval_fields<T, GRAD, STAGED>(
          A, r1, r2, x0, x1, a0 + 0.5 * da, oi, oj, F);
      const T k0n = k0 - h * (F[2] * k0 + F[4] * k1);
      const T k1n = k1 - h * (F[3] * k0 + F[5] * k1);
      x0 = x0 + h * F[0];
      x1 = x1 + h * F[1];
      k0 = k0n;
      k1 = k1n;
      om = sqrt_(f2 + gH * (k0 * k0 + k1 * k1));
      cinv = T(0.5) * h * gH / om;
      x0 = x0 + cinv * k0;
      x1 = x1 + cinv * k1;
      ovt = max(ovt, o);
    }
  }
  A.out[pkt] = x0;
  A.out[A.np + pkt] = x1;
  A.out[2 * A.np + pkt] = k0;
  A.out[3 * A.np + pkt] = k1;
  A.ov[pkt] = ovt;
}

template <typename T, bool GRAD, int STEPPER, bool STAGED>
__global__ void __launch_bounds__(256) march_kernel(const MarchArgs<T> A0) {
  // this block's member: its arrays and its substep length
  MarchArgs<T> A = A0;
  const long long member = blockIdx.y;
  A.p1 += member * A0.member_win;
  A.p2 += member * A0.member_win;
  A.xk += member * 4 * A0.np;
  A.out += member * 4 * A0.np;
  A.oi += member * A0.np;
  A.oj += member * A0.np;
  A.ov += member * A0.np;
  if (A0.sub_dt_e) A.sub_dt = A0.sub_dt_e[member];
  const long long pkt = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool live = pkt < A.np;  // ragged last block
  if (!STAGED && !live) return;
  const int oi = live ? A.oi[pkt] : 0, oj = live ? A.oj[pkt] : 0;
  // 64-bit: ncells*K passes 2^31 at 1024^2
  const long long row = (long long)oi * A.ny + oj;
  const int sw = 6 + 2 * A.margin;
  const int K = (GRAD ? 2 : 6) * sw * sw;
  const T* __restrict__ r1;
  const T* __restrict__ r2;
  if (STAGED) {
    extern __shared__ __align__(8) unsigned char march_rows[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int stride = 2 * K + 1;
    const long long first = pkt - lane;  // the warp's first packet
    if (first >= A.np) return;           // the whole warp is past the end
    const int nrows = (int)min(32LL, A.np - first);
    T* mine = reinterpret_cast<T*>(march_rows) + (size_t)warp * 32 * stride;
    stage_rows<T>(A, mine, stride, K, row, nrows, lane);
    __syncwarp();
    if (!live) return;
    r1 = mine + lane * stride;
    r2 = r1 + K;
  } else {
    r1 = A.p1 + row * K;
    r2 = A.p2 + row * K;
  }
  march_packet<T, GRAD, STEPPER, STAGED>(A, r1, r2, oi, oj, pkt);
}

// Shared memory one SM can give its blocks on sm_90 (227 KB).
constexpr size_t SMEM_PER_SM = 232448;

// How a launch reads its window rows: every thread its own row from device
// memory, each warp its rows copied into shared memory first, or a
// persistent block whose producer warps copy rows into a ring of slots
// while its consumer warps march (march_ring.cuh).
enum { ROUTE_DIRECT = 0, ROUTE_STAGED = 1, ROUTE_RING = 2 };

// Defined in march_ring.cuh, which the ring route's sources include.
template <typename T, bool GRAD, int STEPPER>
int launch_ring_kernel(const MarchArgs<T>& A, int members, int threads,
                       cudaStream_t stream);

template <typename T, bool GRAD, int STEPPER, int ROUTE>
int launch_kernel(const MarchArgs<T>& A, int members, int threads,
                  cudaStream_t stream) {
  if constexpr (ROUTE == ROUTE_RING) {
    return launch_ring_kernel<T, GRAD, STEPPER>(A, members, threads, stream);
  } else {
    constexpr bool STAGED = ROUTE == ROUTE_STAGED;
    if (threads > 256) return -1;
    const long long bx = (A.np + threads - 1) / threads;
    if (bx > 2147483647LL) return -1;
    const dim3 blocks((unsigned)bx, (unsigned)members);
    size_t smem = 0;
    if (STAGED) {
      const int sw = 6 + 2 * A.margin;
      const size_t stride = 2 * (size_t)((GRAD ? 2 : 6) * sw * sw) + 1;
      smem = (size_t)(threads / 32) * 32 * stride * sizeof(T);
      if (smem > SMEM_PER_SM) return -2;
      // More than 48 KB a block has to be asked for, per kernel and device;
      // all of the SM's shared memory goes to the rows. Asked at every
      // launch: the call is cheap and idempotent, and keeps no state here.
      cudaError_t err =
          cudaFuncSetAttribute(march_kernel<T, GRAD, STEPPER, STAGED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_PER_SM);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            march_kernel<T, GRAD, STEPPER, STAGED>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return (int)err;
    }
    march_kernel<T, GRAD, STEPPER, STAGED>
        <<<blocks, threads, smem, stream>>>(A);
    return (int)cudaGetLastError();
  }
}

template <typename T, bool GRAD, int ROUTE>
int launch_stepper(const MarchArgs<T>& A, int stepper, int members,
                   int threads, cudaStream_t stream) {
  if (A.np == 0 || members == 0) return 0;
  switch (stepper) {
    case RK23:
      return launch_kernel<T, GRAD, RK23, ROUTE>(A, members, threads, stream);
    case RK4:
      return launch_kernel<T, GRAD, RK4, ROUTE>(A, members, threads, stream);
    case SYMPLECTIC:
      return launch_kernel<T, GRAD, SYMPLECTIC, ROUTE>(A, members, threads,
                                                       stream);
    default:
      return -1;
  }
}

// nf = 2: (u, v) windows, gradients from the interpolant's derivative;
// nf = 6: (u, v, ux, uy, vx, vy) windows. stepper: 0 rk23, 1 rk4,
// 2 symplectic. p1, p2 are (ncells, K) cell-window arrays, K = nf *
// (6 + 2 margin)^2, and a packet reads row oi*ny + oj (oi, oj trusted to
// lie in [0, n)). ROUTE_STAGED needs threads/32 warps' rows within an
// SM's shared memory; ROUTE_RING needs two slots of 32 rows within it,
// and threads = 32 x (consumer warps + 1), the consumers fewer
// than the slots. members: the number of members (1 for a
// single-member launch), at most 65535; member m's windows start
// member_win elements after member m-1's, its xk and out 4*np, its oi, oj
// and ov np; sub_dt_e: the members' substep lengths on the device, or
// null for `sub_dt` alone.
// Returns cudaGetLastError() after the launch, -1 for a configuration
// with no kernel, or -2 for a staged block whose rows pass SMEM_PER_SM or
// a ring with fewer than two slots.
template <typename T, int ROUTE>
int launch(const void* p1, const void* p2, const void* xk, const void* oi,
           const void* oj, void* out, void* ov, long long np, double sub_dt,
           const void* sub_dt_e, int members, long long member_win, int nx,
           int ny, double inv_dx, double inv_dy, double f2, double gH,
           int margin, int nsub, int nf, int stepper, int threads,
           void* stream) {
  MarchArgs<T> A;
  A.p1 = (const T*)p1;
  A.p2 = (const T*)p2;
  A.xk = (const T*)xk;
  A.oi = (const int*)oi;
  A.oj = (const int*)oj;
  A.out = (T*)out;
  A.ov = (int*)ov;
  A.np = np;
  A.sub_dt = sub_dt;
  A.sub_dt_e = (const double*)sub_dt_e;
  A.member_win = member_win;
  A.nx = nx;
  A.ny = ny;
  A.inv_dx = inv_dx;
  A.inv_dy = inv_dy;
  A.f2 = f2;
  A.gH = gH;
  A.margin = margin;
  A.nsub = nsub;
  if (threads < 32 || threads > 384 || threads % 32 || margin < 0 ||
      nsub < 1 || members < 0 || members > 65535)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (nf == 2)
    return launch_stepper<T, true, ROUTE>(A, stepper, members, threads, s);
  if (nf == 6)
    return launch_stepper<T, false, ROUTE>(A, stepper, members, threads, s);
  return -1;
}

// The C entries of one scalar type and route (march_*.cu), to stand
// behind `extern "C"`: `name` marches one member of (ncells, K) window
// arrays read by cell, with the substep length as an argument; `batched`
// marches `members` members of them, each with its own substep length
// from the float64 device array sub_dt_e.
#define SWR_MARCH_ENTRY(name, batched, T, ROUTE)                             \
  int name(                                                                  \
      const void* win1, const void* win2, const void* xk, const void* oi,    \
      const void* oj, void* out, void* ov, long long np, double sub_dt,      \
      int nx, int ny, double inv_dx, double inv_dy, double f2, double gH,    \
      int margin, int nsub, int nf, int stepper, int threads,                \
      void* stream) {                                                        \
    return launch<T, ROUTE>(win1, win2, xk, oi, oj, out, ov, np, sub_dt,     \
                            nullptr, 1, 0, nx, ny, inv_dx, inv_dy, f2, gH,   \
                            margin, nsub, nf, stepper, threads, stream);     \
  }                                                                          \
  int batched(                                                               \
      const void* win1, const void* win2, int members, long long ncells,     \
      int K, const void* xk, const void* oi, const void* oj, void* out,      \
      void* ov, long long np, const void* sub_dt_e, int nx, int ny,          \
      double inv_dx, double inv_dy, double f2, double gH, int margin,        \
      int nsub, int nf, int stepper, int threads, void* stream) {            \
    const int sw = 6 + 2 * margin;                                           \
    if (!sub_dt_e || K != (nf == 2 ? 2 : 6) * sw * sw) return -1;            \
    return launch<T, ROUTE>(win1, win2, xk, oi, oj, out, ov, np, 0.0,        \
                            sub_dt_e, members, ncells * K, nx, ny, inv_dx,   \
                            inv_dy, f2, gH, margin, nsub, nf, stepper,       \
                            threads, stream);                                \
  }

}  // namespace

