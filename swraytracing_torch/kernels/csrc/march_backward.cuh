// The backward of the fused wave-packet march (march.cuh) for Hopper
// (sm_90a): for the packets of one flow step, the cotangents of their
// start state and of both snapshots' cell-window arrays, from the
// cotangent of their end state.
//
// Replaces autograd through `march_gathered_reference` (the plain march in
// swraytracing_torch/ops/march_window.py), which is how the JAX package
// differentiates its TPU kernel `_march_kernel` (pallas_window.py: the
// custom VJP of `fused_march` differentiates the plain march); it has no
// backward kernel of its own. Plain version: autograd through
// march_gathered_reference, `march_gathered_backward_reference` in
// march_window.py. What this computes is the exact adjoint of what
// `march_packet` computes for the rk23 stepper: the blend weights
// (1 - alpha, alpha) of the two snapshots, the Lagrange weights and, with
// (u, v) windows, the second derivative of the Lagrange basis (the
// velocity gradients come from the interpolant's first derivative), the
// position's derivative 1/dx through the fractional part (the integer
// cell, shift, clamp and wrap carry none), and omega's derivative in k.
//
// Bound on this card: operations. A packet's backward repeats its forward
// stages (3 a substep) and then runs each stage's adjoint, which reads the
// packet's window rows once more; the bytes are each occupied cell's two
// rows read and both cotangent arrays written.
//
// Design: two kernels, launched one after the other by one C entry.
//
//  * Packets (march_backward_kernel). One warp a block, one packet a
//    thread, 32 at a time (a batch), in the order of their cells (a stable
//    sort by cell, made by the caller). A packet reads the rows of its cell
//    from both window arrays: copied into shared memory by the warp first,
//    with the forward's stage_rows (the `staged` route), or read where they
//    lie in device memory (`direct`, for rows too large to stage). Its
//    substeps run as march_packet runs them (the same rhs, the same bits),
//    keeping each substep's start and its first two stages' slopes; then
//    the substeps and their stages are undone, last first. Each stage's
//    adjoint evaluates the stencil again from the rows (the values and the
//    first and second weight derivatives at once) and gives the cotangent
//    of the stage's point. Its share of the window cotangent is an outer
//    product a field, wy (x) P + dwy (x) Q with P, Q from the x weights,
//    which the thread does not expand: it writes what it is made of (the
//    fractions fx, fy, the cotangents of the six fields the stencil gives
//    and the live window's offset, a record of 9 values) for its position
//    in the cell order, a warp's 32 records of a stage side by side. A
//    warp thus keeps no row of cotangents, and holds an SM's shared memory
//    only for its staged rows, as the forward does.
//  * Rows (window_cotangent_kernel). One warp a cell. Its packets' records
//    are consecutive in the cell order; the warp takes them 32 at a time:
//    each lane forms one stage's weights (the forward's `lagrange`) and P
//    and Q from the fractions, then lane q adds the live entries q,
//    q + 32, ... of each stage's outer products in turn, blended
//    (1 - alpha, alpha), to its own running sums of both snapshots, which
//    go into a row of 2K sums in shared memory whenever the live window
//    moves. The row is written once, zeros in a cell without a packet.
//    Every sum runs in the cell order, so the result does not depend on
//    the schedule, and each row is written by one warp.
//
// march_backward_f32.cu and march_backward_f64.cu instantiate it for one
// scalar type each.

#pragma once

#include "march.cuh"

namespace {

// Substeps whose start and slopes a thread keeps for the reverse sweep
// (BACKWARD_MAX_SUBSTEPS in march_window.py).
constexpr int BWD_MAX_SUBSTEPS = 8;

template <typename T>
struct BackwardArgs {
  MarchArgs<T> m;          // p1, p2: the window arrays; xk; the grid,
                           // the step and the substeps
  const int* key;          // (Np,) cell of the packet at each position
  const long long* perm;   // (Np,) packet at each position, or null
  const long long* ends;   // (ncells,) positions in cells 0..c (with perm)
  const T* ct;             // (4, Np) cotangent of the end state
  T* ct_in;                // (4, Np) cotangent of the start state
  T* records;              // (batches, 3 nsub, 32, RECORD), or null: a
                           // batch's records of one stage side by side
  T* cw1;                  // (ncells, K) cotangents of win1 (with records)
  T* cw2;                  // (ncells, K) cotangents of win2
  long long ncells;
  int stage;               // rows copied into shared memory first
};

// Values of a stage's record: [fx, fy, c0 .. c5, offset]. c: with (u, v)
// windows the cotangents of u and v, of their x derivatives times 1/dx and
// of their y derivatives times 1/dy (cv0, cv1, cx0, cx1, cy0, cy1); with six
// windows those of the six fields. offset: the live window's,
// (di + m) * sw + dj + m.
constexpr int RECORD = 9;

// Second derivatives of the six Lagrange basis weights of `lagrange`:
// L_i''(fr) = 2 sum_{m < n; m, n != i} prod_{j != i, m, n} (fr - o_j)
// times the reciprocal denominator.
template <typename T>
__device__ __forceinline__ void lagrange_d2(T fr, T* d2w) {
  const T a[6] = {fr - T(-2), fr - T(-1), fr - T(0),
                  fr - T(1),  fr - T(2),  fr - T(3)};
  const T rd[6] = {T(1.0 / -120.0), T(1.0 / 24.0),  T(1.0 / -12.0),
                   T(1.0 / 12.0),   T(1.0 / -24.0), T(1.0 / 120.0)};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = T(0);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
#pragma unroll
      for (int n = m + 1; n < 6; ++n) {
        if (m == i || n == i) continue;
        T p = T(1);
#pragma unroll
        for (int j = 0; j < 6; ++j)
          if (j != i && j != m && j != n) p *= a[j];
        s += p;
      }
    }
    d2w[i] = T(2) * s * rd[i];
  }
}

// The adjoint of rhs at (x0, x1, k0, k1, alpha): from dd, the cotangent of
// the slope rhs returned, dy (the cotangent of the point), and with WIN the
// factors of the window cotangent written to the record `rec`.
template <typename T, bool GRAD, bool WIN>
__device__ __forceinline__ void rhs_adjoint(const MarchArgs<T>& A,
                                            const T* __restrict__ r1,
                                            const T* __restrict__ r2,
                                            T* __restrict__ rec, T x0, T x1,
                                            T k0, T k1, double alpha_d,
                                            int oi, int oj, const T* dd,
                                            T* dy) {
  // the cell, fraction and shift, as eval_fields forms them
  const int nx = A.nx, ny = A.ny, m = A.margin;
  const int sw = 6 + 2 * m;
  const T inv_dx = T(A.inv_dx), inv_dy = T(A.inv_dy);
  const T xl = floored_mod(x0 * inv_dx, T(nx));
  const T yl = floored_mod(x1 * inv_dy, T(ny));
  const T i0f = floor_(xl), j0f = floor_(yl);
  const T fx = xl - i0f, fy = yl - j0f;
  int i0 = int(i0f), j0 = int(j0f);
  if (i0 >= nx) i0 -= nx;
  if (j0 >= ny) j0 -= ny;
  int di = i0 - oi;
  if (di > nx / 2) di -= nx;
  if (di < -(nx / 2)) di += nx;
  int dj = j0 - oj;
  if (dj > ny / 2) dj -= ny;
  if (dj < -(ny / 2)) dj += ny;
  di = min(max(di, -m), m);
  dj = min(max(dj, -m), m);

  T wx[6], wy[6], dwx[6], dwy[6], d2wx[6], d2wy[6];
  lagrange(fx, wx, dwx, true);
  lagrange(fy, wy, dwy, true);
  if (GRAD) {
    lagrange_d2(fx, d2wx);
    lagrange_d2(fy, d2wy);
  }
  const T alpha = T(alpha_d);
  const T oma = T(1.0 - alpha_d);

  // What each window field feeds, and the cotangent of each: with (u, v)
  // windows field f gives its value (slope f), its x derivative times
  // 1/dx (ux or vx, in dk0 and dk1 by -k_f dd[2]) and its y derivative
  // times 1/dy (uy or vy, by -k_f dd[3]); with six windows each field its
  // value: F = [u, v, ux, uy, vx, vy].
  constexpr int NF = GRAD ? 2 : 6;
  T cv[NF], cx[NF], cy[NF];
  if constexpr (GRAD) {
    cv[0] = dd[0];
    cv[1] = dd[1];
    cx[0] = -dd[2] * k0 * inv_dx;
    cx[1] = -dd[2] * k1 * inv_dx;
    cy[0] = -dd[3] * k0 * inv_dy;
    cy[1] = -dd[3] * k1 * inv_dy;
  } else {
    cv[0] = dd[0];
    cv[1] = dd[1];
    cv[2] = -dd[2] * k0;
    cv[3] = -dd[3] * k0;
    cv[4] = -dd[2] * k1;
    cv[5] = -dd[3] * k1;
  }
  // per field: the value and the sums of its weight derivatives
  T val[NF], gx[NF], gy[NF], gxx[NF], gxy[NF], gyy[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    T a0 = T(0), ax = T(0), ay = T(0), axx = T(0), axy = T(0), ayy = T(0);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const int base = (f * sw + di + m + a) * sw + dj + m;
      T ty = T(0), tdy = T(0), td2y = T(0);
#pragma unroll
      for (int b = 0; b < 6; ++b) {  // y first, as eval_fields
        const T v = oma * r1[base + b] + alpha * r2[base + b];
        ty += v * wy[b];
        tdy += v * dwy[b];
        if (GRAD) td2y += v * d2wy[b];
      }
      a0 += ty * wx[a];  // then x
      ax += ty * dwx[a];
      ay += tdy * wx[a];
      if (GRAD) {
        axx += ty * d2wx[a];
        axy += tdy * dwx[a];
        ayy += td2y * wx[a];
      }
    }
    val[f] = a0;
    gx[f] = ax;
    gy[f] = ay;
    gxx[f] = axx;
    gxy[f] = axy;
    gyy[f] = ayy;
  }
  if (WIN) {  // what the rows kernel forms the window cotangent from
    rec[0] = fx;
    rec[1] = fy;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      rec[2 + f] = cv[f];
      if (GRAD) {
        rec[4 + f] = cx[f];
        rec[6 + f] = cy[f];
      }
    }
    rec[RECORD - 1] = T((di + m) * sw + dj + m);
  }
  // cotangents of the fractions fx, fy, and the fields dk reads
  T dfx = T(0), dfy = T(0), F2, F3, F4, F5;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    if (GRAD) {
      dfx += cv[f] * gx[f] + cx[f] * gxx[f] + cy[f] * gxy[f];
      dfy += cv[f] * gy[f] + cx[f] * gxy[f] + cy[f] * gyy[f];
    } else {
      dfx += cv[f] * gx[f];
      dfy += cv[f] * gy[f];
    }
  }
  if constexpr (GRAD) {
    F2 = gx[0] * inv_dx;
    F3 = gy[0] * inv_dy;
    F4 = gx[1] * inv_dx;
    F5 = gy[1] * inv_dy;
  } else {
    F2 = val[2];
    F3 = val[3];
    F4 = val[4];
    F5 = val[5];
  }
  // omega = sqrt(f^2 + gH |k|^2): d(gH k_i / omega)/dk_j =
  // gH (delta_ij / omega - gH k_i k_j / omega^3)
  const T f2 = T(A.f2), gH = T(A.gH);
  const T om = sqrt_(f2 + gH * (k0 * k0 + k1 * k1));
  const T inv = T(1) / om;
  const T t = gH * gH * inv * inv * inv * (dd[0] * k0 + dd[1] * k1);
  dy[0] = dfx * inv_dx;
  dy[1] = dfy * inv_dy;
  dy[2] = -(dd[2] * F2 + dd[3] * F3) + gH * inv * dd[0] - t * k0;
  dy[3] = -(dd[2] * F4 + dd[3] * F5) + gH * inv * dd[1] - t * k1;
}

// The backward of march_packet (rk23) for the packet `pkt`, from its rows
// r1, r2: ct_in[:, pkt] from ct[:, pkt] where `live`, and with WIN the
// records of its stages. Every lane of the warp takes part (a lane past
// the last packet marches a stand-in and writes nothing that is read): a
// stage's 32 records go through `buf` (32 x RECORD in shared memory, this
// lane's at lane x RECORD) to `out`, the batch's records in device memory,
// in one coalesced copy.
template <typename T, bool GRAD, bool WIN>
__device__ __forceinline__ void march_packet_backward(
    const BackwardArgs<T>& B, const T* __restrict__ r1,
    const T* __restrict__ r2, T* __restrict__ buf, T* __restrict__ out,
    int oi, int oj, long long pkt, bool live) {
  constexpr int R = RECORD;
  const int lane = threadIdx.x & 31;
  T* const rec = buf + lane * R;
  // a stage's records, from buf to their place in out
  const auto copy_out = [&](int e) {
    if (!WIN) return;
    __syncwarp();
    T* dst = out + e * 32 * R;
    for (int t = lane; t < 32 * R; t += 32) dst[t] = buf[t];
    __syncwarp();
  };
  const MarchArgs<T>& A = B.m;
  const long long np = A.np;
  T s[4] = {A.xk[pkt], A.xk[np + pkt], A.xk[2 * np + pkt],
            A.xk[3 * np + pkt]};
  const T h = T(A.sub_dt);
  const int n = A.nsub;
  const double da = 1.0 / n;
  const T hh = T(0.5) * h, hq = T(0.75) * h, c = h / T(9);
  T keep[BWD_MAX_SUBSTEPS][12];  // each substep's start and slopes d, e

  // forward, as march_packet marches
  for (int i = 0; i < n; ++i) {
    const double a0 = double(i) / n;
    T d[4], e[4], g[4];
    rhs<T, GRAD, true>(A, r1, r2, s[0], s[1], s[2], s[3], a0, oi, oj, d);
    rhs<T, GRAD, true>(A, r1, r2, s[0] + hh * d[0], s[1] + hh * d[1],
                       s[2] + hh * d[2], s[3] + hh * d[3], a0 + 0.5 * da, oi,
                       oj, e);
    rhs<T, GRAD, true>(A, r1, r2, s[0] + hq * e[0], s[1] + hq * e[1],
                       s[2] + hq * e[2], s[3] + hq * e[3], a0 + 0.75 * da, oi,
                       oj, g);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      keep[i][q] = s[q];
      keep[i][4 + q] = d[q];
      keep[i][8 + q] = e[q];
      s[q] = s[q] + c * (T(2) * d[q] + T(3) * e[q] + T(4) * g[q]);
    }
  }

  // reverse: ds is the cotangent of the state after substep i
  T ds[4] = {B.ct[pkt], B.ct[np + pkt], B.ct[2 * np + pkt],
             B.ct[3 * np + pkt]};
  for (int i = n - 1; i >= 0; --i) {
    const double a0 = double(i) / n;
    T dd[4], de[4], dg[4], y[4], dy[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[q] = keep[i][q];
      dd[q] = T(2) * c * ds[q];
      de[q] = T(3) * c * ds[q];
      dg[q] = T(4) * c * ds[q];
      y[q] = s[q] + hq * keep[i][8 + q];
    }
    rhs_adjoint<T, GRAD, WIN>(A, r1, r2, rec, y[0], y[1], y[2], y[3],
                              a0 + 0.75 * da, oi, oj, dg, dy);
    copy_out(3 * i + 2);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ds[q] += dy[q];
      de[q] += hq * dy[q];
      y[q] = s[q] + hh * keep[i][4 + q];
    }
    rhs_adjoint<T, GRAD, WIN>(A, r1, r2, rec, y[0], y[1], y[2], y[3],
                              a0 + 0.5 * da, oi, oj, de, dy);
    copy_out(3 * i + 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ds[q] += dy[q];
      dd[q] += hh * dy[q];
    }
    rhs_adjoint<T, GRAD, WIN>(A, r1, r2, rec, s[0], s[1], s[2], s[3], a0, oi,
                              oj, dd, dy);
    copy_out(3 * i);
#pragma unroll
    for (int q = 0; q < 4; ++q) ds[q] += dy[q];
  }
  if (live) {
#pragma unroll
    for (int q = 0; q < 4; ++q) B.ct_in[q * np + pkt] = ds[q];
  }
}

template <typename T, bool GRAD, bool WIN>
__global__ void __launch_bounds__(32)
    march_backward_kernel(const BackwardArgs<T> B) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const MarchArgs<T>& A = B.m;
  const int lane = threadIdx.x;
  const int sw = 6 + 2 * A.margin;
  const int K = (GRAD ? 2 : 6) * sw * sw;
  const int stride = 2 * K + 1;
  T* staged = reinterpret_cast<T*>(bwd_smem);
  const long long first = blockIdx.x * 32LL;
  const int nrows = (int)min(32LL, A.np - first);
  const bool live = lane < nrows;
  const long long pos = first + (live ? lane : nrows - 1);  // a stand-in
  const int cell = B.key[pos];
  const long long pkt = B.perm ? B.perm[pos] : pos;
  const int oi = cell / A.ny, oj = cell - oi * A.ny;
  const T* r1;
  const T* r2;
  if (B.stage) {
    stage_rows<T>(A, staged, stride, K, (long long)cell, nrows, lane);
    __syncwarp();
    const int r = live ? lane : nrows - 1;
    r1 = staged + r * stride;
    r2 = r1 + K;
  } else {
    r1 = A.p1 + (long long)cell * K;
    r2 = A.p2 + (long long)cell * K;
  }
  T* buf = staged + (B.stage ? 32 * stride : 0);
  T* out = WIN ? B.records + blockIdx.x * 3LL * A.nsub * 32 * RECORD
               : nullptr;
  march_packet_backward<T, GRAD, WIN>(B, r1, r2, buf, out, oi, oj, pkt,
                                      live);
}

// Warps (cells) of a block of the rows kernel.
constexpr int ROW_WARPS = 4;

// A stage's slot in the rows kernel's shared memory: wy, dwy, P (NF x 6)
// and, with (u, v) windows, Q (2 x 6), then the offset and the two blend
// weights; slots an odd number of values apart.
constexpr int ROW_SLOT = 51;

template <typename T, bool GRAD>
__global__ void __launch_bounds__(32 * ROW_WARPS)
    window_cotangent_kernel(const BackwardArgs<T> B) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  constexpr int NF = GRAD ? 2 : 6;
  constexpr int ENTRIES = NF * 36;             // live entries a snapshot
  constexpr int J = (ENTRIES + 31) / 32;       // of them a lane's
  constexpr int WY = 0, DWY = 6, P = 12, Q = 12 + NF * 6;
  constexpr int OFF = 48, OMA = 49, ALPHA = 50;
  const MarchArgs<T>& A = B.m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sw = 6 + 2 * A.margin;
  const int K = NF * sw * sw;
  const int nev = 3 * A.nsub;
  const long long cell = blockIdx.x * (long long)ROW_WARPS + warp;
  if (cell >= B.ncells) return;  // the whole warp
  T* row = reinterpret_cast<T*>(row_smem) + warp * (2 * K + 32 * ROW_SLOT);
  T* slots = row + 2 * K;
  for (int c = lane; c < 2 * K; c += 32) row[c] = T(0);
  // this lane's entries (f, a, b): where they fall at offset 0, and P's
  int at[J], fa[J], bb[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = min(lane + 32 * j, ENTRIES - 1);
    const int f = q / 36, a = (q / 6) % 6;
    bb[j] = q % 6;
    fa[j] = f * 6 + a;
    at[j] = (f * sw + a) * sw + bb[j];
  }
  T s1[J], s2[J];  // running sums of both snapshots at offset `off`
  int off = -1;
  const auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (off >= 0 && lane + 32 * j < ENTRIES) {
        row[at[j] + off] += s1[j];
        row[K + at[j] + off] += s2[j];
      }
      s1[j] = s2[j] = T(0);
    }
  };
  flush();
  const long long lo = cell > 0 ? B.ends[cell - 1] : 0, hi = B.ends[cell];
  const long long nrec = (hi - lo) * nev;  // the cell's stages, in order
  const double da = 1.0 / A.nsub;
  for (long long r0 = 0; r0 < nrec; r0 += 32) {
    __syncwarp();  // the last slots are read
    const long long r = r0 + lane;
    if (r < nrec) {  // lane: one stage's slot from its record
      const long long pos = lo + r / nev;
      const int e = (int)(r % nev);
      const T* rec = B.records + ((pos / 32 * nev + e) * 32 + pos % 32) * RECORD;
      T v[RECORD];
#pragma unroll
      for (int t = 0; t < RECORD; ++t) v[t] = rec[t];
      T wx[6], dwx[6], wy[6], dwy[6];
      lagrange(v[0], wx, dwx, GRAD);
      lagrange(v[1], wy, dwy, GRAD);
      T* slot = slots + lane * ROW_SLOT;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        slot[WY + a] = wy[a];
        if (GRAD) slot[DWY + a] = dwy[a];
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          // c = [cv0, cv1, cx0, cx1, cy0, cy1], or the six fields' cv
          if (GRAD) {
            slot[P + f * 6 + a] = v[2 + f] * wx[a] + v[4 + f] * dwx[a];
            slot[Q + f * 6 + a] = v[6 + f] * wx[a];
          } else {
            slot[P + f * 6 + a] = v[2 + f] * wx[a];
          }
        }
      }
      // the stage's blend fraction, as march_packet forms it
      const double a0 = double(e / 3) / A.nsub;
      const double alpha = e % 3 == 0 ? a0 : a0 + (e % 3 == 1 ? 0.5 : 0.75) * da;
      slot[OFF] = v[RECORD - 1];
      slot[OMA] = T(1.0 - alpha);
      slot[ALPHA] = T(alpha);
    }
    __syncwarp();
    const int n = (int)min(32LL, nrec - r0);
    for (int k = 0; k < n; ++k) {  // the stages in order
      const T* slot = slots + k * ROW_SLOT;
      const int o = int(slot[OFF]);
      if (o != off) {  // the same for every lane
        flush();
        off = o;
      }
      const T oma = slot[OMA], alpha = slot[ALPHA];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const T c = GRAD ? slot[WY + bb[j]] * slot[P + fa[j]] +
                               slot[DWY + bb[j]] * slot[Q + fa[j]]
                         : slot[WY + bb[j]] * slot[P + fa[j]];
        s1[j] += oma * c;
        s2[j] += alpha * c;
      }
    }
  }
  flush();
  __syncwarp();
  for (int c = lane; c < K; c += 32) {
    B.cw1[cell * K + c] = row[c];
    B.cw2[cell * K + c] = row[K + c];
  }
}

template <typename T, bool GRAD>
int launch_backward(const BackwardArgs<T>& B, size_t smem,
                    cudaStream_t stream) {
  const long long batches = (B.m.np + 31) / 32;
  if (batches > 2147483647LL) return -1;
  const bool win = B.records != nullptr;
  const auto kernel = win ? march_backward_kernel<T, GRAD, true>
                          : march_backward_kernel<T, GRAD, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_PER_SM);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)batches, 32, smem, stream>>>(B);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !win) return (int)err;
  const int sw = 6 + 2 * B.m.margin;
  const int K = (GRAD ? 2 : 6) * sw * sw;
  const size_t row_smem =
      ROW_WARPS * (2 * (size_t)K + 32 * ROW_SLOT) * sizeof(T);
  if (row_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(window_cotangent_kernel<T, GRAD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)row_smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (B.ncells + ROW_WARPS - 1) / ROW_WARPS;
  if (blocks > 2147483647LL) return -1;
  window_cotangent_kernel<T, GRAD>
      <<<(unsigned)blocks, 32 * ROW_WARPS, row_smem, stream>>>(B);
  return (int)cudaGetLastError();
}

// The C entry of one scalar type. win1, win2: (ncells, K) window arrays;
// xk, ct, ct_in: (4, Np); key: (Np,) int32, the cell of the packet at each
// position, sorted when perm (int64, the packet at each position) is given;
// ends: (ncells,) int64, the number of positions in cells 0..c; records:
// (ceil(Np / 32), 3 nsub, 32, RECORD) scratch, and cw1, cw2: (ncells, K), all four with
// perm, or all null for the packets' cotangents alone (position = packet);
// stage: copy the rows into shared memory. Launches the packets' kernel
// and, with cw1, the rows' kernel after it. Returns cudaGetLastError()
// after the launches, -1 for a configuration with no kernel, -2 where the
// staged rows pass SMEM_PER_SM.
template <typename T>
int launch_march_backward(const void* win1, const void* win2, const void* xk,
                          const void* key, const void* perm, const void* ends,
                          const void* ct, void* ct_in, void* records,
                          void* cw1, void* cw2, long long np, long long ncells,
                          double sub_dt, int nx, int ny, double inv_dx,
                          double inv_dy, double f2, double gH, int margin,
                          int nsub, int nf, int stage, void* stream) {
  if (np == 0) return 0;
  const bool win = cw1 != nullptr;
  if (nsub < 1 || nsub > BWD_MAX_SUBSTEPS || margin < 0 ||
      (nf != 2 && nf != 6) || ncells != (long long)nx * ny ||
      win != (cw2 && perm && ends && records))
    return -1;
  BackwardArgs<T> B;
  MarchArgs<T>& A = B.m;
  A.p1 = (const T*)win1;
  A.p2 = (const T*)win2;
  const int sw = 6 + 2 * margin;
  const int K = (nf == 2 ? 2 : 6) * sw * sw;
  A.xk = (const T*)xk;
  A.oi = nullptr;
  A.oj = nullptr;
  A.out = nullptr;
  A.ov = nullptr;
  A.np = np;
  A.sub_dt = sub_dt;
  A.sub_dt_e = nullptr;
  A.member_win = 0;
  A.nx = nx;
  A.ny = ny;
  A.inv_dx = inv_dx;
  A.inv_dy = inv_dy;
  A.f2 = f2;
  A.gH = gH;
  A.margin = margin;
  A.nsub = nsub;
  B.key = (const int*)key;
  B.perm = win ? (const long long*)perm : nullptr;
  B.ends = (const long long*)ends;
  B.ct = (const T*)ct;
  B.ct_in = (T*)ct_in;
  B.records = win ? (T*)records : nullptr;
  B.cw1 = (T*)cw1;
  B.cw2 = (T*)cw2;
  B.ncells = ncells;
  B.stage = stage;
  const size_t smem =
      ((stage ? (2 * (size_t)K + 1) * 32 : 0) + (win ? 32 * RECORD : 0))
      * sizeof(T);
  if (smem > SMEM_PER_SM) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  return nf == 2 ? launch_backward<T, true>(B, smem, s)
                 : launch_backward<T, false>(B, smem, s);
}

#define SWR_MARCH_BACKWARD_ENTRY(name, T)                                    \
  int name(const void* win1, const void* win2, const void* xk,               \
           const void* key, const void* perm, const void* ends,              \
           const void* ct, void* ct_in, void* records, void* cw1, void* cw2, \
           long long np, long long ncells, double sub_dt, int nx, int ny,    \
           double inv_dx, double inv_dy, double f2, double gH, int margin,   \
           int nsub, int nf, int stage, void* stream) {                      \
    return launch_march_backward<T>(win1, win2, xk, key, perm, ends, ct,     \
                                    ct_in, records, cw1, cw2, np, ncells,    \
                                    sub_dt, nx, ny, inv_dx, inv_dy, f2, gH,  \
                                    margin, nsub, nf, stage, stream);        \
  }

}  // namespace
