// Fused ray march through a frozen gridded flow for Hopper (sm_90a): every
// packet takes `nsteps` Strang steps (half drift, kick, half drift) with
// its state in registers, in one launch per segment of steps, the packets
// ordered by the cell they stand in.
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
// Bound on this card: operations by the count of adds and multiplies,
// since the bytes that must move are only the packet state and the grids
// once. What really holds it is the stencil: every step a packet reads 36
// nodes of six fields through L1, and an SM's L1 answers about one cache
// line (128 bytes) a cycle. A load instruction of a warp costs as many
// cycles as it touches lines, so the time follows the number of distinct
// lines the 32 packets of a warp ask for, at best the 128 bytes a cycle
// of the reads themselves (about four times the operations bound).
//
// Design. The TPU kernel holds the six grids in fast memory per block of
// packets, which limits it to grids of about 192^2. Here one thread owns
// one packet and keeps x, k in registers over a segment of steps; the
// grids (6 MB at 512^2 in float32) are read through L1/L2 with __ldg, 36
// nodes per step. The wrapper hands the grids over node-major, (nx, ny, 8)
// with the six fields of a node side by side and two lanes of padding: a
// node is one aligned 32-byte sector in float32 (two in float64) read by
// 16-byte loads, 72 load instructions a step where the field-major
// (6, nx, ny) layout takes 216.
//
// Packets ordered by cell. A warp whose packets lie anywhere on the grid
// touches 32 lines with every load. So the packets are marched in the
// order of their cells: `cell_histogram_kernel` gives every packet the
// row-major index i0*ny + j0 of the cell it stands in (the same division,
// floored modulo and integer wrap as the march, so the key lies in
// [0, nx*ny) whatever x holds) and counts the packets of each cell;
// the wrapper turns the counts into the cells' end offsets with one
// cumulative sum (torch.cumsum, plain tensor code); `cell_scatter_kernel`
// hands every packet a slot below its cell's end (an atomic decrement:
// the order inside a cell is free) and writes the permutation. No
// permuted copy of the state exists: thread p of the march reads packet
// perm[p] and writes its result back to perm[p], so the results stand in
// the caller's order, and a packet's arithmetic is the same whichever
// thread runs it: the ordered march equals the unordered one bit for bit.
// With a few packets a cell a warp then covers a few neighbouring cells
// of one grid row, whose stencils share their lines.
//
// Segments. Neighbours in that order part at up to twice the group speed,
// so the wrapper splits the steps into segments (their length from host
// scalars alone, see ops/march_rays.py), orders anew before each and
// launches the march once per segment; the state crosses in device memory
// at full precision, in place, so the split moves no bit either. The last
// block masks its ragged tail (the TPU wrapper pads with dummy packets).

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
  const int* perm;  // (Np,) thread p marches packet perm[p]; null: packet p
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

// x0, k0 may be xo, ko: a thread reads and writes its own packet only.
template <typename T, int ORDER>
__global__ void __launch_bounds__(256) march_rays_kernel(RayArgs<T> A) {
  constexpr int S = 2 * ORDER + 2;
  const long long thread = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (thread >= A.np) return;  // ragged last block
  const long long pkt = A.perm ? A.perm[thread] : thread;
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

// The cell a coordinate stands in, in [0, n): the march's own division,
// floored modulo, floor and integer wrap (a NaN lands in cell 0).
template <typename T>
__device__ __forceinline__ int cell_of(T x, T dx, int n) {
  return wrap_index(int(floor_(floored_mod(x / dx, T(n)))), n);
}

// key[p] = i0*ny + j0 of packet p, and count[key] += 1 (count starts 0).
template <typename T>
__global__ void __launch_bounds__(256)
cell_histogram_kernel(const T* __restrict__ x, long long np, int nx, int ny,
                      double dx, double dy, int* __restrict__ key,
                      int* __restrict__ count) {
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= np) return;
  const int c = cell_of(x[p], T(dx), nx) * ny + cell_of(x[np + p], T(dy), ny);
  key[p] = c;
  atomicAdd(count + c, 1);
}

// end[c] holds the number of packets in cells 0..c (the inclusive sum of
// the counts): each packet takes the next slot below its cell's end.
__global__ void __launch_bounds__(256)
cell_scatter_kernel(const int* __restrict__ key, long long np,
                    int* __restrict__ end, int* __restrict__ perm) {
  const long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (p >= np) return;
  perm[atomicSub(end + key[p], 1) - 1] = (int)p;
}

constexpr int ORDER_THREADS = 256;

inline bool blocks_for(long long np, int threads, unsigned* blocks) {
  const long long b = (np + threads - 1) / threads;
  *blocks = (unsigned)b;
  return b <= 2147483647LL;
}

template <typename T>
int launch_histogram(const void* x, long long np, int nx, int ny, double dx,
                     double dy, void* key, void* count, void* stream) {
  unsigned blocks;
  if (nx < 1 || ny < 1 || (long long)nx * ny > 2147483647LL || np < 0 ||
      np > 2147483647LL || !blocks_for(np, ORDER_THREADS, &blocks))
    return -1;
  if (np == 0) return 0;
  cell_histogram_kernel<T><<<blocks, ORDER_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, np, nx, ny, dx, dy, (int*)key, (int*)count);
  return (int)cudaGetLastError();
}

// order: the stencil half-width, nodes -order..order+1 (1, 2 or 3).
// Returns cudaGetLastError() after the launch, or -1 for a configuration
// with no kernel.
template <typename T>
int launch(const void* F, const void* x0, const void* k0, void* xo, void* ko,
           const void* perm, long long np, int nx, int ny, double dx,
           double dy, double dt, double f2, double gH, int nsteps, int order,
           int threads, void* stream) {
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
  A.perm = (const int*)perm;
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

// perm: (Np,) int32 permutation (thread p marches packet perm[p]) or null.
extern "C" int swr_march_rays_f32(const void* F, const void* x0,
                                  const void* k0, void* xo, void* ko,
                                  const void* perm, long long np, int nx,
                                  int ny, double dx, double dy, double dt,
                                  double f2, double gH, int nsteps, int order,
                                  int threads, void* stream) {
  return launch<float>(F, x0, k0, xo, ko, perm, np, nx, ny, dx, dy, dt, f2,
                       gH, nsteps, order, threads, stream);
}

extern "C" int swr_march_rays_f64(const void* F, const void* x0,
                                  const void* k0, void* xo, void* ko,
                                  const void* perm, long long np, int nx,
                                  int ny, double dx, double dy, double dt,
                                  double f2, double gH, int nsteps, int order,
                                  int threads, void* stream) {
  return launch<double>(F, x0, k0, xo, ko, perm, np, nx, ny, dx, dy, dt, f2,
                        gH, nsteps, order, threads, stream);
}

// The packets' cells: key (Np,) int32 = i0*ny + j0 of x (2, Np), and
// count (nx*ny,) int32, zero on entry, += the packets of each cell.
// dtype: 0 float32, 1 float64. Returns cudaGetLastError(), or -1 where
// Np or nx*ny does not fit 31 bits.
extern "C" int swr_rays_cell_histogram(int dtype, const void* x, long long np,
                                       int nx, int ny, double dx, double dy,
                                       void* key, void* count, void* stream) {
  if (dtype == 0)
    return launch_histogram<float>(x, np, nx, ny, dx, dy, key, count, stream);
  if (dtype == 1)
    return launch_histogram<double>(x, np, nx, ny, dx, dy, key, count,
                                    stream);
  return -1;
}

// The permutation by cell: perm (Np,) int32 from key (Np,) and end
// (nx*ny,) int32, the inclusive cumulative sum of the histogram's counts
// (overwritten: it ends as the cells' start offsets).
extern "C" int swr_rays_cell_scatter(const void* key, long long np, void* end,
                                     void* perm, void* stream) {
  unsigned blocks;
  if (np < 0 || np > 2147483647LL || !blocks_for(np, ORDER_THREADS, &blocks))
    return -1;
  if (np == 0) return 0;
  cell_scatter_kernel<<<blocks, ORDER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)key, np, (int*)end, (int*)perm);
  return (int)cudaGetLastError();
}
