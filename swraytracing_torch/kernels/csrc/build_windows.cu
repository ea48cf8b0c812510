// One-kernel window build for Hopper (sm_90a): (nf, nx, ny) fields ->
// (nx*ny, K) gather rows, K = nf*SW*SW,
//   W[i*ny + j, (f*SW + sx)*SW + sy] = F[f, (i + sx - lo) mod nx,
//                                          (j + sy - lo) mod ny],
// float32 and float64, any nx, ny and any window that fits the grid.
//
// Replaces the TPU Pallas kernel `_build_kernel` (launched by
// `build_windows_fused`) of swraytracing_tpu/ops/pallas_window.py. Its
// plain PyTorch version is `build_windows_reference` in
// swraytracing_torch/ops/march_window.py; the result is the same bit for
// bit (values are copied, never computed).
//
// Bound on this card: bytes, and almost all of them written (the window
// array is SW*SW times the fields; the fields are a few MB and stay in
// L2). What holds a build back is therefore how the window array leaves
// the SMs: the number of store instructions and of cache lines each of
// them touches, and how many bytes a block keeps in flight. The TPU
// kernel pads the fields periodically beforehand, copies a block of rows
// into fast memory and reshapes it there, and needs nx to be a multiple
// of its block.
//
// Design. The window array is written in 16-byte stores, flat: SW is even,
// so K is a multiple of 4 and W is an array of 16-byte pieces (a float4 of
// four consecutive components, a double2 of two); a thread owns the
// pieces of one position q in the row, for a run of cells, and
// neighbouring threads own neighbouring pieces, so every warp writes 512
// consecutive bytes an instruction (one whole row at nf=2, margin 1,
// float32) whatever K is, and every thread of a block works. A block takes
// a run of up to 32 cells of one grid row i. The SW rows i-lo..i+hi of
// each field that these cells' windows are cut from (the run's columns and
// SW - 1 more) are first copied into shared memory with coalesced loads,
// the periodic wrap done on the indices (no padded copy exists); the
// values of a piece are then shared-memory reads at offsets worked out
// once per thread (a float4 may straddle a window row when SW is not a
// multiple of 4, so each component has its own). A cell's window overlaps
// its neighbour's in all but one column, so the fields are read from L2
// about (32 + SW - 1)/32 * SW times, a sixth of what is written at SW = 8.
// The run is halved until the tile fits in 48 KB of shared memory; a
// window so large that not even a run of 8 cells fits is read per thread
// through the cache instead, by the same thread mapping and the same
// stores (half as fast at the main shape, where it is not taken). The
// window array is written exactly once; the two-pass route (shifted
// copies, then the tiled transpose) writes it twice and reads it once.
//
// Members (B5: `_build_kernel` under `jax.vmap` in the JAX package's
// parallel/ensemble.py): swr_build_windows_batched builds the window
// arrays of E members' fields in one launch; blockIdx.y is the member,
// whose fields start f_member elements after the previous member's and
// whose window array ncells*K after. Each is built exactly as a single
// launch would.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;    // at most, per block: QX * CY below
constexpr int RUN = 32;         // cells of one grid row per block, at most
constexpr int MIN_RUN = 8;      // a shorter run than this is not staged
constexpr int STATIC_SMEM = 49152;

// Components in a 16-byte piece, and its store.
template <typename T>
struct Piece {
  static constexpr int N = 16 / sizeof(T);
};
__device__ __forceinline__ void store_piece(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_piece(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// One wrap is enough: a window reaches at most n cells either way.
__device__ __forceinline__ int wrap_once(int v, int n) {
  if (v < 0) v += n;
  if (v >= n) v -= n;
  return v;
}

// Block b: cells j0..j0+run-1 of grid row i, where i = b / runs_per_row
// and j0 = (b % runs_per_row) * run_max.
// Threads (tx, ty): tx walks the pieces of a row (q = tx, tx + QX, ...),
// ty the cells of the run (dj = ty, ty + CY, ...); blockDim.x = QX =
// min(K/N, 256) with N components a piece, so a block's threads in launch
// order write consecutive pieces. Shared memory (STAGED): nf*SW rows of
// `pitch` elements.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(THREADS)
build_windows_kernel(const T* __restrict__ F, T* __restrict__ W, int nf,
                     int nx, int ny, int sw, int lo, int run_max, int pitch,
                     long long f_member) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  constexpr int N = Piece<T>::N;
  const int K = nf * sw * sw, KN = K / N;
  const long long ncells = (long long)nx * ny;
  F += blockIdx.y * f_member;  // this block's member
  W += blockIdx.y * ncells * K;
  const int runs_per_row = (ny + run_max - 1) / run_max;
  const int i = blockIdx.x / runs_per_row;
  const int j0 = (blockIdx.x - i * runs_per_row) * run_max;
  const int run = j0 + run_max <= ny ? run_max : ny - j0;
  const int tx = threadIdx.x, ty = threadIdx.y;

  if (STAGED) {
    // tile[(f*sw + sx)*pitch + col] = F[f, i+sx-lo, j0+col-lo], periodic
    const int cols = run + sw - 1;
    for (int r = ty; r < nf * sw; r += blockDim.y) {
      const int f = r / sw, sx = r - f * sw;
      const T* __restrict__ row =
          F + f * ncells + (long long)wrap_once(i + sx - lo, nx) * ny;
      for (int col = tx; col < cols; col += blockDim.x)
        tile[r * pitch + col] = __ldg(row + wrap_once(j0 + col - lo, ny));
    }
    __syncthreads();
  }

  T* __restrict__ Wrun = W + ((long long)i * ny + j0) * K;
  for (int q = tx; q < KN; q += blockDim.x) {
    // the components k = N q .. N q + N - 1, each (f, sx, sy) on its own
    int f = (N * q) / (sw * sw);
    int r = N * q - f * sw * sw;
    int sx = r / sw, sy = r - sx * sw;
    int tile_off[N];        // STAGED: offset of the component at dj = 0
    long long row_off[N];   // else: start of its field row, and its column
    int col_off[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (STAGED) {
        tile_off[e] = (f * sw + sx) * pitch + sy;
      } else {
        row_off[e] = f * ncells + (long long)wrap_once(i + sx - lo, nx) * ny;
        col_off[e] = j0 + sy - lo;
      }
      if (++sy == sw) {
        sy = 0;
        if (++sx == sw) sx = 0, ++f;
      }
    }
    for (int dj = ty; dj < run; dj += blockDim.y) {
      T v[N];
#pragma unroll
      for (int e = 0; e < N; ++e)
        v[e] = STAGED ? tile[tile_off[e] + dj]
                      : __ldg(F + row_off[e] +
                              wrap_once(col_off[e] + dj, ny));
      store_piece(Wrun + (long long)dj * K + N * q, v);
    }
  }
}

template <typename T>
int launch(const void* F, void* W, int E, long long f_member, int nf, int nx,
           int ny, int sw, int lo, cudaStream_t stream) {
  if (nf == 0 || E == 0) return 0;
  const int KN = nf * sw * sw / Piece<T>::N;
  // the longest run whose tile fits; an odd pitch spreads the window rows
  // over the banks
  int run = RUN;
  while (run > MIN_RUN &&
         (size_t)nf * sw * ((run + sw - 1) | 1) * sizeof(T) > STATIC_SMEM)
    run /= 2;
  const int pitch = (run + sw - 1) | 1;
  const size_t smem = (size_t)nf * sw * pitch * sizeof(T);
  const bool staged = smem <= STATIC_SMEM;
  if (!staged) run = RUN;  // nothing to fit
  const int qx = KN < THREADS ? KN : THREADS;
  const int cy = THREADS / qx < run ? THREADS / qx : run;
  const dim3 block(qx, cy);
  const long long blocks = (long long)((ny + run - 1) / run) * nx;
  if (blocks > 2147483647LL) return -1;
  const dim3 grid((unsigned)blocks, (unsigned)E);
  if (staged)
    build_windows_kernel<T, true><<<grid, block, smem, stream>>>(
        (const T*)F, (T*)W, nf, nx, ny, sw, lo, run, pitch, f_member);
  else
    build_windows_kernel<T, false><<<grid, block, 0, stream>>>(
        (const T*)F, (T*)W, nf, nx, ny, sw, lo, run, pitch, f_member);
  return (int)cudaGetLastError();
}

int launch_checked(int dtype, const void* F, void* W, int E,
                   long long f_member, int nf, int nx, int ny, int sw,
                   int lo, void* stream) {
  if (nf < 0 || nx < 1 || ny < 1 || sw < 2 || sw % 2 || lo < 0 || lo >= sw)
    return -1;
  if (E < 0 || E > 65535) return -1;
  const int hi = sw - 1 - lo;  // the window's reach to the right, >= lo
  if (hi > nx || hi > ny || lo > hi) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(F, W, E, f_member, nf, nx, ny, sw, lo, s);
  if (dtype == 1)
    return launch<double>(F, W, E, f_member, nf, nx, ny, sw, lo, s);
  return -1;
}

}  // namespace

// dtype: 0 float32, 1 float64. sw = window width SW (even), lo = order +
// margin (the window reaches from -lo to sw - 1 - lo around a cell).
// Returns cudaGetLastError() after the launch, or -1 for a configuration
// with no kernel (a window wider than the grid, an odd SW, an unknown
// dtype).
extern "C" int swr_build_windows(int dtype, const void* F, void* W, int nf,
                                 int nx, int ny, int sw, int lo,
                                 void* stream) {
  return launch_checked(dtype, F, W, 1, 0, nf, nx, ny, sw, lo, stream);
}

// E members at once, E at most 65535: member m's fields at F + m*f_member
// (each (nf, nx, ny) contiguous), its window array at W + m*nx*ny*K. As
// swr_build_windows otherwise.
extern "C" int swr_build_windows_batched(int dtype, const void* F, void* W,
                                         int E, long long f_member, int nf,
                                         int nx, int ny, int sw, int lo,
                                         void* stream) {
  return launch_checked(dtype, F, W, E, f_member, nf, nx, ny, sw, lo, stream);
}
