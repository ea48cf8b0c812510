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
// L2). The TPU kernel pads the fields periodically beforehand, copies a
// block of rows into fast memory and reshapes it there, and needs nx to
// be a multiple of its block. Here a thread owns one window component
// k = (f, sx, sy) and walks over a run of consecutive cells, so the
// threads of a block write consecutive k of one row (coalesced: a row is
// 512 bytes at nf=2, margin 1, float32) and read short runs of the fields
// through the cache. The periodic wrap is done on the indices, so no
// padded copy exists. The window array is written exactly once; the
// two-pass route (shifted copies, then the tiled transpose) writes it
// twice and reads it once.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CELLS = 32;  // consecutive cells (rows of W) per block

template <typename T>
__global__ void __launch_bounds__(THREADS)
build_windows_kernel(const T* __restrict__ F, T* __restrict__ W, int nf,
                     int nx, int ny, int sw, int lo) {
  const int K = nf * sw * sw;
  const long long ncells = (long long)nx * ny;
  const long long c0 = (long long)blockIdx.x * CELLS;
  const long long c1 = c0 + CELLS < ncells ? c0 + CELLS : ncells;
  const int i_first = (int)(c0 / ny), j_first = (int)(c0 % ny);
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const int f = k / (sw * sw);
    const int r = k - f * sw * sw;
    const int sx = r / sw - lo, sy = r % sw - lo;  // in [-lo, lo + 1]
    const T* __restrict__ Ff = F + (long long)f * ncells;
    int i = i_first, j = j_first;
#pragma unroll 4
    for (long long c = c0; c < c1; ++c) {
      int ii = i + sx;  // |sx| <= nx: one wrap is enough
      if (ii < 0) ii += nx;
      if (ii >= nx) ii -= nx;
      int jj = j + sy;
      if (jj < 0) jj += ny;
      if (jj >= ny) jj -= ny;
      W[c * K + k] = __ldg(Ff + (long long)ii * ny + jj);
      if (++j == ny) {
        j = 0;
        ++i;
      }
    }
  }
}

template <typename T>
int launch(const void* F, void* W, int nf, int nx, int ny, int sw, int lo,
           cudaStream_t stream) {
  const long long ncells = (long long)nx * ny;
  const long long blocks = (ncells + CELLS - 1) / CELLS;
  if (blocks == 0 || nf == 0) return 0;
  if (blocks > 2147483647LL) return -1;
  build_windows_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)F, (T*)W, nf, nx, ny, sw, lo);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float64. sw = window width SW, lo = order + margin
// (the window reaches from -lo to sw - 1 - lo around a cell). Returns
// cudaGetLastError() after the launch, or -1 for a configuration with no
// kernel (a window wider than the grid, an unknown dtype).
extern "C" int swr_build_windows(int dtype, const void* F, void* W, int nf,
                                 int nx, int ny, int sw, int lo,
                                 void* stream) {
  if (nf < 0 || nx < 1 || ny < 1 || sw < 1 || lo < 0 || lo >= sw) return -1;
  const int hi = sw - 1 - lo;  // the window's reach to the right, >= lo
  if (hi > nx || hi > ny || lo > hi) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(F, W, nf, nx, ny, sw, lo, s);
  if (dtype == 1) return launch<double>(F, W, nf, nx, ny, sw, lo, s);
  return -1;
}
