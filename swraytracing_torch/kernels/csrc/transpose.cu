// Tiled matrix transpose for Hopper (sm_90a): contiguous (A, B) ->
// contiguous (B, A), any A and B, float32 and float64.
//
// Replaces the TPU Pallas kernel `_t_kernel` (launched by
// `_pallas_transpose_impl` / `pallas_transpose`) of
// swraytracing_tpu/ops/pallas_window.py, which turns the (K, ncells)
// window array into (ncells, K) gather rows once per flow step. Its plain
// PyTorch version is `transpose_reference` in
// swraytracing_torch/ops/march_window.py.
//
// Bound on this card: bytes (every element is read once and written
// once; there is no arithmetic). A 32x32 tile goes through shared memory
// so that both the read and the write are coalesced along the fastest
// axis of their array; the tile's rows are padded to 33 elements so the
// transposed read hits 32 different banks. The TPU kernel needed one axis
// to be a multiple of its block; this one masks ragged edges itself.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;  // blockDim.y: each thread moves TILE/ROWS elements

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
transpose_kernel(const T* __restrict__ in, T* __restrict__ out, long long A,
                 long long B, long long tiles_b) {
  __shared__ T tile[TILE][TILE + 1];
  in += blockIdx.y * A * B;  // this block's matrix
  out += blockIdx.y * A * B;
  const long long bid = blockIdx.x;
  const long long a0 = (bid / tiles_b) * TILE;  // first row of `in`
  const long long b0 = (bid % tiles_b) * TILE;  // first column of `in`
  for (int j = threadIdx.y; j < TILE; j += ROWS) {
    const long long a = a0 + j, b = b0 + threadIdx.x;
    if (a < A && b < B) tile[j][threadIdx.x] = in[a * B + b];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < TILE; j += ROWS) {
    const long long b = b0 + j, a = a0 + threadIdx.x;
    if (a < A && b < B) out[b * A + a] = tile[threadIdx.x][j];
  }
}

template <typename T>
int launch(const void* in, void* out, int E, long long A, long long B,
           cudaStream_t stream) {
  const long long tiles_a = (A + TILE - 1) / TILE;
  const long long tiles_b = (B + TILE - 1) / TILE;
  const long long blocks = tiles_a * tiles_b;
  if (blocks == 0 || E == 0) return 0;
  if (blocks > 2147483647LL || E < 0 || E > 65535) return -1;
  transpose_kernel<T><<<dim3((unsigned)blocks, (unsigned)E), dim3(TILE, ROWS),
                        0, stream>>>((const T*)in, (T*)out, A, B, tiles_b);
  return (int)cudaGetLastError();
}

int launch_dtype(int dtype, const void* in, void* out, int E, long long A,
                 long long B, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(in, out, E, A, B, s);
  if (dtype == 1) return launch<double>(in, out, E, A, B, s);
  return -1;
}

}  // namespace

// dtype: 0 float32, 1 float64. Returns cudaGetLastError() after the
// launch, or -1 for a configuration with no kernel.
extern "C" int swr_transpose(int dtype, const void* in, void* out,
                             long long A, long long B, void* stream) {
  return launch_dtype(dtype, in, out, 1, A, B, stream);
}

// E matrices (E, A, B) -> (E, B, A), E at most 65535; as swr_transpose.
extern "C" int swr_transpose_batched(int dtype, const void* in, void* out,
                                     int E, long long A, long long B,
                                     void* stream) {
  return launch_dtype(dtype, in, out, E, A, B, stream);
}

// The runtime's text for an error code returned by the entries above.
extern "C" const char* swr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
