// The fused wave-packet march (march.cuh) on its third route: a persistent
// block on every SM whose producer warps copy the window rows of the next
// packets into a ring of shared-memory slots while its consumer warps march
// the packets whose rows have landed.
//
// Replaces, as the staged route does, the TPU Pallas kernel `_march_kernel`
// of swraytracing_tpu/ops/pallas_window.py, alone (`march_pallas`) and over
// an ensemble's members under jax.vmap (parallel/ensemble.py). Plain
// versions: march_reference, march_gathered_reference and
// march_gathered_batched_reference in swraytracing_torch/ops/march_window.py.
//
// Bound on this card: bytes (a packet's row of both snapshots, 2K values,
// against a few thousand operations). What the route is for: each one-warp
// block of the staged route copies its 32 rows, waits for them, and only
// then computes, so a warp's copy and its arithmetic take turns. Here the
// two go on side by side in every SM.
//
// Design. The work is numbered in batches of 32 packets over all members
// (batch b is member b / ceil(Np/32), packets 32 (b mod ceil(Np/32))
// onwards); block x of the one-block-per-SM grid takes batches x, x +
// gridDim.x, ..., so no partial last wave is left either. Shared memory
// holds S slots, each one batch's 32 rows in the staged route's layout
// (both snapshots, rows 2K + 1 elements apart: what eval_fields<..., true>
// reads without bank conflicts), S as many as fit beside two 8-byte
// barriers each. Warps 0 to RING_PRODUCERS - 1 are the producers: for
// each of the block's batches in turn each waits for the slot to be empty,
// issues the element-sized asynchronous copies of every RING_PRODUCERS-th
// of its 32 rows (the copies of stage_rows: lanes on consecutive elements
// of one row) and has the slot's `full` barrier count its lanes once their
// copies have landed (cp.async.mbarrier.arrive.noinc). Consumer warp c of
// C takes the block's batches c, c + C, ...: it waits for the slot to be
// full, marches its lane's packet through march_packet (the staged
// kernel's own function, so the same bits), and counts its lanes on the
// slot's `empty` barrier. While C warps compute, S - C slots fill.
//
// Phases. A barrier's wait names only the parity of the phase it waits
// for, so a waiter must never meet the barrier two phases behind. Every
// producer meets every phase of every slot in turn, and arrives on a slot
// only after its wait for the slot's previous round. A consumer waiting
// for the block's batch k in slot k mod S has seen batch k - C full; with
// C < S, batch k - S came before it from every producer, and a lane's
// tracked arrival follows all of the lane's earlier copies, so that fill
// is complete: the slot is in the phase of batch k or has finished it.
// Hence C < S is required; the caller's default is C = S - 3.

#pragma once

#include <stdint.h>

#include "march.cuh"

namespace {

// Shared memory a slot takes beside its rows: its `full` and `empty`
// barriers (ring_slots in march_window.py counts the same).
constexpr size_t RING_BARRIER_BYTES = 16;

// Producer warps of a block: one for each of an SM's four sub-partitions.
// A sub-partition issues element-sized cp.async copies slowly: with one
// producer warp the kernel's time hardly moved with the number of stage
// evaluations (the copy set it), with four it moves with them.
constexpr int RING_PRODUCERS = 4;

// Threads of a block at most: the registers a consumer takes (up to 170
// for float, 213 for double) fit beside one block's warps.
template <typename T>
constexpr int RING_MAX_THREADS = sizeof(T) == 4 ? 384 : 288;

template <typename T>
size_t ring_slot_bytes(int K) {
  return 32 * (2 * (size_t)K + 1) * sizeof(T) + RING_BARRIER_BYTES;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// An arrival on `bar` once all of this thread's earlier cp.async copies
// have landed; the barrier's count includes it (noinc).
__device__ __forceinline__ void bar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of `bar` whose parity is `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

template <typename T, bool GRAD, int STEPPER>
__global__ void __launch_bounds__(RING_MAX_THREADS<T>, 1)
    march_ring_kernel(const MarchArgs<T> A0, long long per_member,
                      long long batches, int slots) {
  extern __shared__ __align__(16) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring);
  uint64_t* empty = full + slots;
  T* rows = reinterpret_cast<T*>(empty + slots);
  const int sw = 6 + 2 * A0.margin;
  const int K = (GRAD ? 2 : 6) * sw * sw;
  const int stride = 2 * K + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      bar_init(full + s, 32 * RING_PRODUCERS);  // the producers' lanes
      bar_init(empty + s, 32);  // a consumer's lanes
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < RING_PRODUCERS) {  // a producer
    int s = 0;
    unsigned round = 0;  // times around the ring
    for (long long b = blockIdx.x; b < batches; b += gridDim.x) {
      const long long member = b / per_member;
      const long long first = (b - member * per_member) * 32;
      const int nrows = (int)min(32LL, A0.np - first);
      int oi = 0, oj = 0;
      if (lane < nrows) {
        oi = A0.oi[member * A0.np + first + lane];
        oj = A0.oj[member * A0.np + first + lane];
      }
      const long long row =
          A0.gathered ? (long long)oi * A0.ny + oj : first + lane;
      const T* p1 = A0.p1 + member * A0.member_win;
      const T* p2 = A0.p2 + member * A0.member_win;
      T* dst = rows + (size_t)s * 32 * stride;
      bar_wait(empty + s, (round & 1) ^ 1);  // round 0 passes at once
      for (int r = warp; r < nrows; r += RING_PRODUCERS) {
        // every lane takes part in the shuffle: nrows is the same for all
        const long long at = __shfl_sync(0xffffffffu, row, r) * A0.sp;
        T* d = dst + r * stride;
        for (int c = lane; c < K; c += 32) {
          __pipeline_memcpy_async(d + c, p1 + at + c, sizeof(T));
          __pipeline_memcpy_async(d + K + c, p2 + at + c, sizeof(T));
        }
      }
      bar_arrive_on_copies(full + s);
      if (++s == slots) {
        s = 0;
        ++round;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");  // none outlives it
    return;
  }

  const int consumers = blockDim.x / 32 - RING_PRODUCERS;
  for (long long k = warp - RING_PRODUCERS;; k += consumers) {
    const long long b = blockIdx.x + k * gridDim.x;
    if (b >= batches) break;
    const int s = (int)(k % slots);
    bar_wait(full + s, (unsigned)(k / slots) & 1);
    const long long member = b / per_member;
    MarchArgs<T> A = A0;  // this batch's member, as march_kernel forms it
    A.p1 += member * A0.member_win;
    A.p2 += member * A0.member_win;
    A.xk += member * 4 * A0.np;
    A.out += member * 4 * A0.np;
    A.oi += member * A0.np;
    A.oj += member * A0.np;
    A.ov += member * A0.np;
    if (A0.sub_dt_e) A.sub_dt = A0.sub_dt_e[member];
    const long long pkt = (b - member * per_member) * 32 + lane;
    if (pkt < A.np) {
      const T* r1 = rows + ((size_t)s * 32 + lane) * stride;
      march_packet<T, GRAD, STEPPER, true>(A, r1, r1 + K, A.oi[pkt],
                                           A.oj[pkt], pkt);
    }
    bar_arrive(empty + s);
  }
}

// Streaming multiprocessors of the current device, read once per device.
cudaError_t ring_sm_count(int* sms) {
  static int count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && count[dev] > 0) {
    *sms = count[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev >= 0 && dev < 64) count[dev] = *sms;
  return err;
}

// One block per SM (fewer where there are fewer batches) of `threads` =
// 32 x (consumers + 1) threads. Returns -2 where fewer than two slots fit,
// -1 for consumers outside [1, slots).
template <typename T, bool GRAD, int STEPPER>
int launch_ring_kernel(const MarchArgs<T>& A, int members, int threads,
                       cudaStream_t stream) {
  const int sw = 6 + 2 * A.margin;
  const size_t slot = ring_slot_bytes<T>((GRAD ? 2 : 6) * sw * sw);
  const int slots = (int)(SMEM_PER_SM / slot);
  if (slots < 2) return -2;
  const int consumers = threads / 32 - RING_PRODUCERS;
  if (consumers < 1 || consumers >= slots || threads > RING_MAX_THREADS<T>)
    return -1;
  int sms = 0;
  cudaError_t err = ring_sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long per_member = (A.np + 31) / 32;
  const long long batches = per_member * members;
  const unsigned grid = (unsigned)(batches < sms ? batches : sms);
  const size_t smem = slots * slot;
  err = cudaFuncSetAttribute(
      march_ring_kernel<T, GRAD, STEPPER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_PER_SM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(march_ring_kernel<T, GRAD, STEPPER>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  march_ring_kernel<T, GRAD, STEPPER>
      <<<grid, threads, smem, stream>>>(A, per_member, batches, slots);
  return (int)cudaGetLastError();
}

}  // namespace
