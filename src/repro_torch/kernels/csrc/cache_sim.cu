// Single-level set-associative LRU cache over a line-address trace.
//
// Replaces the Pallas TPU kernel `cache_sim` of
// src/repro/kernels/cache_sim.py (grid body `_cache_sim_kernel`).  It
// computes what the JAX oracle `repro.kernels.ref.cache_sim` computes, and
// the plain version it is held against, bit for bit, is
// repro_torch.kernels.cache_sim.cache_sim_ref:
//
//   for t = 1 .. N, a = addr[t - 1], set = a & (n_sets - 1):
//     hit  = some way of the set holds tag a
//     way  = the first such way on a hit, else the way of least use clock,
//            the lowest such way on ties (at start every clock is 0, so the
//            ways fill in order)
//     tags[set][way] = a; use[set][way] = t; hits[t - 1] = hit
//
// Allocate on miss, reads and writes alike.  Outputs: hits (N,), the final
// tags (n_sets, n_ways) (-1 = empty) and use clocks (n_sets, n_ways).  The
// wrapper rejects negative addresses (the Pallas body treats them as
// padding, the oracle as live lines), so none reaches the kernel.
//
// What bounds it: not bytes (16 bytes per access at most: the address, the
// hit flag, and the final state once; ~17 MB for the 2,097,150-access
// Table-I STREAM trace at 2048 x 16, 0.005 ms at 3.35 TB/s) but the serial
// chain: access t + 1 may touch the set that access t just wrote, so one
// warp walks the trace in order and each access waits for the loads of its
// set's row.
//
// What the design does about it (a simple first kernel, not yet a fast
// one):
//   * one block; its 256 threads initialise the state, then one warp walks
//     the trace with one lane per way (n_ways <= 32): the tag compare is one
//     ballot (__ffs gives the first hit way) and the victim one 5-step
//     shuffle reduction on (use, lane) pairs that prefers the lower way on
//     ties (mesi::warp_argmin, shared with the MESI kernels);
//   * lane w alone reads and writes way w of every set, so the state needs
//     no ordering between lanes; it lives in the output tensors in device
//     memory (256 KiB at 2048 x 16, more than a block's 227 KB of shared
//     memory), where the working rows stay in the L1 and L2 caches;
//   * each lane loads one of the next 32 addresses, and the warp hands them
//     out by shuffle; the hit flags of those 32 accesses are stored
//     together;
//   * accesses to different sets are independent: a later PR can split the
//     trace by set across blocks and SMs, keeping each set's order.

#include <cuda_runtime.h>

#include "mesi_access.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    cache_sim_kernel(const int* __restrict__ addr, int* __restrict__ hits,
                     int* __restrict__ tags, int* __restrict__ use,
                     long long n, int n_sets, int n_ways) {
  const long long cells = static_cast<long long>(n_sets) * n_ways;
  for (long long i = threadIdx.x; i < cells; i += kThreads) {
    tags[i] = -1;
    use[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const bool way_lane = lane < n_ways;
  for (long long base = 0; base < n; base += 32) {
    const int count = static_cast<int>(n - base < 32 ? n - base : 32);
    const int mine = lane < count ? addr[base + lane] : 0;
    int hit_flag = 0;
    for (int j = 0; j < count; ++j) {
      const int a = __shfl_sync(kFull, mine, j);
      const long long row = static_cast<long long>(a & (n_sets - 1)) * n_ways;
      int tag = -1, clock = 0;
      if (way_lane) {
        tag = tags[row + lane];
        clock = use[row + lane];
      }
      const unsigned hit = __ballot_sync(kFull, way_lane && tag == a);
      const int way = hit != 0 ? __ffs(hit) - 1
                               : mesi::warp_argmin(clock, way_lane);
      if (lane == way) {
        tags[row + lane] = a;
        use[row + lane] = static_cast<int>(base + j + 1);
      }
      if (lane == j) hit_flag = hit != 0;
    }
    if (lane < count) hits[base + lane] = hit_flag;
  }
}

}  // namespace

// Returns a cudaError_t (0 = ok); cudaErrorInvalidValue for a geometry the
// kernel does not take (n_sets not a power of two, n_ways outside 1..32).
extern "C" int cache_sim(const int* addr, int* hits, int* tags, int* use,
                         long long n, int n_sets, int n_ways, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 0 || n_sets <= 0 || (n_sets & (n_sets - 1)) != 0 || n_ways < 1 ||
      n_ways > 32)
    return cudaErrorInvalidValue;
  cache_sim_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      addr, hits, tags, use, n, n_sets, n_ways);
  return cudaGetLastError();
}

extern "C" const char* cache_sim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
