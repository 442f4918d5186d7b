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
// chain of each set: access t + 1 may touch the set that access t just
// wrote.  Sets never interact (one level, and the clock is the access's
// position in the whole trace, not a count kept per set), so the chains of
// different sets are independent and the least time is the longest chain
// times the latency of one access on it.
//
// What the design does about it:
//   * a bucket pre-pass groups the accesses by chain a & (m - 1),
//     m = 2**bits, keeping trace order and each access's position, as
//     records mesi_chain.cuh's chains read: the MESI kernels' per-tile
//     histogram (mesi::bucket_hist), then a scan and an ordered scatter of
//     K6's own.  The MESI scan is one block per row, which is fine for 128
//     chains of a few rows but, for one row of 2048 chains, has one block
//     read the (tiles, chains) counts one after another (the `mesi_prepass`
//     variant of tools/k4k6_variants.py times it).  Here one block per 32 chains scans their columns (32 warps
//     over the tiles) and one block the chain totals, so the tiles can be
//     small (more scatter warps, each with fewer entries) at little cost
//     in the scan.  The scatter (one warp per tile, ranks among equal
//     chains by __match_any_sync, as the MESI one) loads its next 256
//     addresses together before it places them, where the MESI one waits
//     for each 32, and reads no is_write, core or tier planes;
//   * one warp per chain, kChainWarps chain warps per block: 2048 chains at
//     the Table-I L2 (2048 x 16), all resident on the card at once.  The
//     lanes load the next 32 records together and hand them out by
//     shuffle; each hit flag is stored at its access's position;
//   * lane w holds way w of the set (n_ways <= 32; lanes past n_ways are
//     masked): the tag compare is one ballot (__ffs gives the first hit
//     way), the victim one min-reduction (__reduce_min_sync) and one
//     ballot of the lanes holding it, whose __ffs is the lowest way on
//     ties, as mesi::warp_argmin's five shuffle steps give it;
//   * with one set per chain (n_sets <= 2**12) the set's tags and clocks
//     live in registers for the whole chain and are stored once; with more
//     sets than chains each chain's n_sets / m sets live in shared memory
//     (8 bytes per way per set), or, where they do not fit, in the output
//     tensors in device memory, where chains touch disjoint cells.

#include <climits>
#include <cuda_runtime.h>

#include "mesi_chain.cuh"

namespace {

using mesi::kFull;
using mesi::Rec;

// The way access `a` takes in the set whose ways the lanes hold as (tag,
// clock): the first way holding `a` (then *hit is true), else the lowest way
// of least clock.  Every lane gets the same answer.  The victim does not
// depend on `a`, so it is found beside the tag compare, not after it.
__device__ __forceinline__ int lru_way(int a, int tag, int clock,
                                       bool way_lane, bool* hit) {
  const unsigned match = __ballot_sync(kFull, way_lane && tag == a);
  const int least = __reduce_min_sync(kFull, way_lane ? clock : INT_MAX);
  const unsigned oldest = __ballot_sync(kFull, way_lane && clock == least);
  *hit = match != 0;
  return __ffs(match ? match : oldest) - 1;
}

// Walk a chain's records rec[cur, hi) in order, 32 at a time (the next 32
// load while these run): `access(a, t)` applies line `a` at clock t (the
// access's 1-based trace position) and returns its hit flag, which lands
// at hits[t - 1].  A full batch is unrolled, so the shuffles that hand out
// access j + 1 issue while access j's ballots are in flight.
template <class F>
__device__ __forceinline__ void walk(const Rec* __restrict__ rec, long cur,
                                     long hi, int* __restrict__ hits,
                                     int lane, F&& access) {
  Rec r = mesi::load_rec(rec, cur, hi, lane);
  while (cur < hi) {
    const int cnt = hi - cur < 32 ? static_cast<int>(hi - cur) : 32;
    const Rec next = mesi::load_rec(rec, cur + 32, hi, lane);
    int flag = 0;
    auto one = [&](int j) {
      const int pos = __shfl_sync(kFull, r.x, j);
      const int a = __shfl_sync(kFull, r.y, j);
      const bool hit = access(a, pos + 1);
      if (lane == j) flag = hit;
    };
    if (cnt == 32) {
#pragma unroll
      for (int j = 0; j < 32; ++j) one(j);
    } else {
      for (int j = 0; j < cnt; ++j) one(j);
    }
    if (lane < cnt) hits[r.x] = flag;
    cur += 32;
    r = next;
  }
}

// ---------------------------------------------------------------------------
// The pre-pass's scan.  hist (tiles, m) holds each tile's count per chain
// (mesi::bucket_hist); afterwards it holds each tile's first slot per chain
// less the chain's first slot, and start (m + 1) each chain's first slot
// and, last, the number of records.
// ---------------------------------------------------------------------------
constexpr int kScanThreads = 1024;
constexpr int kMaxChainBits = 12;  // cache_sim.py's MAX_CHAIN_BITS

// One block per 32 chains (lane = chain), its 32 warps over the tiles:
// each column's offsets within the column, and its total into start[c].
__global__ void __launch_bounds__(kScanThreads)
    scan_columns(int* __restrict__ hist, int tiles, int m,
                 int* __restrict__ start) {
  __shared__ int part[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int per = (tiles + 31) / 32;
  const int t0 = min(warp * per, tiles), t1 = min(t0 + per, tiles);
  int sum = 0;
  if (c < m)
    for (int t = t0; t < t1; ++t) sum += hist[static_cast<long>(t) * m + c];
  part[warp][lane] = sum;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < warp; ++w) off += part[w][lane];
  if (c >= m) return;
  if (warp == 31) start[c] = off + sum;
  for (int t = t0; t < t1; ++t) {
    const long i = static_cast<long>(t) * m + c;
    const int v = hist[i];
    hist[i] = off;
    off += v;
  }
}

// One block: the exclusive scan of the m <= 4096 chain totals, in place,
// and the grand total at start[m].
__global__ void __launch_bounds__(kScanThreads)
    scan_totals(int* __restrict__ start, int m) {
  constexpr int kPer = (1 << kMaxChainBits) / kScanThreads;
  __shared__ int warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = threadIdx.x * kPer;
  int v[kPer], run = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    v[k] = c0 + k < m ? start[c0 + k] : 0;
    run += v[k];
  }
  int x = run;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int excl = x - run + (warp ? warp_sum[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (c0 + k < m) start[c0 + k] = excl;
    excl += v[k];
  }
  if (threadIdx.x == 0) start[m] = warp_sum[31];
}

// One warp per tile: its entries in order, kAhead batches of 32 loaded at
// once; lanes with the same chain get consecutive slots in lane order
// (their rank among their peers).  Chain c's slots in tile t start at
// start[c] + hist[t][c].
constexpr int kAhead = 8;

__global__ void __launch_bounds__(32)
    scatter(const int* __restrict__ addr, long long n, int bits, int tile,
            const int* __restrict__ hist, const int* __restrict__ start,
            Rec* __restrict__ rec) {
  extern __shared__ int base[];
  const int m = 1 << bits;
  const int lane = threadIdx.x;
  const int* off = hist + static_cast<long>(blockIdx.x) * m;
  for (int k = lane; k < m; k += 32) base[k] = start[k] + off[k];
  __syncwarp();
  const long lo = static_cast<long>(blockIdx.x) * tile;
  const long hi = lo + tile < n ? lo + tile : n;
  const unsigned below = (1u << lane) - 1;
  for (long i0 = lo; i0 < hi; i0 += 32 * kAhead) {
    int a[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long i = i0 + 32 * k + lane;
      a[k] = i < hi ? addr[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long i = i0 + 32 * k + lane;
      const int key = i < hi ? a[k] & (m - 1) : -1;
      const unsigned peers = __match_any_sync(kFull, key);
      if (key >= 0)
        rec[base[key] + __popc(peers & below)] =
            make_int4(static_cast<int>(i), a[k], 0, 0);
      __syncwarp();
      if (key >= 0 && lane == __ffs(peers) - 1) base[key] += __popc(peers);
      __syncwarp();
    }
  }
}

// The whole pre-pass on `s`: rec (n, 4) and start (m + 1) as in
// mesi_chain.cuh, hist (ceil(n / tile), m) scratch.
cudaError_t prepass(const int* addr, long long n, int bits, int tile,
                    int* hist, int* start, int* rec, cudaStream_t s) {
  const int m = 1 << bits;
  const int tiles = static_cast<int>((n + tile - 1) / tile);
  const size_t hbytes = static_cast<size_t>(m) * sizeof(int);
  mesi::bucket_hist<<<dim3(tiles, 1), 256, hbytes, s>>>(addr, n, bits, tile,
                                                        tiles, hist);
  scan_columns<<<(m + 31) / 32, kScanThreads, 0, s>>>(hist, tiles, m, start);
  scan_totals<<<1, kScanThreads, 0, s>>>(start, m);
  scatter<<<tiles, 32, hbytes, s>>>(addr, n, bits, tile, hist, start,
                                    reinterpret_cast<Rec*>(rec));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The chains
// ---------------------------------------------------------------------------
// One warp per chain.  kInRegs: one set per chain, held in registers.
// Otherwise the chain's sets live in shared memory (in_smem: slot = set >>
// bits, 2 * sets * n_ways ints per warp) or in the outputs (slot = set).
// start == nullptr is an empty trace: each chain only writes its sets'
// initial state.
template <bool kInRegs>
__global__ void __launch_bounds__(mesi::kChainWarps * 32)
    cache_sim_chain_kernel(const Rec* __restrict__ rec,
                           const int* __restrict__ start,
                           int* __restrict__ hits, int* __restrict__ tags,
                           int* __restrict__ use, int n_sets, int n_ways,
                           int bits, int in_smem) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chain = blockIdx.x * (blockDim.x >> 5) + warp;
  if (chain >= (1 << bits)) return;  // no block-wide barrier below
  const bool way_lane = lane < n_ways;
  const long cur = start ? start[chain] : 0;
  const long hi = start ? start[chain + 1] : 0;

  if constexpr (kInRegs) {
    int tag = -1, clock = 0;
    walk(rec, cur, hi, hits, lane, [&](int a, int t) {
      bool hit;
      const int way = lru_way(a, tag, clock, way_lane, &hit);
      if (lane == way) {
        tag = a;
        clock = t;
      }
      return hit;
    });
    if (way_lane) {
      tags[static_cast<long>(chain) * n_ways + lane] = tag;
      use[static_cast<long>(chain) * n_ways + lane] = clock;
    }
  } else {
    const long cells = static_cast<long>(n_sets >> bits) * n_ways;
    int* tg = in_smem ? smem + 2 * cells * warp : tags;
    int* us = in_smem ? tg + cells : use;
    const int sh = in_smem ? bits : 0;
    // cell i of the chain: way i % n_ways of its set (i / n_ways) << bits
    // | chain, at i in shared memory or at that set's row in the outputs
    auto cell = [&](long i) {
      return (((i / n_ways) << bits | chain) * n_ways) + i % n_ways;
    };
    for (long i = lane; i < cells; i += 32) {
      const long at = in_smem ? i : cell(i);
      tg[at] = -1;
      us[at] = 0;
    }
    __syncwarp();
    walk(rec, cur, hi, hits, lane, [&](int a, int t) {
      const long row = static_cast<long>((a & (n_sets - 1)) >> sh) * n_ways;
      int tag = -1, clock = 0;
      if (way_lane) {
        tag = tg[row + lane];
        clock = us[row + lane];
      }
      bool hit;
      const int way = lru_way(a, tag, clock, way_lane, &hit);
      if (lane == way) {
        tg[row + lane] = a;
        us[row + lane] = t;
      }
      return hit;
    });
    __syncwarp();
    if (in_smem) {
      for (long i = lane; i < cells; i += 32) {
        tags[cell(i)] = tg[i];
        use[cell(i)] = us[i];
      }
    }
  }
}

// Where a launch keeps each chain's sets: registers (one set per chain),
// else shared memory with kChainWarps warps per block, else with one, else
// the outputs.
struct Layout {
  int warps, in_regs, in_smem;
  size_t smem;
};

Layout choose_layout(int n_sets, int n_ways, int bits, size_t limit) {
  const int warps = (1 << bits) < mesi::kChainWarps ? (1 << bits)
                                                     : mesi::kChainWarps;
  if ((n_sets >> bits) == 1) return Layout{warps, 1, 0, 0};
  const size_t bytes =
      2 * static_cast<size_t>(n_sets >> bits) * n_ways * sizeof(int);
  if (warps * bytes <= limit) return Layout{warps, 0, 1, warps * bytes};
  if (bytes <= limit) return Layout{1, 0, 1, bytes};
  return Layout{warps, 0, 0, 0};
}

cudaError_t plan(int n_sets, int n_ways, int bits, int device, Layout* lay,
                 int* sms) {
  int smem_max = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                 device);
  *lay = choose_layout(n_sets, n_ways, bits, static_cast<size_t>(smem_max));
  return err;
}

bool takes(int n_sets, int n_ways, int bits) {
  return n_sets > 0 && (n_sets & (n_sets - 1)) == 0 && n_ways >= 1 &&
         n_ways <= 32 && bits >= 0 && bits <= kMaxChainBits &&
         (1 << bits) <= n_sets;
}

}  // namespace

// The launch shape for a geometry: out = {bits, warps per block, blocks,
// sets in registers, sets in shared memory, shared bytes per block, SMs}.
extern "C" int cache_sim_plan(int* out, int n_sets, int n_ways, int bits,
                              int device) {
  if (!takes(n_sets, n_ways, bits)) return cudaErrorInvalidValue;
  Layout lay;
  int sms = 0;
  const cudaError_t err = plan(n_sets, n_ways, bits, device, &lay, &sms);
  const int vals[7] = {bits, lay.warps,
                       ((1 << bits) + lay.warps - 1) / lay.warps,
                       lay.in_regs, lay.in_smem, static_cast<int>(lay.smem),
                       sms};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return err;
}

// addr (n,) line addresses >= 0; hist (ceil(n / tile), 2**bits), start
// (2**bits + 1) and rec (n, 4) scratch; outputs hits (n,), tags and use
// (n_sets, n_ways).  Returns a cudaError_t (0 = ok); cudaErrorInvalidValue
// for a geometry the kernel does not take (n_sets not a power of two,
// n_ways outside 1..32, more chains than sets or than 2**12).
extern "C" int cache_sim(const int* addr, int* hist, int* start, int* rec,
                         int* hits, int* tags, int* use,
                         long long n, int n_sets, int n_ways, int bits,
                         int tile, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 0 || !takes(n_sets, n_ways, bits)) return cudaErrorInvalidValue;
  Layout lay;
  int sms = 0;
  err = plan(n_sets, n_ways, bits, device, &lay, &sms);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    err = prepass(addr, n, bits, tile, hist, start, rec, s);
    if (err != cudaSuccess) return err;
  }
  const Rec* r = reinterpret_cast<const Rec*>(rec);
  const int* st = n > 0 ? start : nullptr;
  const int blocks = ((1 << bits) + lay.warps - 1) / lay.warps;
  if (lay.in_regs) {
    cache_sim_chain_kernel<true><<<blocks, lay.warps * 32, 0, s>>>(
        r, st, hits, tags, use, n_sets, n_ways, bits, 0);
  } else {
    err = cudaFuncSetAttribute(cache_sim_chain_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(lay.smem));
    if (err != cudaSuccess) return err;
    cache_sim_chain_kernel<false><<<blocks, lay.warps * 32, lay.smem, s>>>(
        r, st, hits, tags, use, n_sets, n_ways, bits, lay.in_smem);
  }
  return cudaGetLastError();
}

extern "C" const char* cache_sim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
