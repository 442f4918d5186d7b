// A trace row split into independent set chains, for mesi.cu and mesi_dyn.cu.
//
// Set counts are powers of two and set indices are address masks, so with
// m = 2**bits dividing min(l1_sets, l2_sets), a line's chain `a & (m - 1)`
// fixes every set its access touches (mesi_access.cuh says which), and
// chains share no cache state.  Each chain is walked by one warp in the
// row's order, with the clock t0 + (position in the row) that the whole
// row would give the access, so LRU order and its ties are unchanged; the
// counters are int32 sums, whose order does not matter.  m = 1 is the whole
// row on one warp.
//
// This header holds what both kernels share:
//   * `Rec`, one access as a chain reads it: {position, address,
//     is_write | core << 1, tier}, as the bucket pre-pass stores them;
//   * the bucket pre-pass, which gives each chain its accesses in row
//     order: per-tile histograms, a scan, an ordered scatter;
//   * where a launch keeps each chain's sets, loading them into shared
//     memory and storing them back;
//   * running a batch of up to 32 accesses held one per lane.
#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "mesi_access.cuh"

namespace mesi {

using Rec = int4;  // {pos, addr, is_write | core << 1, tier}

constexpr int kChainWarps = 4;  // chain warps per block

// Shared-memory words one chain's counters and sets take.
__host__ __device__ inline int stats_words(const Geometry& g) {
  return (8 + 2 * g.n_targets + 3) & ~3;
}
__host__ __device__ inline int l1_chain_words(const Geometry& g, int bits) {
  return ((g.cores * (g.s1 >> bits) * g.w1 * 3) + 3) & ~3;
}
__host__ __device__ inline int l2_chain_words(const Geometry& g, int bits) {
  return (((g.s2 >> bits) * g.w2 * 5) + 3) & ~3;
}

// Where a launch keeps each chain's state: `warps` chain warps per block,
// the L1 and L2 sets of each in shared memory or not (then in the row's
// planes in global memory, where chains touch disjoint cells), and the
// block's shared-memory bytes.  `fits` is false where neither level fits.
struct Layout {
  int warps, l1_smem, l2_smem;
  size_t smem;
  bool fits;
};

// Both levels in shared memory; then L2 alone (the L1 sets are read on
// every access, the L2 sets on every L1 miss, but an L2 chain is the
// larger); then L1 alone.  With m = min(l1_sets, l2_sets) chains one level
// holds a single set per chain (at most 31 x 32 x 3 L1 words or 32 x 5 L2
// words), so one of the three fits; with fewer chains (mesi_dyn.cu's plan
// may cut them) none may.
inline Layout choose_layout(const Geometry& g, int bits, size_t limit) {
  const int warps = (1 << bits) < kChainWarps ? (1 << bits) : kChainWarps;
  const int opts[3][2] = {{1, 1}, {0, 1}, {1, 0}};
  Layout lay{};
  for (const auto& o : opts) {
    const size_t words = stats_words(g) + o[0] * l1_chain_words(g, bits)
                         + o[1] * l2_chain_words(g, bits);
    lay = Layout{warps, o[0], o[1], warps * words * sizeof(int), false};
    lay.fits = lay.smem <= limit;
    if (lay.fits) break;
  }
  return lay;
}

// The planes of chain `chain` for a warp: its sets copied into `sm` (the
// warp's area after its counters) where the layout says so, else the row's
// planes in global memory.
__device__ inline Planes load_chain(int* sm, int* g_l1, int* g_l2,
                                    const Geometry& g, int bits, int chain,
                                    int l1_smem, int l2_smem, int lane) {
  Planes pl{g_l1, g_l2, g.s1, 0, 0};
  if (l1_smem) {
    const int s1c = g.s1 >> bits, len = g.w1 * 3;
    const long total = static_cast<long>(g.cores) * s1c * len;
    for (long i = lane; i < total; i += 32) {
      const int x = static_cast<int>(i % len);
      const long q = i / len;
      const int set = static_cast<int>(q % s1c), k = static_cast<int>(q / s1c);
      sm[i] = g_l1[(static_cast<long>(k) * g.s1 + ((set << bits) | chain))
                   * len + x];
    }
    pl.l1 = sm;
    pl.l1_sets = s1c;
    pl.sh1 = bits;
    sm += l1_chain_words(g, bits);
  }
  if (l2_smem) {
    const int s2c = g.s2 >> bits, len = g.w2 * 5;
    const long total = static_cast<long>(s2c) * len;
    for (long i = lane; i < total; i += 32) {
      const int x = static_cast<int>(i % len);
      const int set = static_cast<int>(i / len);
      sm[i] = g_l2[static_cast<long>((set << bits) | chain) * len + x];
    }
    pl.l2 = sm;
    pl.sh2 = bits;
  }
  __syncwarp();
  return pl;
}

// Store a chain's sets back where load_chain found them.
__device__ inline void store_chain(const Planes& pl, int* g_l1, int* g_l2,
                                   const Geometry& g, int bits, int chain,
                                   int lane) {
  __syncwarp();
  if (pl.l1 != g_l1) {
    const int s1c = g.s1 >> bits, len = g.w1 * 3;
    const long total = static_cast<long>(g.cores) * s1c * len;
    for (long i = lane; i < total; i += 32) {
      const int x = static_cast<int>(i % len);
      const long q = i / len;
      const int set = static_cast<int>(q % s1c), k = static_cast<int>(q / s1c);
      g_l1[(static_cast<long>(k) * g.s1 + ((set << bits) | chain)) * len + x] =
          pl.l1[i];
    }
  }
  if (pl.l2 != g_l2) {
    const int s2c = g.s2 >> bits, len = g.w2 * 5;
    const long total = static_cast<long>(s2c) * len;
    for (long i = lane; i < total; i += 32) {
      const int x = static_cast<int>(i % len);
      const int set = static_cast<int>(i / len);
      g_l2[static_cast<long>((set << bits) | chain) * len + x] = pl.l2[i];
    }
  }
}

// Lane `lane` of a batch of bucketed records starting at `cur`; lanes at
// or past `hi` get position INT_MAX (past every slot).
__device__ __forceinline__ Rec load_rec(const Rec* rec, long cur, long hi,
                                        int lane) {
  const long i = cur + lane;
  return i < hi ? rec[i] : make_int4(INT_MAX, kSentinel, 0, 0);
}

// Run the accesses held by the lanes of `mask`, lowest lane first (lane
// order is row order).  `access(pos, a, w, c, tr)` is called by every lane.
template <class F>
__device__ __forceinline__ void run_batch(unsigned mask, const Rec& r,
                                          F&& access) {
  while (mask) {
    const int j = __ffs(mask) - 1;
    mask &= mask - 1;
    const int pos = __shfl_sync(kFull, r.x, j);
    const int a = __shfl_sync(kFull, r.y, j);
    const int wc = __shfl_sync(kFull, r.z, j);
    const int tr = __shfl_sync(kFull, r.w, j);
    access(pos, a, (wc & 1) != 0, wc >> 1, tr);
  }
}

// ---------------------------------------------------------------------------
// The bucket pre-pass
// ---------------------------------------------------------------------------
// rec (b, n) Rec: row r's live accesses, chain by chain, in row order;
// start (b, m + 1): chain k of row r holds rec[r][start[r][k], start[r][k+1]).
// hist (b, tiles, m) is scratch: per-tile counts, then per-tile offsets,
// tiles = ceil(n / tile).  The wrapper sizes hist and start for the most
// chains a launch may take, so a launch with fewer fits in them too.

__global__ void bucket_hist(const int* __restrict__ addr, long n, int bits,
                            int tile, int tiles, int* __restrict__ hist) {
  extern __shared__ int h[];
  const int m = 1 << bits;
  const long row = blockIdx.y;
  for (int k = threadIdx.x; k < m; k += blockDim.x) h[k] = 0;
  __syncthreads();
  const long lo = static_cast<long>(blockIdx.x) * tile;
  const long hi = lo + tile < n ? lo + tile : n;
  const int* ra = addr + row * n;
  for (long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int a = ra[i];
    if (a != kSentinel) atomicAdd(&h[a & (m - 1)], 1);
  }
  __syncthreads();
  int* out = hist + (row * tiles + blockIdx.x) * static_cast<long>(m);
  for (int k = threadIdx.x; k < m; k += blockDim.x) out[k] = h[k];
}

// One block per row: each chain's total over the tiles, the exclusive scan
// of the totals over the chains (start), then each tile's offset per chain.
__global__ void bucket_scan(int* __restrict__ hist, int tiles, int bits,
                            int* __restrict__ start) {
  extern __shared__ int tot[];  // m chain totals, then blockDim partials
  const int m = 1 << bits;
  const long row = blockIdx.x;
  int* hr = hist + row * tiles * static_cast<long>(m);
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    int s = 0;
    for (int t = 0; t < tiles; ++t) s += hr[static_cast<long>(t) * m + c];
    tot[c] = s;
  }
  __syncthreads();
  // exclusive scan over chains: each thread a contiguous run, then the
  // runs' sums scanned by thread 0
  int* part = tot + m;
  const int per = (m + blockDim.x - 1) / blockDim.x;
  const int c0 = threadIdx.x * per;
  int run = 0;
  for (int c = c0; c < c0 + per && c < m; ++c) run += tot[c];
  part[threadIdx.x] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int k = 0; k < static_cast<int>(blockDim.x); ++k) {
      const int v = part[k];
      part[k] = acc;
      acc += v;
    }
    start[row * (m + 1) + m] = acc;
  }
  __syncthreads();
  run = part[threadIdx.x];
  for (int c = c0; c < c0 + per && c < m; ++c) {
    const int v = tot[c];
    tot[c] = run;
    start[row * (m + 1) + c] = run;
    run += v;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    int off = tot[c];
    for (int t = 0; t < tiles; ++t) {
      int* cell = hr + static_cast<long>(t) * m + c;
      const int v = *cell;
      *cell = off;
      off += v;
    }
  }
}

// One warp per tile: entries in order, 32 at a time; lanes with the same
// chain get consecutive slots in lane order (their rank among their peers).
__global__ void __launch_bounds__(32) bucket_scatter(
    const int* __restrict__ addr, const int* __restrict__ is_write,
    const int* __restrict__ core, const int* __restrict__ tier, long n,
    int bits, int tile, int tiles, const int* __restrict__ hist,
    Rec* __restrict__ rec) {
  extern __shared__ int base[];
  const int m = 1 << bits;
  const int lane = threadIdx.x;
  const long row = blockIdx.y;
  const int* off = hist + (row * tiles + blockIdx.x) * static_cast<long>(m);
  for (int k = lane; k < m; k += 32) base[k] = off[k];
  __syncwarp();
  const long lo = static_cast<long>(blockIdx.x) * tile;
  const long hi = lo + tile < n ? lo + tile : n;
  const long r0 = row * n;
  Rec* out = rec + r0;
  const unsigned below = (1u << lane) - 1;
  for (long i0 = lo; i0 < hi; i0 += 32) {
    const long i = i0 + lane;
    int a = kSentinel, key = -1;
    if (i < hi) {
      a = addr[r0 + i];
      if (a != kSentinel) key = a & (m - 1);
    }
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0) {
      const int pos = base[key] + __popc(peers & below);
      out[pos] = make_int4(static_cast<int>(i), a,
                           (is_write[r0 + i] != 0) | (core[r0 + i] << 1),
                           tier[r0 + i]);
    }
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) base[key] += __popc(peers);
    __syncwarp();
  }
}

// Launch the three passes on `stream`; returns cudaGetLastError().
inline cudaError_t launch_bucket(const int* addr, const int* is_write,
                                 const int* core, const int* tier, int b,
                                 long n, int bits, int tile, int* hist,
                                 int* start, int* rec, cudaStream_t stream) {
  const int m = 1 << bits;
  const int tiles = static_cast<int>((n + tile - 1) / tile);
  const size_t hbytes = static_cast<size_t>(m) * sizeof(int);
  const size_t sbytes = (static_cast<size_t>(m) + 256) * sizeof(int);
  const void* fns[3] = {reinterpret_cast<const void*>(bucket_hist),
                        reinterpret_cast<const void*>(bucket_scan),
                        reinterpret_cast<const void*>(bucket_scatter)};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sbytes));
    if (err != cudaSuccess) return err;
  }
  bucket_hist<<<dim3(tiles, b), 256, hbytes, stream>>>(addr, n, bits, tile,
                                                        tiles, hist);
  bucket_scan<<<b, 256, sbytes, stream>>>(hist, tiles, bits, start);
  bucket_scatter<<<dim3(tiles, b), 32, hbytes, stream>>>(
      addr, is_write, core, tier, n, bits, tile, tiles, hist,
      reinterpret_cast<Rec*>(rec));
  return cudaGetLastError();
}

}  // namespace mesi
