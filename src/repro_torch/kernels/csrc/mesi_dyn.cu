// Epoch-structured dynamic tiering over a (B, E, slot_len) trace batch:
// the two-level MESI + tier state machine routed through a per-row page
// map, with TPP-style promotion/demotion at epoch boundaries, the
// three-tier CXL-SSD stage and the SMARTS sampling gate.
//
// Replaces the Pallas TPU kernel `mesi_dyn_segment` (grid body
// `_mesi_dyn_kernel`) of src/repro/kernels/cache_sim.py.  The reference it
// must equal bit for bit is repro_torch.core.tiering_dyn._slot_step looped
// over the slots (and repro.core.tiering_dyn._slot_step): it advances the
// 9-tuple carry (l1p, l2p, stats, t, page_map, counts, mig_rd, mig_wr,
// eidx) and writes per-slot counters, stat snapshots and measurement flags.
//
// What bounds it: the serial dependency chain of the MESI accesses, as in
// mesi.cu, not bytes; and on rows that migrate, the epoch boundaries: up to
// 4 * k_max argmax rounds each (promotion, demotion and the SSD stage's
// two), each a pass over the P page keys (at the Table-I footprint, P = 4096
// and k_max = 16).
//
// What the design does about it: each row splits into 2**bits independent
// set chains, as in mesi.cu (mesi_chain.cuh), one warp each, four per
// block, the grid over (chain group, row); the entry first runs the bucket
// pre-pass over each row's e * slot_len accesses, so a chain reads its own
// accesses in row order and stops at each slot's end.
//   * Inside a slot the page map is read-only and every per-row quantity is
//     a sum, so the chains run apart: `counts[page] += 1` is an integer
//     atomic; a chain's counter deltas and its slot's access counts go into
//     the slot's `snaps` and `slots` cells by atomics at the slot's end, and
//     a last pass turns the snapshots into the row's starting stats plus an
//     inclusive prefix of those deltas.  The sampling gate is a function of
//     the slot index, the same for every chain.
//   * At a boundary of a row with budget > 0 the row's chains meet: a
//     barrier, then the row's first block copies the summed counts into
//     shared memory and runs the boundary code (count_pages, take_pages,
//     resolve_marks, the SSD stage) on all its threads, each round's
//     argmax a block-wide reduction, then it publishes the page map and
//     zeroes the counts, a second barrier, and every other block refreshes
//     its copy of the page map.  Rows with budget 0 (static and sampled
//     rows) never meet: a prep pass zeroes their counts if the segment
//     holds a boundary, and they count only the slots after its last one.
//   * How chains meet: a per-row barrier in global memory (an arrival count
//     and a generation) under a cooperative launch, which the runtime
//     refuses unless every block is resident at once.  A thread-block
//     cluster would meet faster (cluster.sync, counts in distributed shared
//     memory) but holds at most 8 portable blocks, so it would cap a row at
//     8 SMs and tie the chain count to the cluster size; the barrier lets a
//     row spread over any number of SMs.  The host plan takes fewer chains
//     per row, then fewer rows per launch, until the grid is resident; a
//     barrier that waits 60 s traps instead of hanging.
//   * The boundary's argmax rounds are still one after another (up to
//     4 * k_max of them, each a pass over the P pages by the block's 128
//     threads); they and the two barriers set the pace of rows that
//     migrate often.
//   * The page map lives in shared memory in every block where it fits
//     (with the counts' copy in the first block), else in global memory,
//     read around the L1 cache.
//
// Sentinel entries (addr == -1) change no state, counter or page count;
// the clock counts them.

#include "mesi_chain.cuh"

namespace {

using mesi::Geometry;
using mesi::kFull;
using mesi::kSentinel;
using mesi::Rec;

constexpr int kLinesPerPage = 64;
constexpr int kNumScalars = 13;   // DYN_SCALARS in kernels/cache_sim.py
// temporary page-map marks inside a boundary (real values are 0, 1, 2)
constexpr int kPromoted = 4, kDemoted = 5, kRaised = 6;
constexpr unsigned long long kBarrierTimeoutNs = 60ull * 1000 * 1000 * 1000;

// The boundary's view of a row: `T` is `int` where the page map and the
// counts' copy sit in the block's shared memory, `volatile int` where they
// sit in global memory (read around the L1 cache).  `red` is the block's
// reduction scratch (2 ints per warp).
template <class T>
struct Dyn {
  int n_p, k_max, count_bound, npg, thr, n_t;
  const int* ptl;    // the row's (P, T) page -> target line counts
  T* pmap;
  T* counts;
  int* red;
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The sum of `v` over the block; every thread gets it.
__device__ int block_sum(int v, int* red) {
  v = warp_sum(v);
  __syncthreads();  // the last reduction's readers are done with `red`
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

// Page with the largest key among pages whose map value is `want`
// (and count >= `min_count`); keys are injective, so there are no ties.
// `cold` ranks by (count_bound - count) instead of count.  -1 if none.
// Every thread of the block calls it and gets the page.
template <class T>
__device__ int argmax_page(const Dyn<T>& d, int want, int min_count,
                           bool cold) {
  int best_key = -1, best = -1;
  for (int p = threadIdx.x; p < d.npg && p < d.n_p; p += blockDim.x) {
    const int cnt = d.counts[p];
    if (d.pmap[p] != want || cnt < min_count) continue;
    const int key = (cold ? d.count_bound - cnt : cnt) * d.n_p
                    + (d.n_p - 1 - p);
    if (key > best_key) {
      best_key = key;
      best = p;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_xor_sync(kFull, best_key, off);
    const int op = __shfl_xor_sync(kFull, best, off);
    if (ok > best_key || (ok == best_key && op >= 0 && op < best)) {
      best_key = ok;
      best = op;
    }
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    d.red[2 * (threadIdx.x >> 5)] = best_key;
    d.red[2 * (threadIdx.x >> 5) + 1] = best;
  }
  __syncthreads();
  best_key = -1;
  best = -1;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int ok = d.red[2 * w], op = d.red[2 * w + 1];
    if (ok > best_key || (ok == best_key && op >= 0 && op < best)) {
      best_key = ok;
      best = op;
    }
  }
  return best;
}

// Pages (< npg) whose map value is `want` and count >= `min_count`.
template <class T>
__device__ int count_pages(const Dyn<T>& d, int want, int min_count) {
  int n = 0;
  for (int p = threadIdx.x; p < d.npg && p < d.n_p; p += blockDim.x)
    n += d.pmap[p] == want && d.counts[p] >= min_count;
  return block_sum(n, d.red);
}

// `n` rounds: take the best page of the stage, mark it `mark`, add its
// per-target lines to `mig`.
template <class T>
__device__ void take_pages(const Dyn<T>& d, int n, int want, int min_count,
                           bool cold, int mark, int* mig) {
  for (int r = 0; r < n; ++r) {
    const int p = argmax_page(d, want, min_count, cold);
    for (int k = threadIdx.x; k < d.n_t; k += blockDim.x)
      mig[k] += d.ptl[p * d.n_t + k];
    if (threadIdx.x == 0) d.pmap[p] = mark;
    __syncthreads();
  }
}

template <class T>
__device__ void resolve_marks(const Dyn<T>& d) {
  for (int p = threadIdx.x; p < d.n_p; p += blockDim.x) {
    const int v = d.pmap[p];
    if (v == kPromoted) d.pmap[p] = 0;
    if (v == kDemoted || v == kRaised) d.pmap[p] = 1;
  }
  __syncthreads();
}

// The boundary of one row, on every thread of one block: promotion /
// demotion, then the SSD stage.  Returns {promoted, demoted} pages (SSD
// moves folded in).
template <class T>
__device__ int2 epoch_boundary(const Dyn<T>& d, int bud, int cap, int ssd_t,
                               int l1cap, int* rmr, int* rmw) {
  const int n_hot = count_pages(d, 1, d.thr);
  const int n_dram = count_pages(d, 0, INT_MIN);
  // closed-form sizes of the reference's top-k masks
  const int n_want = min(min(n_hot, bud), d.k_max);
  const int free_pages = max(cap - n_dram, 0);
  const int n_dem_needed = min(max(n_want - free_pages, 0), bud);
  const int n_dem = min(min(n_dem_needed, n_dram), d.k_max);
  const int n_pro = min(min(n_want, free_pages + n_dem), d.k_max);
  // promotions read the page from its CXL endpoints and write DRAM;
  // demotions read DRAM and write the CXL endpoints
  take_pages(d, n_pro, 1, d.thr, false, kPromoted, rmr);
  take_pages(d, n_dem, 0, INT_MIN, true, kDemoted, rmw);
  resolve_marks(d);
  if (threadIdx.x == 0) {
    rmr[0] += n_dem * kLinesPerPage;
    rmw[0] += n_pro * kLinesPerPage;
  }
  __syncthreads();
  int n_sup = 0, n_over = 0;
  if (ssd_t > 0) {
    // SSD->CXL promotion reads the SSD and writes the CXL endpoints;
    // CXL->SSD demotion the reverse
    n_sup = min(min(count_pages(d, 2, d.thr), bud), d.k_max);
    take_pages(d, n_sup, 2, d.thr, false, kRaised, rmw);
    resolve_marks(d);
    const int n_l1 = count_pages(d, 1, INT_MIN);
    const int over = min(max(n_l1 - l1cap, 0), bud);
    n_over = min(min(over, n_l1), d.k_max);
    take_pages(d, n_over, 1, INT_MIN, true, 2, rmr);
    if (threadIdx.x == 0) {
      rmr[ssd_t] += n_sup * kLinesPerPage;
      rmw[ssd_t] += n_over * kLinesPerPage;
    }
    __syncthreads();
  }
  return make_int2(n_pro + n_sup, n_dem + n_over);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every block of a row waits here until all `blocks` of them have arrived.
// bar[0] counts arrivals, bar[1] is the generation; writes before the
// barrier are visible after it.
__device__ void row_barrier(unsigned* bar, unsigned blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned mine = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == blocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const unsigned long long t_start = globaltimer();
      while (*gen == mine) {
        __nanosleep(100);
        if (globaltimer() - t_start > kBarrierTimeoutNs) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The last slot of the segment that ends an epoch, or -1.
__device__ inline int last_boundary(int eidx0, int per, int e) {
  const long r = (static_cast<long>(eidx0) + e) % per;
  return e - 1 - r >= 0 ? static_cast<int>(e - 1 - r) : -1;
}

struct DynArgs {
  const int *sc, *ptl, *start;
  const Rec* rec;
  unsigned* bar;
  int *l1p, *l2p, *pmap, *counts, *mig_rd, *mig_wr, *slots, *snaps;
  int e, slot_len, n_p, k_max, count_bound;
  Geometry g;
  int bits, l1_smem, l2_smem, pg_smem;
};

__host__ __device__ inline int pg_words(int n_p) { return 2 * ((n_p + 3) & ~3); }

__global__ void __launch_bounds__(mesi::kChainWarps * 32) mesi_dyn_kernel(
    const DynArgs p, int row0) {
  extern __shared__ int smem[];
  __shared__ int red[2 * mesi::kChainWarps];  // the boundary's reductions
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long row = row0 + blockIdx.y;
  const int m = 1 << p.bits;
  const int chain = blockIdx.x * blockDim.x / 32 + warp;
  const bool active = chain < m;  // idle warps still meet
  const Geometry& g = p.g;
  const int ns = 8 + 2 * g.n_targets;
  const int n_p = p.n_p;
  const long n = static_cast<long>(p.e) * p.slot_len;  // the row's accesses

  const int* s = p.sc + row * kNumScalars;
  const int flag = s[0], npg = s[1], bud = s[2], thr = s[3], per = s[4];
  const int cap = s[5], ssd_t = s[6], l1cap = s[7];
  const int s_w = s[8], s_m = s[9], s_p = s[10];
  const unsigned t_row = static_cast<unsigned>(s[11]);
  const int eidx0 = s[12];
  int* pmap_g = p.pmap + row * n_p;
  int* counts_g = p.counts + row * n_p;

  // ---- shared memory: the page map (and the counts' copy), then the
  // chain warps' counters and sets ----
  int* pmap_s = smem;
  int* counts_s = smem + (n_p + 3) / 4 * 4;
  if (p.pg_smem) {
    for (int k = threadIdx.x; k < n_p; k += blockDim.x)
      pmap_s[k] = __ldcg(pmap_g + k);
    __syncthreads();
  }
  volatile int* pm = p.pg_smem ? pmap_s : pmap_g;
  const int words = mesi::stats_words(g)
                    + p.l1_smem * mesi::l1_chain_words(g, p.bits)
                    + p.l2_smem * mesi::l2_chain_words(g, p.bits);
  int* st = smem + (p.pg_smem ? pg_words(n_p) : 0) + warp * words;
  const long l1_len = static_cast<long>(g.cores) * g.s1 * g.w1 * 3;
  const long l2_len = static_cast<long>(g.s2) * g.w2 * 5;
  int* g_l1 = p.l1p + row * l1_len;
  int* g_l2 = p.l2p + row * l2_len;
  mesi::Planes pl{};
  if (active) {
    for (int k = lane; k < ns; k += 32) st[k] = 0;
    pl = mesi::load_chain(st + mesi::stats_words(g), g_l1, g_l2, g, p.bits,
                          chain, p.l1_smem, p.l2_smem, lane);
  }

  // budget-0 rows never meet: their counts keep only the slots after the
  // segment's last boundary (the prep pass zeroed them if there is one)
  const int jb = last_boundary(eidx0, per, p.e);
  const Rec* rr = p.rec + row * n;
  long cur = 0, hi = 0;
  Rec r = make_int4(INT_MAX, kSentinel, 0, 0);
  if (active) {
    cur = p.start[row * (m + 1) + chain];
    hi = p.start[row * (m + 1) + chain + 1];
    r = mesi::load_rec(rr, cur, hi, lane);
  }

  for (int j = 0; j < p.e; ++j) {
    const int eidx = eidx0 + j;  // slot index entering this slot
    // sampled rows (s_p > 0): slots outside [s_w, s_w + s_m) of each
    // period warm the state; their counter increments are gated off
    const int pos_p = eidx % max(s_p, 1);
    const int meas = s_p > 0 ? (pos_p >= s_w && pos_p < s_w + s_m) : 1;
    const long o = row * p.e + j;
    if (active) {
      const bool add_counts = bud > 0 || j > jb;
      int acc_t = 0, acc_d = 0;
      auto access = [&](int pos, int a, bool w, int c, int tr) {
        const int page = a >= 0 ? min(a / kLinesPerPage, n_p - 1) : 0;
        const int intent = flag != 0 ? pm[page] : 0;
        // dynamic rows: the page map decides DRAM vs the precomputed CXL
        // target (level-2 pages hit the SSD target); static rows use the
        // precomputed target verbatim
        const int tgt =
            flag != 0 ? (intent == 0 ? 0 : (intent >= 2 ? ssd_t : tr)) : tr;
        mesi::mesi_access(a, w, c, tgt, static_cast<int>(t_row + pos), meas,
                          pl, st, g, lane);
        if (lane == 0 && add_counts) atomicAdd(counts_g + page, 1);
        acc_t += 1;
        acc_d += (flag != 0 ? intent : tgt) == 0;
      };
      const long slot_hi = static_cast<long>(j + 1) * p.slot_len;
      // the chain's records of this slot; the next batch (of this slot or
      // the next) loads while this one runs
      while (true) {
        const unsigned in_slot = __ballot_sync(kFull, r.x < slot_hi);
        const int cnt = __popc(in_slot);
        const Rec next = mesi::load_rec(rr, cur + cnt, hi, lane);
        mesi::run_batch(in_slot, r, access);
        cur += cnt;
        r = next;
        if (cnt < 32) break;
      }
      // the slot's deltas into its cells
      if (acc_t != 0) {
        for (int k = lane; k < ns; k += 32) {
          const int v = st[k];
          if (v != 0) atomicAdd(p.snaps + o * ns + k, v);
          st[k] = 0;
        }
        if (lane == 0) {
          atomicAdd(p.slots + o * 4, acc_t);
          if (acc_d != 0) atomicAdd(p.slots + o * 4 + 1, acc_d);
        }
        __syncwarp();
      }
    }

    // ---- epoch boundary of a migrating row: the chains meet ----
    if ((eidx + 1) % per == 0 && bud > 0) {
      row_barrier(p.bar + 2 * row, gridDim.x);
      if (blockIdx.x == 0) {
        const int* ptl = p.ptl + row * n_p * g.n_targets;
        int* rmr = p.mig_rd + row * g.n_targets;
        int* rmw = p.mig_wr + row * g.n_targets;
        int2 moved;
        if (p.pg_smem) {
          for (int k = threadIdx.x; k < n_p; k += blockDim.x)
            counts_s[k] = __ldcg(counts_g + k);
          __syncthreads();
          const Dyn<int> d{n_p, p.k_max, p.count_bound, npg, thr,
                           g.n_targets, ptl, pmap_s, counts_s, red};
          moved = epoch_boundary(d, bud, cap, ssd_t, l1cap, rmr, rmw);
        } else {
          const Dyn<volatile int> d{n_p, p.k_max, p.count_bound, npg, thr,
                                    g.n_targets, ptl, pmap_g, counts_g,
                                    red};
          moved = epoch_boundary(d, bud, cap, ssd_t, l1cap, rmr, rmw);
        }
        if (threadIdx.x == 0) {
          p.slots[o * 4 + 2] = moved.x;
          p.slots[o * 4 + 3] = moved.y;
        }
        __syncthreads();
        for (int k = threadIdx.x; k < n_p; k += blockDim.x) {
          if (p.pg_smem) pmap_g[k] = pmap_s[k];
          counts_g[k] = 0;
        }
      }
      row_barrier(p.bar + 2 * row, gridDim.x);
      if (p.pg_smem && blockIdx.x != 0) {
        for (int k = threadIdx.x; k < n_p; k += blockDim.x)
          pmap_s[k] = __ldcg(pmap_g + k);
        __syncthreads();
      }
    }
  }

  if (active) mesi::store_chain(pl, g_l1, g_l2, g, p.bits, chain, lane);
}

// Before the chains: zero the counts of budget-0 rows whose segment ends an
// epoch (they never meet, so no boundary resets them).
__global__ void dyn_prep(const int* __restrict__ sc, int* __restrict__ counts,
                         int e, int n_p) {
  const long row = blockIdx.x;
  const int* s = sc + row * kNumScalars;
  if (s[2] != 0 || last_boundary(s[12], s[4], e) < 0) return;
  for (int k = threadIdx.x; k < n_p; k += blockDim.x) counts[row * n_p + k] = 0;
}

// After the chains: each slot's snapshot is the row's starting stats plus
// the inclusive prefix of the slots' deltas; the row's stats are the last
// snapshot; the measurement flags follow the slot index.
__global__ void dyn_finish(const int* __restrict__ sc, int* __restrict__ stats,
                           int* __restrict__ snaps, int* __restrict__ meas,
                           int e, int ns) {
  const long row = blockIdx.x;
  for (int k = threadIdx.x; k < ns; k += blockDim.x) {
    unsigned run = static_cast<unsigned>(stats[row * ns + k]);
    for (int j = 0; j < e; ++j) {
      int* cell = snaps + (row * e + j) * ns + k;
      run += static_cast<unsigned>(*cell);
      *cell = static_cast<int>(run);
    }
    stats[row * ns + k] = static_cast<int>(run);
  }
  const int* s = sc + row * kNumScalars;
  const int s_w = s[8], s_m = s[9], s_p = s[10], eidx0 = s[12];
  for (int j = threadIdx.x; j < e; j += blockDim.x) {
    const int pos = (eidx0 + j) % max(s_p, 1);
    meas[row * e + j] = s_p > 0 ? (pos >= s_w && pos < s_w + s_m) : 1;
  }
}

// The launch's shape; see mesi_dyn_plan.
struct Plan {
  int bits, warps, groups, rows, l1_smem, l2_smem, pg_smem, smem, sms,
      blocks_per_sm;
};

cudaError_t make_plan(const Geometry& g0, int b, int n_p, int bits, int meet,
                      int device, Plan* out) {
  int smem_max = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(smem_max);
  const size_t pg_bytes = static_cast<size_t>(pg_words(n_p)) * sizeof(int);
  for (;; --bits) {
    const mesi::Layout lay = mesi::choose_layout(g0, bits, limit);
    // fewer chains only make each chain's state larger
    if (!lay.fits) return cudaErrorLaunchOutOfResources;
    const int pg = lay.smem + pg_bytes <= limit ? 1 : 0;
    const size_t smem = lay.smem + (pg ? pg_bytes : 0);
    const int groups = ((1 << bits) + lay.warps - 1) / lay.warps;
    *out = Plan{bits, lay.warps, groups, b, lay.l1_smem, lay.l2_smem, pg,
                static_cast<int>(smem), sms, 0};
    // rows that meet need every block of the launch resident at once
    const void* fn = reinterpret_cast<const void*>(mesi_dyn_kernel);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        lay.warps * 32, smem);
    if (err != cudaSuccess) return err;
    out->blocks_per_sm = per_sm;
    if (!meet) return cudaSuccess;
    const long capacity = static_cast<long>(per_sm) * sms;
    if (groups <= capacity) {
      out->rows = static_cast<int>(capacity / groups < b ? capacity / groups
                                                         : b);
      return cudaSuccess;
    }
    if (bits == 0) return cudaErrorCooperativeLaunchTooLarge;
  }
}

}  // namespace

// The launch's shape for `b` rows of a segment, split into at most 2**bits
// chains (fewer where a row's blocks must be resident together, `meet` 1):
// out[0..9] = bits, chain warps per block, blocks per row, rows per launch,
// L1 sets in shared memory (0/1), L2 sets in shared memory, page map in
// shared memory, shared-memory bytes per block, the card's SM count,
// resident blocks per SM.  Returns a CUDA error code (0 on success).
extern "C" int mesi_dyn_plan(int* out, int b, int n_p, int cores,
                             int l1_sets, int l1_ways, int l2_sets,
                             int l2_ways, int n_targets, int bits, int meet,
                             int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Geometry g{cores, l1_sets, l1_ways, l2_sets, l2_ways, n_targets};
  Plan pl{};
  err = make_plan(g, b, n_p, bits, meet, device, &pl);
  const int vals[10] = {pl.bits, pl.warps, pl.groups, pl.rows, pl.l1_smem,
                        pl.l2_smem, pl.pg_smem, pl.smem, pl.sms,
                        pl.blocks_per_sm};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return err;
}

// Advance the epoch carry of `b` rows in place over a (b, e, slot_len)
// int32 trace: l1p, l2p, stats, page_map (b, n_p), counts (b, n_p),
// mig_rd and mig_wr (b, n_targets).  `sc` holds each row's 13 scalars
// (DYN_SCALARS: the tierer and sampling scalars, then the clock and the
// slot index before the segment), `ptl` the (b, n_p, n_targets) page ->
// target line counts.  Adds into slots (b, e, 4) and snaps (b, e, nstats),
// which must hold zeros, and writes meas (b, e).  Each row splits into at
// most 2**bits chains, as mesi_dyn_plan plans it for the same `meet` (1 if
// some row with budget > 0 ends an epoch in the segment); the bucket
// pre-pass gathers their accesses first into rec (b, e * slot_len, 4) and
// start (b, 2**bits + 1), with hist (b, ceil(e * slot_len / tile),
// 2**bits) as scratch.  `bar` (b, 2) holds zeros.
// Launches on `stream`; returns a CUDA error code.
extern "C" int mesi_dyn_segment(
    const int* addr, const int* is_write, const int* core, const int* tier,
    const int* sc, const int* ptl, int* hist, int* start, int* rec,
    int* bar, int* l1p, int* l2p, int* stats, int* pmap, int* counts,
    int* mig_rd, int* mig_wr, int* slots, int* snaps, int* meas, int b,
    int e, int slot_len, int n_p, int k_max, int count_bound, int cores,
    int l1_sets, int l1_ways, int l2_sets, int l2_ways, int n_targets,
    int bits, int tile, int meet, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b == 0 || e == 0) return cudaSuccess;
  const Geometry g{cores, l1_sets, l1_ways, l2_sets, l2_ways, n_targets};
  Plan pl{};
  err = make_plan(g, b, n_p, bits, meet, device, &pl);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = mesi::launch_bucket(addr, is_write, core, tier, b,
                            static_cast<long>(e) * slot_len, pl.bits, tile,
                            hist, start, rec, s);
  if (err != cudaSuccess) return err;
  dyn_prep<<<b, 256, 0, s>>>(sc, counts, e, n_p);
  DynArgs args{sc, ptl, start, reinterpret_cast<const Rec*>(rec),
               reinterpret_cast<unsigned*>(bar), l1p, l2p, pmap, counts,
               mig_rd, mig_wr, slots, snaps, e, slot_len, n_p, k_max,
               count_bound, g, pl.bits, pl.l1_smem, pl.l2_smem, pl.pg_smem};
  const void* fn = reinterpret_cast<const void*>(mesi_dyn_kernel);
  for (int row0 = 0; row0 < b; row0 += pl.rows) {
    const dim3 grid(pl.groups, b - row0 < pl.rows ? b - row0 : pl.rows);
    const dim3 block(pl.warps * 32);
    if (meet) {
      void* params[] = {&args, &row0};
      err = cudaLaunchCooperativeKernel(fn, grid, block, params, pl.smem, s);
      if (err != cudaSuccess) return err;
    } else {
      mesi_dyn_kernel<<<grid, block, pl.smem, s>>>(args, row0);
    }
  }
  dyn_finish<<<b, 32, 0, s>>>(sc, stats, snaps, meas, e,
                              8 + 2 * n_targets);
  return cudaGetLastError();
}

extern "C" const char* mesi_dyn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
