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
// mesi.cu, not bytes.  The epoch boundaries add up to 3 * k_max argmax
// rounds over the P page keys per epoch, each a pass of P / 32 reads per
// lane; at the Table-I footprint (P = 4096, k_max = 16, 2048-access
// epochs) that is about as many reads as the epoch's accesses do.
//
// What the design does about it:
//   * one launch per segment, one warp (32 lanes) per batch row, all E
//     slots of the row inside it, in order; the per-access body is the one
//     of mesi.cu (mesi_access.cuh), with every counter increment gated by
//     the slot's measurement flag (equal to the reference's masking of the
//     slot's stat delta, because every stat update is an integer add);
//   * the counters, the L1 planes and the page map + per-page counts live
//     in shared memory when they fit (in that order of preference), else in
//     global memory on the copy of the carry the wrapper makes;
//   * at a boundary the promotion/demotion counts come in closed form (the
//     same min/clip arithmetic as the Pallas kernel), so only the rounds
//     that take a page run.  Each round is a warp-wide argmax over the
//     injective keys `count * P + (P - 1 - page)`, recomputed from the page
//     map and counts: a taken page is marked with a temporary map value
//     that no stage selects, and the marks are resolved after the stage,
//     so each stage ranks the map as it stood when the stage began;
//   * static rows (dyn_flag 0, budget 0) route by their precomputed
//     targets and skip the boundary work: their stats equal mesi.cu's.
//
// Sentinel entries (addr == -1) change no state, counter or page count;
// the clock advances across them.

#include "mesi_access.cuh"

namespace {

using mesi::Geometry;
using mesi::kFull;
using mesi::kSentinel;

constexpr int kLinesPerPage = 64;
constexpr int kNumScalars = 13;   // DYN_SCALARS in kernels/cache_sim.py
// temporary page-map marks inside a boundary (real values are 0, 1, 2)
constexpr int kPromoted = 4, kDemoted = 5, kRaised = 6;

struct Dyn {
  int n_p, k_max, count_bound, npg, thr, n_t;
  const int* ptl;    // the row's (P, T) page -> target line counts
  int* pmap;
  const int* counts;
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Page with the largest key among pages whose map value is `want`
// (and count >= `min_count`); keys are injective, so there are no ties.
// `cold` ranks by (count_bound - count) instead of count.  -1 if none.
__device__ int argmax_page(const Dyn& d, int want, int min_count, bool cold,
                           int lane) {
  int best_key = -1, best = -1;
  for (int p = lane; p < d.npg && p < d.n_p; p += 32) {
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
  return best;
}

// Pages (< npg) whose map value is `want` and count >= `min_count`.
__device__ int count_pages(const Dyn& d, int want, int min_count, int lane) {
  int n = 0;
  for (int p = lane; p < d.npg && p < d.n_p; p += 32)
    n += d.pmap[p] == want && d.counts[p] >= min_count;
  return warp_sum(n);
}

// `n` rounds: take the best page of the stage, mark it `mark`, add its
// per-target lines to `mig`.
__device__ void take_pages(const Dyn& d, int n, int want, int min_count,
                           bool cold, int mark, int* mig, int lane) {
  for (int r = 0; r < n; ++r) {
    const int p = argmax_page(d, want, min_count, cold, lane);
    for (int k = lane; k < d.n_t; k += 32) mig[k] += d.ptl[p * d.n_t + k];
    if (lane == 0) d.pmap[p] = mark;
    __syncwarp();
  }
}

__device__ void resolve_marks(const Dyn& d, int lane) {
  for (int p = lane; p < d.n_p; p += 32) {
    const int v = d.pmap[p];
    if (v == kPromoted) d.pmap[p] = 0;
    if (v == kDemoted || v == kRaised) d.pmap[p] = 1;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32) mesi_dyn_kernel(
    const int* __restrict__ addr, const int* __restrict__ is_write,
    const int* __restrict__ core, const int* __restrict__ tier,
    const int* __restrict__ sc, const int* __restrict__ ptl,
    int* __restrict__ l1p, int* __restrict__ l2p, int* __restrict__ stats,
    int* __restrict__ pmap_g, int* __restrict__ counts_g,
    int* __restrict__ mig_rd, int* __restrict__ mig_wr,
    int* __restrict__ slots, int* __restrict__ snaps,
    int* __restrict__ meas_out, int e, int slot_len, int n_p, int k_max,
    int count_bound, Geometry g, int l1_in_smem, int pg_in_smem) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x;
  const long row = blockIdx.x;
  const int ns = 8 + 2 * g.n_targets;
  const int n_t = g.n_targets;
  const long l1_len = static_cast<long>(g.cores) * g.s1 * g.w1 * 3;
  const long l2_len = static_cast<long>(g.s2) * g.w2 * 5;

  // ---- the row's state: shared memory where it fits ----
  int* st = smem;
  long off = (ns + 3) & ~3;
  int* l1 = l1p + row * l1_len;
  int* const l2 = l2p + row * l2_len;
  int* pmap = pmap_g + row * n_p;
  int* counts = counts_g + row * n_p;
  for (int k = lane; k < ns; k += 32) st[k] = stats[row * ns + k];
  if (l1_in_smem) {
    int* l1s = smem + off;
    for (long k = lane; k < l1_len; k += 32) l1s[k] = l1[k];
    l1 = l1s;
    off += (l1_len + 3) & ~3L;
  }
  if (pg_in_smem) {
    int* ps = smem + off;
    int* cs = ps + n_p;
    for (int k = lane; k < n_p; k += 32) {
      ps[k] = pmap[k];
      cs[k] = counts[k];
    }
    pmap = ps;
    counts = cs;
  }
  __syncwarp();

  const int* s = sc + row * kNumScalars;
  const int flag = s[0], npg = s[1], bud = s[2], thr = s[3], per = s[4];
  const int cap = s[5], ssd_t = s[6], l1cap = s[7];
  const int s_w = s[8], s_m = s[9], s_p = s[10];
  int t = s[11];
  const int eidx0 = s[12];
  const Dyn d{n_p, k_max, count_bound, npg, thr, n_t, ptl + row * n_p * n_t,
              pmap, counts};
  int* rmr = mig_rd + row * n_t;
  int* rmw = mig_wr + row * n_t;
  const long n = static_cast<long>(e) * slot_len;
  const int* ra = addr + row * n;
  const int* rw = is_write + row * n;
  const int* rc = core + row * n;
  const int* rt = tier + row * n;

  for (int j = 0; j < e; ++j) {
    const int eidx = eidx0 + j;  // slot index entering this slot
    // sampled rows (s_p > 0): slots outside [s_w, s_w + s_m) of each
    // period warm the state; their counter increments are gated off
    const int pos = eidx % max(s_p, 1);
    const int meas = s_p > 0 ? (pos >= s_w && pos < s_w + s_m) : 1;
    int acc_t = 0, acc_d = 0;
    const long sbase = static_cast<long>(j) * slot_len;
    for (int base = 0; base < slot_len; base += 32) {
      int ca = kSentinel, cw = 0, cc = 0, ct = 0;
      if (base + lane < slot_len) {
        ca = ra[sbase + base + lane];
        cw = rw[sbase + base + lane];
        cc = rc[sbase + base + lane];
        ct = rt[sbase + base + lane];
      }
      const int m = min(32, slot_len - base);
      for (int i = 0; i < m; ++i, ++t) {
        const int a = __shfl_sync(kFull, ca, i);
        const bool w = __shfl_sync(kFull, cw, i) != 0;
        const int c = __shfl_sync(kFull, cc, i);
        const int tr = __shfl_sync(kFull, ct, i);
        if (a == kSentinel) continue;  // warp-uniform: padding touches nothing
        const int page = a >= 0 ? min(a / kLinesPerPage, n_p - 1) : 0;
        const int intent = pmap[page];
        // dynamic rows: the page map decides DRAM vs the precomputed CXL
        // target (level-2 pages hit the SSD target); static rows use the
        // precomputed target verbatim
        const int tgt =
            flag != 0 ? (intent == 0 ? 0 : (intent >= 2 ? ssd_t : tr)) : tr;
        mesi::mesi_access(a, w, c, tgt, t, meas, l1, l2, st, g, lane);
        if (lane == 0) counts[page] += 1;
        acc_t += 1;
        acc_d += (flag != 0 ? intent : tgt) == 0;
      }
    }
    __syncwarp();

    // ---- epoch boundary: promotion / demotion, then the SSD stage ----
    const bool boundary = (eidx + 1) % per == 0;
    int n_pro = 0, n_dem = 0, n_sup = 0, n_over = 0;
    if (boundary && bud > 0) {
      const int n_hot = count_pages(d, 1, thr, lane);
      const int n_dram = count_pages(d, 0, INT_MIN, lane);
      // closed-form sizes of the reference's top-k masks
      const int n_want = min(min(n_hot, bud), k_max);
      const int free_pages = max(cap - n_dram, 0);
      const int n_dem_needed = min(max(n_want - free_pages, 0), bud);
      n_dem = min(min(n_dem_needed, n_dram), k_max);
      n_pro = min(min(n_want, free_pages + n_dem), k_max);
      // promotions read the page from its CXL endpoints and write DRAM;
      // demotions read DRAM and write the CXL endpoints
      take_pages(d, n_pro, 1, thr, false, kPromoted, rmr, lane);
      take_pages(d, n_dem, 0, INT_MIN, true, kDemoted, rmw, lane);
      resolve_marks(d, lane);
      if (lane == 0) {
        rmr[0] += n_dem * kLinesPerPage;
        rmw[0] += n_pro * kLinesPerPage;
      }
      __syncwarp();
      if (ssd_t > 0) {
        // SSD->CXL promotion reads the SSD and writes the CXL endpoints;
        // CXL->SSD demotion the reverse
        n_sup = min(min(count_pages(d, 2, thr, lane), bud), k_max);
        take_pages(d, n_sup, 2, thr, false, kRaised, rmw, lane);
        resolve_marks(d, lane);
        const int n_l1 = count_pages(d, 1, INT_MIN, lane);
        const int over = min(max(n_l1 - l1cap, 0), bud);
        n_over = min(min(over, n_l1), k_max);
        take_pages(d, n_over, 1, INT_MIN, true, 2, rmr, lane);
        if (lane == 0) {
          rmr[ssd_t] += n_sup * kLinesPerPage;
          rmw[ssd_t] += n_over * kLinesPerPage;
        }
        __syncwarp();
      }
    }
    if (boundary) {
      for (int p = lane; p < n_p; p += 32) counts[p] = 0;
    }

    // ---- per-slot outputs ----
    const long o = row * e + j;
    if (lane == 0) {
      slots[o * 4] = acc_t;
      slots[o * 4 + 1] = acc_d;
      slots[o * 4 + 2] = n_pro + n_sup;
      slots[o * 4 + 3] = n_dem + n_over;
      meas_out[o] = meas;
    }
    for (int k = lane; k < ns; k += 32) snaps[o * ns + k] = st[k];
    __syncwarp();
  }

  for (int k = lane; k < ns; k += 32) stats[row * ns + k] = st[k];
  if (l1_in_smem) {
    int* out = l1p + row * l1_len;
    for (long k = lane; k < l1_len; k += 32) out[k] = l1[k];
  }
  if (pg_in_smem) {
    for (int k = lane; k < n_p; k += 32) {
      pmap_g[row * n_p + k] = pmap[k];
      counts_g[row * n_p + k] = counts[k];
    }
  }
}

}  // namespace

// Advance the epoch carry of `b` rows in place over a (b, e, slot_len)
// int32 trace: l1p, l2p, stats, page_map (b, n_p), counts (b, n_p),
// mig_rd and mig_wr (b, n_targets).  `sc` holds each row's 13 scalars
// (DYN_SCALARS: the tierer and sampling scalars, then the clock and the
// slot index before the segment), `ptl` the (b, n_p, n_targets) page ->
// target line counts.  Writes slots (b, e, 4), snaps (b, e, nstats) and
// meas (b, e).  Launches on `stream`; returns cudaGetLastError().
extern "C" int mesi_dyn_segment(
    const int* addr, const int* is_write, const int* core, const int* tier,
    const int* sc, const int* ptl, int* l1p, int* l2p, int* stats,
    int* pmap, int* counts, int* mig_rd, int* mig_wr, int* slots,
    int* snaps, int* meas, int b, int e, int slot_len, int n_p, int k_max,
    int count_bound, int cores, int l1_sets, int l1_ways, int l2_sets,
    int l2_ways, int n_targets, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b == 0 || e == 0) return cudaSuccess;
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const Geometry g{cores, l1_sets, l1_ways, l2_sets, l2_ways, n_targets};
  const size_t stats_bytes = static_cast<size_t>((8 + 2 * n_targets + 3) & ~3)
                             * sizeof(int);
  const size_t l1_words = static_cast<size_t>(cores) * l1_sets * l1_ways * 3;
  const size_t l1_bytes = ((l1_words + 3) & ~static_cast<size_t>(3))
                          * sizeof(int);
  const size_t pg_bytes = 2 * static_cast<size_t>(n_p) * sizeof(int);
  const size_t limit = static_cast<size_t>(smem_max);
  const int l1_in_smem = stats_bytes + l1_bytes <= limit ? 1 : 0;
  size_t smem = stats_bytes + (l1_in_smem ? l1_bytes : 0);
  const int pg_in_smem = smem + pg_bytes <= limit ? 1 : 0;
  smem += pg_in_smem ? pg_bytes : 0;
  err = cudaFuncSetAttribute(mesi_dyn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mesi_dyn_kernel<<<b, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      addr, is_write, core, tier, sc, ptl, l1p, l2p, stats, pmap, counts,
      mig_rd, mig_wr, slots, snaps, meas, e, slot_len, n_p, k_max,
      count_bound, g, l1_in_smem, pg_in_smem);
  return cudaGetLastError();
}

extern "C" const char* mesi_dyn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
