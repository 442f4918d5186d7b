// Two-level MESI + tier cache state machine over a (B, N) trace batch.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cache_sim.py:
// `mesi_cache_sim` (grid body `_mesi_kernel`) and `mesi_segment` (grid body
// `_mesi_segment_kernel`), which share the per-access body `_mesi_access`.
// One kernel serves both: it advances the engine's packed carry
// (l1p, l2p, stats, t) over one trace segment, and a fresh carry gives the
// whole-trace simulation.  The reference it must equal bit for bit is
// repro_torch.core.cache._packed_step (and repro.core.cache._packed_step).
//
// What bounds it: the serial dependency chain, not bytes.  Every access
// reads the cache state the previous access wrote, so a row is one long
// chain of dependent loads, compares and stores; the trace itself is
// 16 bytes per access and the state is read and written once.
//
// What the design does about it:
//   * one warp (32 lanes) per batch row, one block per row; lanes span the
//     ways, so the tag compare is one ballot and the LRU victim one
//     5-step shuffle reduction on (use, way) pairs that prefers the lower
//     way on ties, like argmin/argmax in the reference;
//   * the L1 planes (3 * cores * l1_sets * l1_ways ints, 12 KiB per core at
//     the Table-I geometry) live in shared memory when they fit, else in
//     global memory; the L2 planes (640 KiB at Table-I) stay in global
//     memory, where the card's 50 MB L2 cache holds them for B <= ~70 rows;
//   * the trace is fetched 32 accesses at a time by coalesced loads and
//     broadcast from registers by shuffles, so no trace load sits on the
//     chain; an L1 hit and a sentinel touch no L2 state at all;
//   * only B SMs are busy: the card is mostly idle at B <= 12.  Spreading a
//     row over several SMs is later work.
//
// Access order follows the reference step for step: the write-invalidation
// of other cores' copies before the L1 victim is used, the L1 victim's
// writeback into its L2 cell before the L2 lookup (the same set is
// possible), back-invalidation of the L2 victim's L1 copies before the L1
// install, which writes the whole [tag, use, state] cell last.  Sentinel
// entries (addr == -1) change nothing, but the clock advances across them.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kI = 0, kS = 1, kE = 2, kM = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kL1Hit = 0, kL1Miss = 1, kL2Hit = 2, kL2Miss = 3, kMemRead = 4;
constexpr int kSentinel = -1;

struct Geometry {
  int cores, s1, w1, s2, w2, n_targets;
};

// Lane holding the smallest `v` among active lanes; ties go to the lowest
// lane.  Every lane of the warp must call it and every lane gets the answer.
__device__ __forceinline__ int warp_argmin(int v, bool active) {
  int val = active ? v : INT_MAX;
  int idx = active ? static_cast<int>(threadIdx.x) : 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, val, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ov < val || (ov == val && oi < idx)) {
      val = ov;
      idx = oi;
    }
  }
  return idx;
}

__global__ void __launch_bounds__(32) mesi_segment_kernel(
    const int* __restrict__ addr, const int* __restrict__ is_write,
    const int* __restrict__ core, const int* __restrict__ tier,
    const int* __restrict__ t0, int n, int* __restrict__ l1p,
    int* __restrict__ l2p, int* __restrict__ stats, Geometry g,
    int l1_in_smem) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x;
  const long row = blockIdx.x;
  const int ns = 8 + 2 * g.n_targets;
  const int wbase = kMemRead + g.n_targets;
  const int cbase = kMemRead + 2 * g.n_targets;  // upgrades, inval, binval, wb
  const long l1_len = static_cast<long>(g.cores) * g.s1 * g.w1 * 3;
  const long l2_len = static_cast<long>(g.s2) * g.w2 * 5;

  int* st = smem;  // the row's counters
  int* l1 = l1p + row * l1_len;
  int* const l2 = l2p + row * l2_len;
  for (int k = lane; k < ns; k += 32) st[k] = stats[row * ns + k];
  if (l1_in_smem) {
    int* l1s = smem + ((ns + 3) & ~3);
    for (long k = lane; k < l1_len; k += 32) l1s[k] = l1[k];
    l1 = l1s;
  }
  __syncwarp();

  const bool l1_lane = lane < g.w1;
  const bool l2_lane = lane < g.w2;
  const int* ra = addr + row * n;
  const int* rw = is_write + row * n;
  const int* rc = core + row * n;
  const int* rt = tier + row * n;
  int t = t0[row];

  for (int base = 0; base < n; base += 32) {
    int ca = kSentinel, cw = 0, cc = 0, ct = 0;
    if (base + lane < n) {
      ca = ra[base + lane];
      cw = rw[base + lane];
      cc = rc[base + lane];
      ct = rt[base + lane];
    }
    const int m = min(32, n - base);
    for (int j = 0; j < m; ++j, ++t) {
      const int a = __shfl_sync(kFull, ca, j);
      const bool w = __shfl_sync(kFull, cw, j) != 0;
      const int c = __shfl_sync(kFull, cc, j);
      const int tr = __shfl_sync(kFull, ct, j);
      if (a == kSentinel) continue;  // warp-uniform: padding touches nothing

      // ---------------- L1 lookup ----------------
      const int set1 = a & (g.s1 - 1);
      int* row1 = l1 + (static_cast<long>(c) * g.s1 + set1) * g.w1 * 3;
      int tag1 = 0, use1 = 0, st1 = kI;
      if (l1_lane) {
        tag1 = row1[lane * 3];
        use1 = row1[lane * 3 + 1];
        st1 = row1[lane * 3 + 2];
      }
      const unsigned hit1 =
          __ballot_sync(kFull, l1_lane && tag1 == a && st1 != kI);
      const bool l1_hit = hit1 != 0;
      const int way1 = l1_hit ? __ffs(hit1) - 1 : warp_argmin(use1, l1_lane);
      const int cur_state = __shfl_sync(kFull, st1, way1);
      const int evict_tag = __shfl_sync(kFull, tag1, way1);
      const bool upgrade = l1_hit && w && cur_state == kS;

      // directory probe of the other cores; a write invalidates their copies
      int n_other = 0;
      for (int k = 0; k < g.cores; ++k) {
        if (k == c) continue;
        int* rk = l1 + (static_cast<long>(k) * g.s1 + set1) * g.w1 * 3;
        const bool copy =
            l1_lane && rk[lane * 3] == a && rk[lane * 3 + 2] != kI;
        n_other += __popc(__ballot_sync(kFull, copy));
        if (copy && w) rk[lane * 3 + 2] = kI;
      }

      // ---------------- L1 victim writeback into the inclusive L2 --------
      const bool evict_valid = !l1_hit && cur_state != kI;
      const bool evict_dirty = evict_valid && cur_state == kM;
      if (evict_valid) {
        int* erow = l2 + static_cast<long>(evict_tag & (g.s2 - 1)) * g.w2 * 5;
        const unsigned eh =
            __ballot_sync(kFull, l2_lane && erow[lane * 5] == evict_tag);
        if (eh != 0 && lane == 0) {
          int* cell = erow + (__ffs(eh) - 1) * 5;
          if (evict_dirty) cell[2] = kM;
          cell[4] &= ~(1 << c);
        }
        __syncwarp();
      }

      // ---------------- L2 lookup, victim and fill (L1 miss only) --------
      bool l2_hit = false, l2_miss = false, v_valid = false, v_dirty = false;
      int n_v = 0, v_tier = 0;
      if (!l1_hit) {
        int* row2 = l2 + static_cast<long>(a & (g.s2 - 1)) * g.w2 * 5;
        int tag2 = 0, use2 = 0, st2 = kI, tier2 = 0;
        if (l2_lane) {
          tag2 = row2[lane * 5];
          use2 = row2[lane * 5 + 1];
          st2 = row2[lane * 5 + 2];
          tier2 = row2[lane * 5 + 3];
        }
        const unsigned hit2 = __ballot_sync(kFull, l2_lane && tag2 == a);
        l2_hit = hit2 != 0;
        l2_miss = !l2_hit;
        const int way2 =
            l2_hit ? __ffs(hit2) - 1 : warp_argmin(use2, l2_lane);
        const int v_tag = __shfl_sync(kFull, tag2, way2);
        const int v_state = __shfl_sync(kFull, st2, way2);
        v_tier = __shfl_sync(kFull, tier2, way2);
        v_valid = l2_miss && v_state != kI && v_tag != a;
        if (v_valid) {
          // back-invalidate every L1 copy of the L2 victim (inclusion)
          const int vset1 = v_tag & (g.s1 - 1);
          bool v_l1_dirty = false;
          for (int k = 0; k < g.cores; ++k) {
            int* rk = l1 + (static_cast<long>(k) * g.s1 + vset1) * g.w1 * 3;
            int sk = kI;
            bool copy = false;
            if (l1_lane) {
              sk = rk[lane * 3 + 2];
              copy = rk[lane * 3] == v_tag && sk != kI;
            }
            n_v += __popc(__ballot_sync(kFull, copy));
            v_l1_dirty |= __ballot_sync(kFull, copy && sk == kM) != 0;
            if (copy) rk[lane * 3 + 2] = kI;
          }
          v_dirty = v_state == kM || v_l1_dirty;
        }
        if (lane == 0) {
          int* cell = row2 + way2 * 5;
          if (l2_miss) {
            cell[0] = a;
            cell[2] = kE;
            cell[3] = tr;
            cell[4] = 1 << c;
          } else {
            cell[4] |= 1 << c;
          }
          cell[1] = t;
        }
      }

      // ---------------- L1 install, then the counters ----------------
      __syncwarp();  // a back-invalidation may have written this very cell
      if (lane == 0) {
        const int fill_state = w ? kM : (n_other == 0 ? kE : kS);
        const int hit_state = w ? kM : cur_state;
        int* cell = row1 + way1 * 3;
        cell[0] = a;
        cell[1] = t;
        cell[2] = l1_hit ? hit_state : fill_state;
        st[kL1Hit] += l1_hit;
        st[kL1Miss] += !l1_hit;
        st[kL2Hit] += l2_hit;
        st[kL2Miss] += l2_miss;
        if (l2_miss && tr >= 0 && tr < g.n_targets) st[kMemRead + tr] += 1;
        if (v_dirty && v_tier >= 0 && v_tier < g.n_targets)
          st[wbase + v_tier] += 1;
        st[cbase] += upgrade;
        st[cbase + 1] += w ? n_other : 0;
        st[cbase + 2] += v_valid ? n_v : 0;
        st[cbase + 3] += evict_dirty;
      }
      __syncwarp();
    }
  }

  for (int k = lane; k < ns; k += 32) stats[row * ns + k] = st[k];
  if (l1_in_smem) {
    int* out = l1p + row * l1_len;
    for (long k = lane; k < l1_len; k += 32) out[k] = l1[k];
  }
}

}  // namespace

// Advance the carry (l1p, l2p, stats) of `b` rows in place over an
// (b, n) int32 trace; `t0` holds each row's clock before the segment.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mesi_segment(const int* addr, const int* is_write,
                            const int* core, const int* tier, const int* t0,
                            int* l1p, int* l2p, int* stats, int b, int n,
                            int cores, int l1_sets, int l1_ways, int l2_sets,
                            int l2_ways, int n_targets, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (b == 0 || n == 0) return cudaSuccess;
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const Geometry g{cores, l1_sets, l1_ways, l2_sets, l2_ways, n_targets};
  const size_t stats_bytes = static_cast<size_t>((8 + 2 * n_targets + 3) & ~3)
                             * sizeof(int);
  const size_t l1_bytes =
      static_cast<size_t>(cores) * l1_sets * l1_ways * 3 * sizeof(int);
  const int l1_in_smem =
      stats_bytes + l1_bytes <= static_cast<size_t>(smem_max) ? 1 : 0;
  const size_t smem = stats_bytes + (l1_in_smem ? l1_bytes : 0);
  err = cudaFuncSetAttribute(mesi_segment_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mesi_segment_kernel<<<b, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      addr, is_write, core, tier, t0, n, l1p, l2p, stats, g, l1_in_smem);
  return cudaGetLastError();
}

extern "C" const char* mesi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
