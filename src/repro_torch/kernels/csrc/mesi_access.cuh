// One access of the two-level MESI + tier state machine, for one warp.
//
// The per-access body shared by mesi.cu (K1/K2) and mesi_dyn.cu (K3): the
// port of `_mesi_access` in src/repro/kernels/cache_sim.py.  The reference
// it must equal bit for bit is repro_torch.core.cache._packed_step.
//
// The caller is one warp (32 lanes); lanes span the ways, so the tag
// compare is one ballot and the LRU victim one 5-step shuffle reduction on
// (use, way) pairs that prefers the lower way on ties, like argmin/argmax
// in the reference.  Every lane must call `mesi_access` with the same
// arguments; lane 0 writes the counters.
//
// The warp may hold only some of a row's sets (`Planes`): the sets of one
// chain, those whose index is congruent to the chain's number modulo the
// chain count m = 2**sh.  Every set an access touches (its L1 set in each
// core, its L2 set, its L1 victim's L2 set and its L2 victim's L1 sets)
// has the access's own address modulo m, so a chain's accesses touch its
// sets alone; a held set's slot is its global index >> sh.
//
// Access order follows the reference step for step: the write-invalidation
// of other cores' copies before the L1 victim is used, the L1 victim's
// writeback into its L2 cell before the L2 lookup (the same set is
// possible), back-invalidation of the L2 victim's L1 copies before the L1
// install, which writes the whole [tag, use, state] cell last.
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace mesi {

constexpr int kI = 0, kS = 1, kE = 2, kM = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kL1Hit = 0, kL1Miss = 1, kL2Hit = 2, kL2Miss = 3, kMemRead = 4;
constexpr int kSentinel = -1;

struct Geometry {
  int cores, s1, w1, s2, w2, n_targets;
};

// The cache state one warp walks: `l1` holds (cores, l1_sets, w1, 3) ints,
// `l2` (s2 >> sh2, w2, 5); global set index s sits in slot s >> sh1 (L1)
// or s >> sh2 (L2).  A whole row's planes are the case sh1 = sh2 = 0.
struct Planes {
  int* l1;
  int* l2;
  int l1_sets, sh1, sh2;
};

// Lane holding the smallest `v` among active lanes; ties go to the lowest
// lane.  Every lane of the warp must call it and every lane gets the answer.
__device__ __forceinline__ int warp_argmin(int v, bool active) {
  int val = active ? v : INT_MAX;
  int idx = active ? static_cast<int>(threadIdx.x & 31) : 32;
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

// One live access (a != kSentinel) of line `a` by core `c` to memory target
// `tr` at clock `t`, on the planes `pl` (which hold the access's sets), with
// counters `st`.  `gate` (0 or 1) gates every counter increment: 0 is a
// functional-warming access, whose state changes are kept and whose counts
// are not.
__device__ __forceinline__ void mesi_access(int a, bool w, int c, int tr,
                                            int t, int gate,
                                            const Planes& pl, int* st,
                                            const Geometry& g, int lane) {
  const bool l1_lane = lane < g.w1;
  const bool l2_lane = lane < g.w2;
  const int wbase = kMemRead + g.n_targets;
  const int cbase = kMemRead + 2 * g.n_targets;  // upgrades, inval, binval, wb

  // ---------------- L1 lookup ----------------
  int* const l1 = pl.l1;
  const int set1 = (a & (g.s1 - 1)) >> pl.sh1;   // the L1 set's slot
  int* row1 = l1 + (static_cast<long>(c) * pl.l1_sets + set1) * g.w1 * 3;
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
    int* rk = l1 + (static_cast<long>(k) * pl.l1_sets + set1) * g.w1 * 3;
    const bool copy = l1_lane && rk[lane * 3] == a && rk[lane * 3 + 2] != kI;
    n_other += __popc(__ballot_sync(kFull, copy));
    if (copy && w) rk[lane * 3 + 2] = kI;
  }

  // ---------------- L1 victim writeback into the inclusive L2 --------
  const bool evict_valid = !l1_hit && cur_state != kI;
  const bool evict_dirty = evict_valid && cur_state == kM;
  if (evict_valid) {
    int* erow = pl.l2 + static_cast<long>((evict_tag & (g.s2 - 1)) >> pl.sh2)
                * g.w2 * 5;
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
    int* row2 = pl.l2 + static_cast<long>((a & (g.s2 - 1)) >> pl.sh2)
                * g.w2 * 5;
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
    const int way2 = l2_hit ? __ffs(hit2) - 1 : warp_argmin(use2, l2_lane);
    const int v_tag = __shfl_sync(kFull, tag2, way2);
    const int v_state = __shfl_sync(kFull, st2, way2);
    v_tier = __shfl_sync(kFull, tier2, way2);
    v_valid = l2_miss && v_state != kI && v_tag != a;
    if (v_valid) {
      // back-invalidate every L1 copy of the L2 victim (inclusion)
      const int vset1 = (v_tag & (g.s1 - 1)) >> pl.sh1;
      bool v_l1_dirty = false;
      for (int k = 0; k < g.cores; ++k) {
        int* rk = l1 + (static_cast<long>(k) * pl.l1_sets + vset1) * g.w1 * 3;
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
    if (gate) {
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
  }
  __syncwarp();
}

}  // namespace mesi
