"""Two-level set-associative MESI cache model (batched, PyTorch).

Models the paper's Table-I host: up to N cores with private L1s and a shared
L2/LLC under a MESI directory ("Two-level, Directory-based").  gem5 walks a
C++ event queue per access; here *trace order* stays sequential while every
per-access operation — tag compare across ways, LRU victim select,
directory sharer updates — is a tensor op over the ways and over a leading
batch of independent configurations.  :func:`_packed_step` is the plain
version of the CUDA kernel in :mod:`repro_torch.kernels.cache_sim`, which
runs the same state machine with one warp per batch row.

The simulator tracks, per access, which memory *target* backs the line —
0 = local DRAM, 1..n_targets-1 = CXL expander endpoints, as chosen by the
page-placement policy (:mod:`repro_torch.core.numa`); the binary DRAM/CXL
machine is the `n_targets == 2` special case.  Misses/writebacks are
priced per target by :mod:`repro_torch.core.machine`, and the **cache
pollution** effect of CXL traffic (CXL-destined lines evicting
DRAM-destined ones) falls out of the LRU state.

State encoding (per line): tag int32 (-1 invalid), last-use int32, MESI
state int32 {I=0,S=1,E=2,M=3}, tier int32, plus an L2 directory bitmask of
L1 sharers (int32, so at most 31 cores).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

# MESI states
I, S, E, M = 0, 1, 2, 3

# Sentinel-padding convention: padded trace entries carry this address
# (real line addresses are >= 0); gated steps and the CUDA kernel skip all
# state/stat updates for them.
SENTINEL = -1

# ---- stats layout ----------------------------------------------------------
# The layout is parameterized by the number of memory *targets* the routed
# lines can hit (target 0 = local DRAM, targets 1..T-1 = CXL expanders):
# 4 base counters, then T per-target memory reads, then T per-target memory
# writes, then 4 coherence counters.  For the binary-tier case (T == 2:
# DRAM + one CXL pool) this is the historical 12-slot layout.
L1_HIT, L1_MISS, L2_HIT, L2_MISS = 0, 1, 2, 3
MEM_READ = 4                       # base of the per-target read counters


def mem_write_base(n_targets: int = 2) -> int:
    """First index of the per-target memory-write counters."""
    return MEM_READ + n_targets


def coherence_base(n_targets: int = 2) -> int:
    """Index of `upgrades` (first of the 4 coherence counters)."""
    return MEM_READ + 2 * n_targets


def nstats(n_targets: int = 2) -> int:
    return 8 + 2 * n_targets


def stat_names(n_targets: int = 2) -> Tuple[str, ...]:
    """Counter names for a `n_targets`-wide stats vector.

    T == 2 keeps the historical dram/cxl names; T > 2 names the CXL targets
    `cxl0..cxl{T-2}` (target ids 1..T-1).
    """
    if n_targets == 2:
        mem = ("mem_read_dram", "mem_read_cxl",
               "mem_write_dram", "mem_write_cxl")
    else:
        cxl = [f"cxl{k}" for k in range(n_targets - 1)]
        mem = tuple(["mem_read_dram"] + [f"mem_read_{c}" for c in cxl]
                    + ["mem_write_dram"] + [f"mem_write_{c}" for c in cxl])
    return ("l1_hit", "l1_miss", "l2_hit", "l2_miss", *mem,
            "upgrades", "invalidations", "back_invalidations",
            "writebacks_l1")


# Binary-tier (T == 2) indices of the 12-slot layout.
MEM_READ_DRAM, MEM_READ_CXL = 4, 5
MEM_WRITE_DRAM, MEM_WRITE_CXL = 6, 7
UPGRADES, INVALIDATIONS, BACK_INVALIDATIONS, WRITEBACKS_L1 = 8, 9, 10, 11
NSTATS = nstats(2)
STAT_NAMES = stat_names(2)


@dataclasses.dataclass(frozen=True)
class CacheParams:
    """Geometry: sizes in bytes; sets derived (power of two enforced).

    `n_targets` sizes the stats vector (see the stats-layout block above):
    the `tier` trace field carries target ids in [0, n_targets).  The
    default 2 is the binary DRAM/CXL machine.  `cores` is at most 31: the
    L2 directory keeps its sharers in an int32 bitmask (`1 << core`).
    """
    l1_bytes: int = 64 * 1024
    l1_ways: int = 8
    l2_bytes: int = 2 * 1024 * 1024
    l2_ways: int = 16
    line_bytes: int = 64
    cores: int = 1
    n_targets: int = 2

    def __post_init__(self):
        if not 1 <= self.cores <= 31:
            raise ValueError(f"cores must lie in [1, 31] (int32 sharer "
                             f"mask), got {self.cores}")
        if self.n_targets < 1:
            raise ValueError(f"n_targets must be >= 1, got {self.n_targets}")

    @property
    def l1_sets(self) -> int:
        s = self.l1_bytes // (self.l1_ways * self.line_bytes)
        if s <= 0 or s & (s - 1) != 0:
            raise ValueError(f"L1 sets must be a power of two, got {s}")
        return s

    @property
    def l2_sets(self) -> int:
        s = self.l2_bytes // (self.l2_ways * self.line_bytes)
        if s <= 0 or s & (s - 1) != 0:
            raise ValueError(f"L2 sets must be a power of two, got {s}")
        return s


class CacheState(NamedTuple):
    l1_tag: torch.Tensor     # (cores, l1_sets, l1_ways) int32, -1 invalid
    l1_use: torch.Tensor     # (cores, l1_sets, l1_ways) int32 last-use time
    l1_state: torch.Tensor   # (cores, l1_sets, l1_ways) int32 MESI
    l2_tag: torch.Tensor     # (l2_sets, l2_ways) int32
    l2_use: torch.Tensor     # (l2_sets, l2_ways) int32
    l2_state: torch.Tensor   # (l2_sets, l2_ways) int32 (M == dirty-in-L2)
    l2_tier: torch.Tensor    # (l2_sets, l2_ways) int32 backing tier of the line
    l2_sharers: torch.Tensor # (l2_sets, l2_ways) int32 bitmask of L1 sharers


def init_state(p: CacheParams, device=None) -> CacheState:
    """Empty hierarchy: every tag invalid (-1), every clock and state 0."""
    z1 = (p.cores, p.l1_sets, p.l1_ways)
    z2 = (p.l2_sets, p.l2_ways)

    def full(shape):
        return torch.full(shape, -1, dtype=torch.int32, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return CacheState(
        l1_tag=full(z1), l1_use=zeros(z1), l1_state=zeros(z1),
        l2_tag=full(z2), l2_use=zeros(z2), l2_state=zeros(z2),
        l2_tier=zeros(z2), l2_sharers=zeros(z2))


# ---------------------------------------------------------------------------
# Packed state: the batched engine's carry
# ---------------------------------------------------------------------------
# The packed representation stacks the per-line planes into trailing axes —
# L1 (..., cores, sets, ways, 3)=[tag,use,state], L2 (..., sets, ways,
# 5)=[tag,use,state,tier,sharers] — so each hierarchy update is one write of
# a small block.  The engine threads `(l1p, l2p, stats, t)` with a leading
# batch axis between trace segments; the CUDA kernel takes the same layout.

def pack_state(st: CacheState):
    l1p = torch.stack([st.l1_tag, st.l1_use, st.l1_state], dim=-1)
    l2p = torch.stack([st.l2_tag, st.l2_use, st.l2_state, st.l2_tier,
                       st.l2_sharers], dim=-1)
    return l1p, l2p


def unpack_state(l1p, l2p) -> CacheState:
    return CacheState(
        l1_tag=l1p[..., 0], l1_use=l1p[..., 1], l1_state=l1p[..., 2],
        l2_tag=l2p[..., 0], l2_use=l2p[..., 1], l2_state=l2p[..., 2],
        l2_tier=l2p[..., 3], l2_sharers=l2p[..., 4])


def init_batch_carry(p: CacheParams, b: int, device=None):
    """Fresh batched carry `(l1p, l2p, stats, t)`, leading axis `b`.

    The clock starts at 1, as in the sequential model.  Every tensor is
    its own contiguous memory (no broadcast views), so the carry can be
    updated in place.
    """
    l1p, l2p = pack_state(init_state(p, device))
    return (l1p.expand((b,) + l1p.shape).contiguous(),
            l2p.expand((b,) + l2p.shape).contiguous(),
            torch.zeros((b, nstats(p.n_targets)), dtype=torch.int32,
                        device=device),
            torch.ones((b,), dtype=torch.int32, device=device))


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none is)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


def _packed_step(p: CacheParams, carry, x):
    """One access for every batch row, over packed state.

    `carry` is `(l1p, l2p, stats, t)` with a leading batch axis B and `x`
    is `(addr, is_write, core, tier, valid)`, each (B,): `addr`, `core`
    and `tier` int32, `is_write` and `valid` bool.  Rows whose `valid` is
    False are sentinel padding and leave state and stats untouched; the
    clock advances for every row.

    The operation order is the MESI access of the reference model, step for
    step: the write-invalidation of other cores' copies comes before the L1
    victim is read, the L1 victim's writeback into its L2 cell is visible to
    the L2 lookup that follows, back-invalidation of the L2 victim's L1
    copies comes before the L1 install, and every counter uses the values
    as they stood at its step.  Ties in every tag match and LRU choice go to
    the lowest way.

    `l1p`, `l2p` and `stats` are updated in place (the caller owns them);
    the returned clock is a new tensor.
    """
    l1p, l2p, stats, t = carry
    a, w, c, tr, valid = x
    rows = torch.arange(a.shape[0], device=a.device)
    cl = c.long()
    zero = torch.zeros_like(a)

    # ---------------- L1 lookup ----------------
    set1 = (a & (p.l1_sets - 1)).long()
    all1 = l1p[rows, :, set1]                        # (B, cores, ways, 3)
    own = all1[rows, cl]                              # (B, ways, 3)
    row_t, row_u, row_s = own[..., 0], own[..., 1], own[..., 2]
    hits = (row_t == a[:, None]) & (row_s != I)
    l1_hit = hits.any(dim=1)
    way1 = torch.where(l1_hit, _first(hits), torch.argmin(row_u, dim=1))
    cur_state = row_s.gather(1, way1[:, None])[:, 0]
    needs_upgrade = l1_hit & w & (cur_state == S)

    if p.cores == 1:
        n_other = zero
    else:
        copies = (all1[..., 0] == a[:, None, None]) & (all1[..., 2] != I)
        others = (torch.arange(p.cores, device=a.device)[None, :, None]
                  != cl[:, None, None])
        other = copies & others
        n_other = other.sum(dim=(1, 2), dtype=torch.int32)
        # invalidate other copies on any write (upgrade or RFO fill)
        inval = other & (w & valid)[:, None, None]
        l1p[..., 2][rows, :, set1] = torch.where(inval, I, all1[..., 2])

    # ---------------- L1 victim writeback (on miss) ----------------
    evict_valid = (~l1_hit) & (cur_state != I)
    evict_tag = row_t.gather(1, way1[:, None])[:, 0]
    evict_dirty = evict_valid & (cur_state == M)
    eset2 = (evict_tag & (p.l2_sets - 1)).long()
    erow = l2p[rows, eset2]                           # (B, ways, 5)
    ehits = erow[..., 0] == evict_tag[:, None]
    ehit = ehits.any(dim=1)
    eway = torch.where(ehit, _first(ehits), torch.argmin(erow[..., 1], dim=1))
    ecell = erow[rows, eway]                          # (B, 5)
    me = torch.bitwise_left_shift(torch.ones_like(c), c)
    l2p[..., 2][rows, eset2, eway] = torch.where(
        evict_dirty & ehit & valid, M, ecell[:, 2])
    l2p[..., 4][rows, eset2, eway] = torch.where(
        evict_valid & ehit & valid, ecell[:, 4] & ~me, ecell[:, 4])

    # ---------------- L2 lookup (only meaningful on L1 miss) --------------
    set2 = (a & (p.l2_sets - 1)).long()
    row2 = l2p[rows, set2]                            # (B, ways, 5)
    hits2 = row2[..., 0] == a[:, None]
    l2_hit_raw = hits2.any(dim=1)
    way2 = torch.where(l2_hit_raw, _first(hits2),
                       torch.argmin(row2[..., 1], dim=1))
    l2_hit = l2_hit_raw & (~l1_hit)
    l2_miss = (~l2_hit_raw) & (~l1_hit)

    # ---- L2 victim handling on fill: back-invalidate + writeback ----
    v_cell = row2[rows, way2]                         # (B, 5)
    v_tag, v_state, v_tier = v_cell[:, 0], v_cell[:, 2], v_cell[:, 3]
    v_valid = l2_miss & (v_state != I) & (v_tag != a)
    vset1 = (v_tag & (p.l1_sets - 1)).long()
    vall = l1p[rows, :, vset1]                        # (B, cores, ways, 3)
    v_copies = (vall[..., 0] == v_tag[:, None, None]) & (vall[..., 2] != I)
    v_l1_dirty = (v_copies & (vall[..., 2] == M)).any(dim=2).any(dim=1)
    l1p[..., 2][rows, :, vset1] = torch.where(
        v_copies & (v_valid & valid)[:, None, None], I, vall[..., 2])
    v_dirty = v_valid & ((v_state == M) | v_l1_dirty)

    # ---- install / update line in L2 ----
    fill2 = l2_miss & valid
    touch2 = (l2_hit | l2_miss) & valid
    l2p[rows, set2, way2] = torch.stack([
        torch.where(fill2, a, v_cell[:, 0]),
        torch.where(touch2, t, v_cell[:, 1]),
        torch.where(fill2, E, v_cell[:, 2]),
        torch.where(fill2, tr, v_cell[:, 3]),
        torch.where(fill2, me,
                    torch.where(l2_hit & valid, v_cell[:, 4] | me,
                                v_cell[:, 4])),
    ], dim=1)

    # ---------------- install / update line in L1 ----------------
    sole = n_other == 0
    fill_state = torch.where(w, M, torch.where(sole, E, S))
    hit_state = torch.where(w, M, cur_state)
    new_state = torch.where(l1_hit, hit_state, fill_state).to(torch.int32)
    old1 = l1p[rows, cl, set1, way1]                  # (B, 3)
    l1p[rows, cl, set1, way1] = torch.where(
        valid[:, None], torch.stack([a, t, new_state], dim=1), old1)

    # ---- stats: one vector add, columns ordered as stat_names(n_targets) --
    n_v = v_copies.sum(dim=(1, 2), dtype=torch.int32)
    incs = torch.stack(
        [l1_hit, ~l1_hit, l2_hit, l2_miss]
        + [l2_miss & (tr == k) for k in range(p.n_targets)]
        + [v_dirty & (v_tier == k) for k in range(p.n_targets)]
        + [needs_upgrade], dim=1).to(torch.int32)
    incs = torch.cat([incs, torch.stack(
        [torch.where(w, n_other, zero), torch.where(v_valid, n_v, zero),
         evict_dirty.to(torch.int32)], dim=1)], dim=1)
    stats += incs * valid.to(torch.int32)[:, None]
    return l1p, l2p, stats, t + 1


def simulate_trace(p: CacheParams, state: CacheState,
                   addr: torch.Tensor, is_write: torch.Tensor,
                   core: torch.Tensor | None = None,
                   tier: torch.Tensor | None = None
                   ) -> Tuple[CacheState, torch.Tensor]:
    """Run one (N,) trace through the hierarchy, every access live.

    Args:
      addr:     (N,) int32 cacheline indices (window-relative).
      is_write: (N,) bool.
      core:     (N,) int32 issuing core (default 0).
      tier:     (N,) int32 backing target per access (0=DRAM, 1..=CXL
                targets; default 0).

    Returns: (final_state, stats[nstats(p.n_targets)] int32) — see
    `stat_names(p.n_targets)`.  The clock starts at 1.
    """
    device = addr.device
    n = addr.shape[0]
    zeros = torch.zeros(n, dtype=torch.int32, device=device)
    core = zeros if core is None else core.to(torch.int32)
    tier = zeros if tier is None else tier.to(torch.int32)
    l1p, l2p = pack_state(state)
    carry = (l1p[None].clone(), l2p[None].clone(),
             torch.zeros((1, nstats(p.n_targets)), dtype=torch.int32,
                         device=device),
             torch.ones((1,), dtype=torch.int32, device=device))
    addr = addr.to(torch.int32)
    is_write = is_write.to(torch.bool)
    live = torch.ones((1,), dtype=torch.bool, device=device)
    for i in range(n):
        carry = _packed_step(p, carry, (addr[i:i + 1], is_write[i:i + 1],
                                        core[i:i + 1], tier[i:i + 1], live))
    l1p, l2p, stats, _ = carry
    return unpack_state(l1p[0], l2p[0]), stats[0]


def stats_dict(stats) -> Dict[str, int]:
    """Counter dict; the target count is inferred from the vector width."""
    t = (len(stats) - 8) // 2
    return {n: int(v) for n, v in zip(stat_names(t), stats)}


def snapshot_deltas(snapshots) -> np.ndarray:
    """Per-slot counter deltas from cumulative stat snapshots.

    The dynamic-tiering program (:mod:`repro_torch.core.tiering_dyn`)
    emits the cumulative stats after every epoch slot; row ``e`` of the
    result is what slot ``e`` contributed.  Host NumPy int64, (E, nstats).
    """
    s = np.asarray(snapshots, np.int64)
    if s.ndim != 2:
        raise ValueError(f"snapshots must be (E, nstats), got {s.shape}")
    return np.diff(s, axis=0, prepend=np.zeros((1, s.shape[1]), np.int64))


def dram_traffic_fraction(delta_stats, n_targets: int = 2) -> np.ndarray:
    """DRAM share of memory-line traffic per snapshot delta row.

    ``(mem_read_dram + mem_write_dram) / (all reads + writes)`` for each
    row of a :func:`snapshot_deltas` result; rows with no memory traffic
    report 0.0.  Host NumPy float64, (E,).
    """
    d = np.asarray(delta_stats, np.int64)
    wb = mem_write_base(n_targets)
    reads = d[:, MEM_READ:MEM_READ + n_targets]
    writes = d[:, wb:wb + n_targets]
    total = reads.sum(axis=1) + writes.sum(axis=1)
    dram = reads[:, 0] + writes[:, 0]
    return np.where(total > 0, dram / np.maximum(total, 1), 0.0)


def miss_rates(stats) -> Dict[str, float]:
    s = stats_dict(stats)
    l1_acc = s["l1_hit"] + s["l1_miss"]
    l2_acc = s["l2_hit"] + s["l2_miss"]
    return {
        "l1_miss_rate": s["l1_miss"] / max(l1_acc, 1),
        "l2_miss_rate": s["l2_miss"] / max(l2_acc, 1),   # LLC (paper Fig. 5)
        "llc_mpki": 1000.0 * s["l2_miss"] / max(l1_acc, 1),
    }
