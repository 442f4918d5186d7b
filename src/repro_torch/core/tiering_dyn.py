"""Epoch-based dynamic tiering: TPP-style hot-page promotion / demotion.

The paper characterizes *static* page placement (:mod:`repro_torch.core.
numa`).  Real deployments run a dynamic tierer: the kernel counts per-page
accesses over an epoch, migrates hot pages CXL->DRAM and, under DRAM
capacity pressure, demotes cold pages DRAM->CXL (Linux NUMA balancing /
TPP).  This module is that policy dimension for the batched engine
(:mod:`repro_torch.core.engine`):

  * the stacked trace is split into fixed-length **epoch slots**; within a
    slot every access runs the exact MESI step of :mod:`repro_torch.core.
    cache`, routed through the row's page map;
  * per-page access counters accumulate over the epoch;
  * at each epoch boundary the **promotion/demotion rule** runs: the top-k
    hottest CXL pages (count >= ``threshold``) promote to DRAM and, when
    DRAM capacity is exhausted, the coldest DRAM pages demote to make
    room, both bounded by the per-epoch ``budget``;
  * migration traffic (page-sized reads on the source, writes on the
    destination) is totalled per target and charged into
    :func:`repro_torch.core.machine.time_batch`'s fixed point.

Candidates are ranked by an injective integer key (:func:`encode_hot_key`),
so selection has no ties to break: the CUDA kernel's iterated argmax, the
plain version's ``torch.topk`` and the JAX package's ``lax.top_k`` pick the
same pages.  :func:`host_simulate` replays the epoch loop in NumPy (the
decisions never depend on cache state).

Static rows ride along: a row with ``budget == 0`` and ``dyn_flag == 0``
routes by its precomputed targets and never migrates, so its stats equal
the static engine path's, bit for bit.

Three tiers (DRAM -> CXL-DRAM -> CXL-SSD): on a route with a flash-backed
target (``ssd_tid > 0``) the page map is three-level and each boundary runs
a second stage after the DRAM<->CXL one: hot level-2 pages promote
SSD->CXL, then level-1 pages beyond ``cxl_capacity_pages`` demote to the
SSD.  Rows without an SSD target skip the stage.

Devices and backends: :func:`run_dynamic` runs where its trace lies.  The
epoch segment (:func:`run_dynamic_segment`) is the CUDA kernel
``mesi_dyn_segment`` on a CUDA tensor and its plain version (:func:`_slot_step`
looped over the slots) on a CPU tensor; ``backend="reference"`` forces the
plain version, ``backend="cuda"`` the kernel.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core.numa import LINES_PER_PAGE

SENTINEL = cache_mod.SENTINEL

#: Column order of the per-slot counters (``slots[..., i]``).  On
#: three-tier rows, SSD-stage migrations fold into ``promoted`` /
#: ``demoted`` (SSD->CXL counts as a promotion, CXL->SSD as a demotion).
SLOT_FIELDS = ("acc_total", "acc_dram", "promoted", "demoted")

#: "No capacity bound" sentinel for page-count scalars (fits int32).
UNBOUNDED_PAGES = 1 << 30


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DynamicTiering:
    """One dynamic-tiering policy point (an entry of ``SweepSpec.tiering``).

    Parameters
    ----------
    epoch_len : int
        Accesses per epoch.  Within one sweep every dynamic entry's
        ``epoch_len`` must be a multiple of the gcd of all entries.
    budget : int
        Maximum pages promoted per epoch (demotions are bounded by the
        same budget).  ``0`` never migrates.
    threshold : int
        Minimum access count for a CXL page to be promotion-eligible
        (>= 1, so all-sentinel pad epochs never migrate).
    dram_capacity_pages : int, optional
        DRAM pages available to this footprint; promotions beyond the free
        capacity force as many cold-page demotions.  ``None`` = unbounded.
    cxl_capacity_pages : int, optional
        CXL-DRAM (level-1) pages available before cold pages spill to the
        CXL-SSD tier; only meaningful on a route with an SSD target.
        ``None`` = unbounded.
    """
    epoch_len: int = 4096
    budget: int = 8
    threshold: int = 1
    dram_capacity_pages: Optional[int] = None
    cxl_capacity_pages: Optional[int] = None

    def __post_init__(self) -> None:
        if self.epoch_len < 1:
            raise ValueError(f"epoch_len must be >= 1, got {self.epoch_len}")
        if self.budget < 0:
            raise ValueError(f"budget must be >= 0, got {self.budget}")
        if self.threshold < 1:
            raise ValueError("threshold must be >= 1 (a zero threshold "
                             "would let all-sentinel pad epochs migrate)")

    @property
    def label(self) -> str:
        cap = ("" if self.dram_capacity_pages is None
               else f",cap={self.dram_capacity_pages}")
        l1 = ("" if self.cxl_capacity_pages is None
              else f",l1cap={self.cxl_capacity_pages}")
        return (f"tpp(e={self.epoch_len},k={self.budget},"
                f"t={self.threshold}{cap}{l1})")


def describe(tiering: Optional[DynamicTiering]) -> str:
    """Row label for the ``tiering`` sweep axis (``'static'`` for None)."""
    return "static" if tiering is None else tiering.label


def slot_length(tierings: Sequence[Optional[DynamicTiering]]) -> int:
    """Scan granularity: gcd of every dynamic entry's ``epoch_len``."""
    lens = [t.epoch_len for t in tierings if t is not None]
    if not lens:
        raise ValueError("no dynamic tiering entries")
    return functools.reduce(math.gcd, lens)


# ---------------------------------------------------------------------------
# The ranking key (promotion/demotion candidate order)
# ---------------------------------------------------------------------------
def encode_hot_key(count, page, n_pages: int):
    """Injective hotness key: higher count wins, ties -> lower page index.

    ``key = count * n_pages + (n_pages - 1 - page)`` in int32, for torch
    tensors or NumPy arrays.  Callers guard ``max_count * n_pages``
    against int32 overflow (:func:`prep_dynamic_inputs` raises).
    """
    if isinstance(count, torch.Tensor) or isinstance(page, torch.Tensor):
        count = torch.as_tensor(count).to(torch.int32)
        page = torch.as_tensor(page, device=count.device).to(torch.int32)
        return count * n_pages + ((n_pages - 1) - page)
    count = np.asarray(count).astype(np.int32)
    page = np.asarray(page).astype(np.int32)
    return count * np.int32(n_pages) + (np.int32(n_pages - 1) - page)


def decode_hot_key(key, n_pages: int):
    """Inverse of :func:`encode_hot_key` -> ``(count, page)``."""
    count = key // n_pages
    page = (n_pages - 1) - key % n_pages
    return count, page


# ---------------------------------------------------------------------------
# The plain version of the epoch program (batched over rows)
# ---------------------------------------------------------------------------
class DynOutputs(NamedTuple):
    """Per-row outputs of :func:`run_dynamic` (leading batch axis B)."""
    stats: torch.Tensor      # (B, nstats(T)) final cache/tier counters
    page_map: torch.Tensor   # (B, P) final page -> {0 DRAM, 1 CXL[, 2 SSD]}
    mig_read: torch.Tensor   # (B, T) migration lines read per target
    mig_write: torch.Tensor  # (B, T) migration lines written per target
    slots: torch.Tensor      # (B, E, 4) per-slot counters, see SLOT_FIELDS
    snapshots: torch.Tensor  # (B, E, nstats(T)) cumulative stats after each slot
    meas: torch.Tensor       # (B, E) 0/1 per-slot measurement flag


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=-1, dtype=torch.int32)


def _take(pmap, idx, mask, value):
    """``pmap[b, idx[b, r]] = value`` where ``mask[b, r]``, else unchanged."""
    return pmap.scatter(1, idx, torch.where(mask, value, pmap.gather(1, idx)))


def _lines(ptl, idx, mask):
    """Sum of ``ptl[b, idx[b, r], :]`` over the masked ranks -> (B, T)."""
    rows = ptl.gather(1, idx[..., None].expand(-1, -1, ptl.shape[2]))
    return (rows * mask[..., None]).sum(dim=1, dtype=torch.int32)


def _migration_step(pmap, counts, ptl, page_ids, pvalid, rank, budget,
                    threshold, dram_cap, do_mig, cmax: int,
                    n_pages_key: int, k_max: int):
    """One epoch-boundary promotion/demotion decision, every row at once.

    Returns ``(new_pmap, pro_lines, dem_lines, n_pro, n_dem)``, all gated
    by ``do_mig`` (B,).  Only level-1 (CXL-DRAM) pages are promotion
    candidates.  ``torch.topk`` may order the ``-1`` keys of ineligible
    pages differently from ``lax.top_k``; they are masked out of every
    scatter and sum, so the outputs agree.
    """
    is_cxl = (pmap == 1) & pvalid
    is_dram = (pmap == 0) & pvalid
    hot = is_cxl & (counts >= threshold[:, None])
    pkey = torch.where(hot, encode_hot_key(counts, page_ids, n_pages_key),
                       -1)
    pvals, pidx = torch.topk(pkey, k_max, dim=1)
    # coldness key: invert the count (cmax bounds any epoch's count)
    dkey = torch.where(is_dram,
                       encode_hot_key(cmax - counts, page_ids, n_pages_key),
                       -1)
    dvals, didx = torch.topk(dkey, k_max, dim=1)

    n_want = _count((pvals >= 0) & (rank < budget[:, None]))
    free = (dram_cap - _count(is_dram)).clamp(min=0)
    n_dem_needed = torch.minimum((n_want - free).clamp(min=0), budget)
    dmask = (dvals >= 0) & (rank < n_dem_needed[:, None]) & do_mig[:, None]
    n_dem = _count(dmask)
    pmask = ((pvals >= 0) & (rank < torch.minimum(budget, free + n_dem)[:, None])
             & do_mig[:, None])
    n_pro = _count(pmask)
    # promoted (CXL) and demoted (DRAM) page sets are disjoint
    new_pmap = _take(_take(pmap, pidx, pmask, 0), didx, dmask, 1)
    return (new_pmap, _lines(ptl, pidx, pmask), _lines(ptl, didx, dmask),
            n_pro, n_dem)


def _ssd_stage(pmap, counts, ptl, page_ids, pvalid, rank, budget,
               threshold, cxl_cap, do_ssd, cmax: int, n_pages_key: int,
               k_max: int):
    """The three-tier second stage: SSD<->CXL-DRAM traffic at a boundary.

    Runs on :func:`_migration_step`'s rewritten map: hot level-2 pages
    promote SSD->CXL (budget-bounded), then level-1 pages beyond
    ``cxl_cap`` demote their coldest CXL->SSD.  Returns ``(new_pmap,
    sup_lines, over_lines, n_sup, n_over)``, gated by ``do_ssd``.
    """
    hot2 = (pmap == 2) & pvalid & (counts >= threshold[:, None])
    skey = torch.where(hot2, encode_hot_key(counts, page_ids, n_pages_key),
                       -1)
    svals, sidx = torch.topk(skey, k_max, dim=1)
    smask = (svals >= 0) & (rank < budget[:, None]) & do_ssd[:, None]
    n_sup = _count(smask)
    new_pmap = _take(pmap, sidx, smask, 1)

    is_l1 = (new_pmap == 1) & pvalid
    over = torch.minimum((_count(is_l1) - cxl_cap).clamp(min=0), budget)
    okey = torch.where(is_l1,
                       encode_hot_key(cmax - counts, page_ids, n_pages_key),
                       -1)
    ovals, oidx = torch.topk(okey, k_max, dim=1)
    omask = (ovals >= 0) & (rank < over[:, None]) & do_ssd[:, None]
    n_over = _count(omask)
    new_pmap = _take(new_pmap, oidx, omask, 2)
    return (new_pmap, _lines(ptl, sidx, smask), _lines(ptl, oidx, omask),
            n_sup, n_over)


def _add_at(x, col, amount):
    """``x[b, col[b]] += amount[b]`` on a new tensor."""
    return x.scatter_add(1, col.long()[:, None], amount[:, None])


def slot_consts(scalars, n_p: int, k_max: int):
    """The loop-invariant inputs of :func:`_slot_step` for B rows."""
    (flag, npg, bud, thr, per, cap, ssd_t, l1cap, ptl,
     s_w, s_m, s_p) = scalars
    device = flag.device
    page_ids = torch.arange(n_p, dtype=torch.int32, device=device)
    return (flag, npg, bud, thr, per, cap, ssd_t, l1cap, s_w, s_m, s_p,
            ptl, page_ids, page_ids[None, :] < npg[:, None],
            torch.arange(k_max, dtype=torch.int32, device=device))


def _slot_step(p: cache_mod.CacheParams, k_max: int, cmax: int, n_p: int,
               consts, carry, xs):
    """One epoch slot for every row: the plain version of the K3 kernel.

    `carry` is the 9-tuple of :func:`init_dyn_carry` (its `l1p`, `l2p`
    and `stats` are updated in place: the caller owns them), `xs` the
    slot's ``(addr, is_write, core, tier, valid)``, each (B, slot_len).
    Returns ``(carry, (slots (B, 4), stats (B, nstats), meas (B,)))``.
    """
    (flag, npg, bud, thr, per, cap, ssd_t, l1cap, s_w, s_m, s_p,
     ptl, page_ids, pvalid, rank) = consts
    l1p, l2p, stats, t, pmap, counts, mig_rd, mig_wr, eidx = carry
    a_s, w_s, c_s, tr_s, v_s = xs
    page = (a_s // LINES_PER_PAGE).clamp(0, n_p - 1).long()
    intent = pmap.gather(1, page)
    # dynamic rows: the page map decides DRAM vs the precomputed CXL
    # target (level-2 pages hit the SSD target); static rows use the
    # precomputed target verbatim
    dyn = (flag != 0)[:, None]
    tgt = torch.where(dyn, torch.where(intent == 0, 0,
                                       torch.where(intent >= 2,
                                                   ssd_t[:, None], tr_s)),
                      tr_s).to(torch.int32)
    acc_t = _count(v_s)
    acc_d = _count(v_s & (torch.where(dyn, intent, tgt) == 0))
    # sampled rows (s_p > 0): slots outside [s_w, s_w + s_m) of each
    # period warm the state but leave the stats as they were
    pos = eidx % s_p.clamp(min=1)
    meas = torch.where(s_p > 0, (pos >= s_w) & (pos < s_w + s_m),
                       True).to(torch.int32)
    stats0 = stats.clone()
    state = (l1p, l2p, stats, t)
    for i in range(a_s.shape[1]):
        state = cache_mod._packed_step(
            p, state, (a_s[:, i], w_s[:, i], c_s[:, i], tgt[:, i], v_s[:, i]))
    l1p, l2p, stats, t = state
    stats = stats0 + (stats - stats0) * meas[:, None]
    counts = counts.scatter_add(1, page, v_s.to(torch.int32))
    eidx = eidx + 1
    boundary = (eidx % per) == 0
    do_mig = boundary & (bud > 0)
    new_pmap, pro_tl, dem_tl, n_pro, n_dem = _migration_step(
        pmap, counts, ptl, page_ids, pvalid, rank, bud, thr, cap, do_mig,
        cmax, n_p, k_max)
    zero = torch.zeros_like(ssd_t)
    # promotions read the page from its CXL endpoints and write it to
    # DRAM; demotions read DRAM and write the CXL endpoints
    mig_rd = mig_rd + _add_at(pro_tl, zero, n_dem * LINES_PER_PAGE)
    mig_wr = mig_wr + _add_at(dem_tl, zero, n_pro * LINES_PER_PAGE)
    # three-tier rows: SSD->CXL promotion reads the SSD target and writes
    # the page's CXL endpoints; CXL->SSD demotion the reverse
    do_ssd = do_mig & (ssd_t > 0)
    new_pmap, sup_tl, over_tl, n_sup, n_over = _ssd_stage(
        new_pmap, counts, ptl, page_ids, pvalid, rank, bud, thr, l1cap,
        do_ssd, cmax, n_p, k_max)
    mig_rd = mig_rd + _add_at(over_tl, ssd_t, n_sup * LINES_PER_PAGE)
    mig_wr = mig_wr + _add_at(sup_tl, ssd_t, n_over * LINES_PER_PAGE)
    counts = torch.where(boundary[:, None], 0, counts)
    ys = torch.stack([acc_t, acc_d, n_pro + n_sup, n_dem + n_over], dim=1)
    carry = (l1p, l2p, stats, t, new_pmap, counts, mig_rd, mig_wr, eidx)
    return carry, (ys, stats, meas)


def init_dyn_carry(p: cache_mod.CacheParams, page_map0: torch.Tensor):
    """Fresh batched epoch carry, leading axis B, on `page_map0`'s device.

    Layout: ``(l1p, l2p, stats, t, page_map, counts, mig_rd, mig_wr,
    eidx)`` — the packed cache carry of :func:`repro_torch.core.cache.
    init_batch_carry` extended with the tierer's state (page -> tier map,
    per-page epoch counters, per-target migration totals, and the
    epoch-slot index that keeps boundaries consistent across segments).
    """
    page_map0 = page_map0.to(torch.int32)
    b, n_p = page_map0.shape
    device = page_map0.device
    l1p, l2p, stats, t = cache_mod.init_batch_carry(p, b, device=device)
    zeros = functools.partial(torch.zeros, dtype=torch.int32, device=device)
    return (l1p, l2p, stats, t,
            page_map0.clone(memory_format=torch.contiguous_format),
            zeros((b, n_p)),
            zeros((b, p.n_targets)), zeros((b, p.n_targets)), zeros((b,)))


def run_dynamic_segment(p: cache_mod.CacheParams, k_max: int,
                        count_bound: int, carry, addr, is_write, core,
                        tier, dyn_flag, n_pages, budget, threshold,
                        period, dram_cap, ssd_tid, cxl_cap,
                        page_target_lines, s_warm=None, s_meas=None,
                        s_per=None, *, donate: bool = False,
                        backend: Optional[str] = None):
    """Advance the batched epoch carry over one (B, E_seg, slot_len) slice.

    Dispatches to :func:`repro_torch.kernels.ops.mesi_dyn_segment`: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors
    (``backend`` forces one).  Both advance the identical 9-tuple carry,
    so segments may alternate between them.  Returns ``(carry, slots,
    snaps, meas)`` for just this segment.  `donate`, the JAX package's
    buffer donation, is accepted and ignored: neither backend writes its
    input carry.
    """
    from repro_torch.kernels import ops  # deferred: kernels build on core
    b = addr.shape[0]
    device = addr.device

    def col(x, fill):
        if x is None:
            return torch.full((b,), fill, dtype=torch.int32, device=device)
        return torch.as_tensor(x, device=device).to(torch.int32)

    return ops.mesi_dyn_segment(
        carry, addr, is_write, core, tier, col(dyn_flag, 0),
        col(n_pages, 0), col(budget, 0), col(threshold, 1), col(period, 1),
        col(dram_cap, UNBOUNDED_PAGES), col(ssd_tid, 0),
        col(cxl_cap, UNBOUNDED_PAGES), page_target_lines, col(s_warm, 0),
        col(s_meas, 0), col(s_per, 0), params=p, k_max=int(k_max),
        count_bound=int(count_bound), backend=backend)


def prep_dynamic_inputs(addr, is_write, core, tier, *, slot_len: int,
                        k_max: int, dyn_flag, page_map0, n_pages, budget,
                        threshold, period, dram_cap, page_target_lines,
                        ssd_tid=None, cxl_cap=None,
                        s_warm=None, s_meas=None, s_per=None):
    """Validate and reshape :func:`run_dynamic` inputs to slot-major form.

    Reshapes the (B, N) trace to (B, E, slot_len), clamps ``k_max`` to the
    page count, derives the epoch count bound of the coldness keys
    (raising on int32 overflow) and assembles the per-row scalars as int32
    tensors on the trace's device, in :func:`run_dynamic_segment`'s order.
    ``None`` sampling scalars measure every slot; ``None`` three-tier
    scalars make every row two-tier.

    Returns ``(a3, w3, c3, t3, page_map0, scalars, k_max, count_bound)``
    with ``scalars = (dyn_flag, n_pages, budget, threshold, period,
    dram_cap, ssd_tid, cxl_cap, page_target_lines, s_warm, s_meas,
    s_per)``.
    """
    addr = torch.as_tensor(addr)
    if addr.ndim != 2:
        raise ValueError("run_dynamic expects a (B, N) batch")
    device = addr.device
    b, n = addr.shape
    if n % slot_len != 0:
        raise ValueError(f"trace length {n} is not a multiple of the "
                         f"epoch slot length {slot_len}")
    page_map0 = torch.as_tensor(page_map0, device=device).to(torch.int32)
    n_p = int(page_map0.shape[1])
    # a budget beyond the page count can never be spent: clamp the top-k
    # width to P
    k_max = min(int(k_max), n_p)
    shape3 = (b, n // slot_len, slot_len)

    def r3(x):
        if x is None:
            return torch.zeros(shape3, dtype=torch.int32, device=device)
        return torch.as_tensor(x, device=device).to(torch.int32) \
            .reshape(shape3).contiguous()

    def col(x, fill=0):
        if x is None:
            return torch.full((b,), fill, dtype=torch.int32, device=device)
        return torch.as_tensor(x, device=device).to(torch.int32)

    scalars = (col(dyn_flag), col(n_pages), col(budget), col(threshold),
               col(period), col(dram_cap), col(ssd_tid),
               col(cxl_cap, UNBOUNDED_PAGES),
               torch.as_tensor(page_target_lines, device=device)
               .to(torch.int32).contiguous(),
               col(s_warm), col(s_meas), col(s_per))
    # counts reset every epoch, so the coldness-key bound only needs to
    # exceed the longest epoch (not the trace)
    count_bound = int(scalars[4].max()) * slot_len + 1
    if (count_bound + 1) * n_p + n_p >= 2 ** 31:
        raise ValueError(
            f"epoch hotness keys overflow int32: epoch_len * n_pages = "
            f"{(count_bound - 1) * n_p}; shrink the epoch or page count")
    return (r3(addr), r3(is_write), r3(core), r3(tier), page_map0, scalars,
            k_max, count_bound)


def run_dynamic(p: cache_mod.CacheParams, addr, is_write, core, tier,
                *, slot_len: int, k_max: int, dyn_flag, page_map0,
                n_pages, budget, threshold, period, dram_cap,
                page_target_lines, ssd_tid=None, cxl_cap=None,
                s_warm=None, s_meas=None, s_per=None,
                segment_slots: Optional[int] = None,
                backend: Optional[str] = None) -> DynOutputs:
    """Run a `(B, N)` batch under epoch-based dynamic tiering.

    One call of the epoch kernel spans every slot (or one per
    ``segment_slots`` slots, threading the full tierer carry between
    calls; outputs are bitwise-equal to the resident run).  For a row that
    never migrates the stats equal the static engine path's.

    Parameters
    ----------
    p : CacheParams
        Cache geometry; ``p.n_targets`` sizes the stats/migration width.
    addr, is_write, core, tier : (B, N) int tensors
        Sentinel-padded stacked traces, on the device the run uses.  For
        dynamic rows (``dyn_flag != 0``) ``tier`` carries the per-line
        CXL decode target (:meth:`repro_torch.core.route.RouteMap.
        cxl_targets_of_lines`); for static rows the final target ids.
    slot_len : int
        Epoch-slot length; ``N`` must be a multiple.  Each row's
        ``period`` counts slots per epoch.
    k_max : int
        Top-k width (>= every row's budget; clamped to P).
    dyn_flag, n_pages, budget, threshold, period, dram_cap : (B,) ints
        Per-row scalars (static rows: flag 0, budget 0, period 1).
    page_map0 : (B, P) int tensor
        Initial page -> {0 DRAM, 1 CXL[, 2 SSD]} intent.
    page_target_lines : (B, P, T) int tensor
        Lines of each page per target under the row's committed HDM
        decode (:meth:`RouteMap.page_target_lines`).
    ssd_tid, cxl_cap : (B,) ints, optional
        Three-tier scalars (``None`` = two-tier rows).
    s_warm, s_meas, s_per : (B,) ints, optional
        Sampling windows in slot units (``None`` = exact rows).
    segment_slots : int, optional
        Slots per kernel call.
    backend : str, optional
        ``None`` (follow the device), ``'reference'`` or ``'cuda'``.
    """
    a3, w3, c3, t3, page_map0, scalars, k_max, count_bound = \
        prep_dynamic_inputs(
            addr, is_write, core, tier, slot_len=slot_len, k_max=k_max,
            dyn_flag=dyn_flag, page_map0=page_map0, n_pages=n_pages,
            budget=budget, threshold=threshold, period=period,
            dram_cap=dram_cap, page_target_lines=page_target_lines,
            ssd_tid=ssd_tid, cxl_cap=cxl_cap,
            s_warm=s_warm, s_meas=s_meas, s_per=s_per)
    e = a3.shape[1]
    if segment_slots is None:
        segment_slots = max(e, 1)   # one kernel call spans every slot
    if segment_slots < 1:
        raise ValueError(f"segment_slots must be >= 1, got {segment_slots}")
    carry = init_dyn_carry(p, page_map0)
    slots_parts, snaps_parts, meas_parts = [], [], []
    for s in range(0, e, segment_slots):
        sl = slice(s, min(s + segment_slots, e))
        carry, slots, snaps, meas = run_dynamic_segment(
            p, k_max, count_bound, carry, a3[:, sl], w3[:, sl], c3[:, sl],
            t3[:, sl], *scalars, backend=backend)
        slots_parts.append(slots)
        snaps_parts.append(snaps)
        meas_parts.append(meas)
    _, _, stats, _, pmap_f, _, mig_rd, mig_wr, _ = carry
    return DynOutputs(stats, pmap_f, mig_rd, mig_wr,
                      torch.cat(slots_parts, dim=1),
                      torch.cat(snaps_parts, dim=1),
                      torch.cat(meas_parts, dim=1))


# ---------------------------------------------------------------------------
# Host twin (the parity oracle)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class HostResult:
    """NumPy replay of one row's epoch loop (:func:`host_simulate`).

    ``target`` is the per-access target sequence the evolving page map
    produced: fed to the static engine path it gives the stats of the
    dynamic run.
    """
    target: np.ndarray     # (N,) int32 per-access target id
    page_map: np.ndarray   # (P,) int32 final page map
    mig_read: np.ndarray   # (T,) int64 migration lines read per target
    mig_write: np.ndarray  # (T,) int64 migration lines written per target
    slots: np.ndarray      # (E, 4) int64, columns as SLOT_FIELDS

    @property
    def migrated_pages(self) -> int:
        return int(self.slots[:, 2].sum() + self.slots[:, 3].sum())


def host_simulate(tiering: Optional[DynamicTiering], addr, cxl_target,
                  page_map0, n_pages: int, page_target_lines,
                  slot_len: int, *, valid=None,
                  dram_capacity_pages: Optional[int] = None,
                  ssd_tid: int = 0,
                  cxl_capacity_pages: Optional[int] = None) -> HostResult:
    """Replay the epoch loop of one row in NumPy, decision for decision.

    The migration decisions depend only on the trace and the map
    evolution, never on cache state, so this twin derives the per-access
    target sequence without simulating the cache (same injective keys,
    same capacity arithmetic).  ``tiering=None`` is a static row;
    ``dram_capacity_pages`` / ``cxl_capacity_pages`` override the
    tiering's; ``ssd_tid`` is the route's SSD target (0 = none).
    """
    addr = np.asarray(addr, np.int64)
    n = addr.shape[0]
    if n % slot_len != 0:
        raise ValueError(f"trace length {n} not a multiple of {slot_len}")
    cxl_target = np.asarray(cxl_target, np.int64)
    pmap = np.asarray(page_map0, np.int64).copy()
    ptl = np.asarray(page_target_lines, np.int64)
    n_p, n_t = ptl.shape
    valid = (addr != SENTINEL) if valid is None else np.asarray(valid, bool)
    if tiering is None:
        budget, threshold, period = 0, 1, 1
    else:
        if tiering.epoch_len % slot_len != 0:
            raise ValueError(f"epoch_len {tiering.epoch_len} not a "
                             f"multiple of slot_len {slot_len}")
        budget, threshold = tiering.budget, tiering.threshold
        period = tiering.epoch_len // slot_len
    cap = dram_capacity_pages
    if cap is None:
        cap = (tiering.dram_capacity_pages if tiering is not None else None)
    cap = UNBOUNDED_PAGES if cap is None else int(cap)
    l1cap = cxl_capacity_pages
    if l1cap is None:
        l1cap = (tiering.cxl_capacity_pages if tiering is not None else None)
    l1cap = UNBOUNDED_PAGES if l1cap is None else int(l1cap)
    ssd_tid = int(ssd_tid)

    e = n // slot_len
    cmax = period * slot_len + 1
    page_ids = np.arange(n_p, dtype=np.int64)
    pvalid = page_ids < n_pages
    target = np.zeros(n, np.int32)
    counts = np.zeros(n_p, np.int64)
    mig_rd = np.zeros(n_t, np.int64)
    mig_wr = np.zeros(n_t, np.int64)
    slots = np.zeros((e, 4), np.int64)

    def ranked(mask, count):
        key = np.where(mask, encode_hot_key(count, page_ids, n_p), -1)
        return np.argsort(-key, kind="stable")

    for ei in range(e):
        sl = slice(ei * slot_len, (ei + 1) * slot_len)
        page = np.clip(addr[sl] // LINES_PER_PAGE, 0, n_p - 1)
        intent = pmap[page]
        target[sl] = np.where(intent == 0, 0,
                              np.where(intent >= 2, ssd_tid, cxl_target[sl]))
        v = valid[sl]
        slots[ei, 0] = v.sum()
        slots[ei, 1] = (v & (intent == 0)).sum()
        np.add.at(counts, page, v.astype(np.int64))
        if (ei + 1) % period == 0:
            if budget > 0:
                hot = (pmap == 1) & pvalid & (counts >= threshold)
                n_want = min(budget, int(hot.sum()))
                is_dram = (pmap == 0) & pvalid
                free = max(cap - int(is_dram.sum()), 0)
                n_dem = min(min(max(n_want - free, 0), budget),
                            int(is_dram.sum()))
                demote = ranked(is_dram, cmax - counts)[:n_dem]
                n_pro = min(int(hot.sum()), budget, free + n_dem)
                promote = ranked(hot, counts)[:n_pro]
                pmap[promote] = 0
                pmap[demote] = 1
                mig_rd += ptl[promote].sum(axis=0)
                mig_rd[0] += n_dem * LINES_PER_PAGE
                mig_wr += ptl[demote].sum(axis=0)
                mig_wr[0] += n_pro * LINES_PER_PAGE
                slots[ei, 2] = n_pro
                slots[ei, 3] = n_dem
                if ssd_tid > 0:
                    # SSD stage: hot level-2 pages promote to CXL, then
                    # level-1 overflow spills back
                    hot2 = (pmap == 2) & pvalid & (counts >= threshold)
                    n_sup = min(budget, int(hot2.sum()))
                    sup = ranked(hot2, counts)[:n_sup]
                    pmap[sup] = 1
                    is_l1 = (pmap == 1) & pvalid
                    over = min(max(int(is_l1.sum()) - l1cap, 0), budget)
                    n_over = min(over, int(is_l1.sum()))
                    down = ranked(is_l1, cmax - counts)[:n_over]
                    pmap[down] = 2
                    mig_rd += ptl[down].sum(axis=0)
                    mig_rd[ssd_tid] += n_sup * LINES_PER_PAGE
                    mig_wr += ptl[sup].sum(axis=0)
                    mig_wr[ssd_tid] += n_over * LINES_PER_PAGE
                    slots[ei, 2] += n_sup
                    slots[ei, 3] += n_over
            counts[:] = 0
    return HostResult(target=target, page_map=pmap.astype(np.int32),
                      mig_read=mig_rd, mig_write=mig_wr, slots=slots)


# ---------------------------------------------------------------------------
# Reporting helpers
# ---------------------------------------------------------------------------
def epoch_fractions(slots: np.ndarray, period: int) -> List[float]:
    """Per-epoch DRAM hit-tier fractions from (E, 4) per-slot counters.

    Groups of ``period`` slots form one epoch (a trailing partial group a
    partial epoch); each reports ``acc_dram / acc_total``.  Trailing
    all-sentinel epochs (batch padding) are dropped; an empty epoch
    between real ones reports 0.0.
    """
    slots = np.asarray(slots, np.int64)
    out: List[float] = []
    last_real = -1
    for s in range(0, slots.shape[0], period):
        grp = slots[s:s + period]
        tot = int(grp[:, 0].sum())
        if tot:
            last_real = len(out)
        out.append(float(grp[:, 1].sum()) / tot if tot else 0.0)
    return out[:last_real + 1]
