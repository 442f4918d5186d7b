"""Offload paths over the CXL tiers: optimizer state and cold KV pages.

Two consumers share this module:

* :func:`schedule` turns a :class:`repro_torch.memory.tiering.MemoryPlan` into a
  per-step timeline: spilled moment shards stream back layer-by-layer
  during the backward pass (prefetch k layers ahead), are updated, and
  stream out during the next forward — so transfer overlaps compute and
  only the non-overlapped residue lengthens the step.  The timeline
  arithmetic is exactly a two-resource (compute pipe / CXL link) interval
  schedule; this is where the paper's bandwidth calibration (§V) becomes a
  training-throughput statement.
* :func:`kv_offload_tiers` deepens the paged KV cache's two-level
  residency (:meth:`repro_torch.memory.kvcache.PagedKVCache.tier_snapshot`)
  into the simulator's three-level map: CXL-resident pages beyond a
  budget — coldest first by last use — are demoted to the CXL-SSD tier
  (level 2), which :meth:`repro_torch.core.route.RouteMap.targets_of_tiered_lines`
  routes to the flash expander.  See ``docs/fidelity.md``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.timing import TimingConfig
from repro_torch.memory.tiering import MemoryPlan


@dataclasses.dataclass(frozen=True)
class OffloadEvent:
    layer: int
    direction: str          # 'in' (moments to HBM) | 'out' (back to tier)
    bytes: int
    start_s: float
    end_s: float


@dataclasses.dataclass
class OffloadSchedule:
    events: List[OffloadEvent]
    step_compute_s: float
    transfer_s: float
    step_total_s: float
    overlap_efficiency: float   # 1.0 == fully hidden

    def summary(self) -> Dict[str, float]:
        return {"compute_s": self.step_compute_s,
                "transfer_s": self.transfer_s,
                "step_s": self.step_total_s,
                "overlap_efficiency": self.overlap_efficiency}


def schedule(plan: MemoryPlan, *, n_layers: int, step_compute_s: float,
             timing: Optional[TimingConfig] = None,
             prefetch_depth: int = 2) -> OffloadSchedule:
    """Lay spilled-moment transfers over the layer timeline."""
    timing = timing or TimingConfig()
    spilled = [p for p in plan.placements if p.tier in ("host", "cxl")]
    total_bytes = sum(p.bytes for p in spilled)
    if total_bytes == 0:
        return OffloadSchedule([], step_compute_s, 0.0, step_compute_s, 1.0)
    bw = min(timing.cxl.payload_gbps(0.5),
             timing.dram.peak_gbps) * 1e9          # conservative series link
    per_layer = total_bytes / n_layers
    t_layer = step_compute_s / n_layers
    t_xfer = per_layer / bw
    events: List[OffloadEvent] = []
    link_free = 0.0
    finish = 0.0
    for i in range(n_layers):
        # moments for layer i must arrive before its optimizer slot, which
        # runs after backward of layer i: time (n_layers - i) * t_layer-ish;
        # we model the classic pipelined bound instead of exact offsets.
        start = max(link_free, max(0.0, (i - prefetch_depth)) * t_layer)
        end = start + 2 * t_xfer                    # in + out
        events.append(OffloadEvent(i, "in", int(per_layer), start,
                                   start + t_xfer))
        events.append(OffloadEvent(i, "out", int(per_layer), start + t_xfer,
                                   end))
        link_free = end
        finish = max(finish, end)
    transfer_s = 2 * total_bytes / bw
    step_total = max(step_compute_s, finish)
    overlap_eff = (min(transfer_s, step_compute_s) /
                   transfer_s) if transfer_s > 0 else 1.0
    return OffloadSchedule(events, step_compute_s, transfer_s, step_total,
                           round(min(1.0, overlap_eff), 4))


def kv_offload_tiers(tier_snapshot: np.ndarray, last_use: np.ndarray, *,
                     cxl_page_budget: int) -> np.ndarray:
    """Three-level page map from the KV cache's two-level residency.

    Pages the cache reports HBM-resident stay at level 0; CXL-resident
    pages stay at level 1 up to ``cxl_page_budget``, and the *coldest*
    CXL pages beyond the budget (smallest ``last_use``, page index as a
    deterministic tiebreak) are demoted to level 2 (CXL-SSD).  A
    non-positive budget sends every CXL page to the SSD tier.

    Parameters
    ----------
    tier_snapshot : (n_pages,) int array
        Per-page residency from
        :meth:`repro_torch.memory.kvcache.PagedKVCache.tier_snapshot`
        (0 = HBM, 1 = CXL).
    last_use : (n_pages,) int array
        The cache's LRU clock (:attr:`PagedKVCache.last_use`); larger =
        hotter.
    cxl_page_budget : int
        CXL-DRAM pages retained at level 1.

    Returns
    -------
    (n_pages,) int32 array
        Per-page tier intent in {0, 1, 2}, ready for a workload tier
        stream or :class:`repro_torch.core.numa.ExplicitPageMap`-style seeding.
    """
    tiers = np.asarray(tier_snapshot, np.int32).copy()
    last = np.asarray(last_use, np.int64)
    if tiers.shape != last.shape:
        raise ValueError(f"tier snapshot covers {tiers.shape[0]} pages, "
                         f"last_use covers {last.shape[0]}")
    cxl_pages = np.flatnonzero(tiers == 1)
    n_over = cxl_pages.shape[0] - max(int(cxl_page_budget), 0)
    if n_over > 0:
        # coldest first: ascending last_use, then page index (stable)
        order = cxl_pages[np.argsort(last[cxl_pages], kind="stable")]
        tiers[order[:n_over]] = 2
    return tiers
