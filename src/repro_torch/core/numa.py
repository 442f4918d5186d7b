"""Page-placement policies: zNUMA, Flat-mode first-touch, weighted interleave.

These are the "prominent programming models" the paper validates (§IV):

  * **zNUMA** — CXL region onlined as a CPU-less NUMA node; allocations are
    explicitly bound (`numactl --membind`) to DRAM or the zNUMA node.
  * **Flat mode** — CXL capacity merged into the same node as system DRAM;
    the OS sees one contiguous pool and fills DRAM first (first-touch), then
    spills to CXL.
  * **Weighted interleave** — pages dealt DRAM:CXL in a configured ratio
    (SMDK / HMSDK / `numactl --weighted-interleave` style), the knob the
    paper sweeps ("we vary the OS managed page interleaving ratios").

Each policy maps *page index -> tier* (0=DRAM, 1=CXL) as an int32 tensor
on the requested device; :func:`tier_of_lines` turns that into per-access
tiers for the cache simulator.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from repro_torch.core.hdm import weighted_page_policy
from repro_torch.core.spec import CACHELINE_BYTES

PAGE_BYTES = 4096
LINES_PER_PAGE = PAGE_BYTES // CACHELINE_BYTES


@dataclasses.dataclass(frozen=True)
class ZNuma:
    """Explicit binding: `cxl_fraction` of the footprint's pages bound to the
    zNUMA (CXL) node, the rest to DRAM — contiguous split, as membind gives.
    """
    cxl_fraction: float = 1.0

    def tiers(self, n_pages: int, device=None) -> torch.Tensor:
        n_dram = int(round(n_pages * (1.0 - self.cxl_fraction)))
        page = torch.arange(n_pages, dtype=torch.int32, device=device)
        return (page >= n_dram).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class FlatMode:
    """First-touch over one big node: DRAM fills first, then CXL spills.

    `dram_pages` is the DRAM capacity available to this footprint (the OS
    would have other tenants; callers set it from the SystemMap).
    """
    dram_pages: int

    def tiers(self, n_pages: int, device=None) -> torch.Tensor:
        page = torch.arange(n_pages, dtype=torch.int32, device=device)
        return (page >= self.dram_pages).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class WeightedInterleave:
    """DRAM:CXL = dram_weight:cxl_weight page-round-robin."""
    dram_weight: int = 1
    cxl_weight: int = 1

    def tiers(self, n_pages: int, device=None) -> torch.Tensor:
        page = torch.arange(n_pages, dtype=torch.int32, device=device)
        return weighted_page_policy(page, self.dram_weight, self.cxl_weight)


@dataclasses.dataclass(frozen=True)
class ExplicitPageMap:
    """A literal page->tier table: placement decided by a runtime, not a
    policy formula.

    `page_tiers[p]` is 0 (DRAM) or 1 (CXL) for page `p`.  Stored as a
    tuple so the policy stays hashable (policies ride frozen sweep specs).
    """
    page_tiers: Tuple[int, ...]

    def tiers(self, n_pages: int, device=None) -> torch.Tensor:
        if n_pages != len(self.page_tiers):
            raise ValueError(f"page map covers {len(self.page_tiers)} "
                             f"pages, footprint has {n_pages}")
        return torch.tensor(self.page_tiers, dtype=torch.int32,
                            device=device)


Policy = Union[ZNuma, FlatMode, WeightedInterleave, ExplicitPageMap]


def tier_of_lines(policy: Policy, line_addr: torch.Tensor,
                  n_pages: int) -> torch.Tensor:
    """Per-access tier for a line-granular address trace (on its device)."""
    page_tiers = policy.tiers(n_pages, device=line_addr.device)
    page = line_addr.to(torch.int32) // LINES_PER_PAGE
    return page_tiers[page.clamp(0, n_pages - 1).long()]


def first_touch_page_map(tier: torch.Tensor, line_addr: torch.Tensor,
                         n_pages: int) -> torch.Tensor:
    """Page -> tier map from a trace's *first* access to each page.

    How workloads that carry their own per-access residency map seed the
    dynamic tierer (:mod:`repro_torch.core.tiering_dyn`): each page's
    initial tier is the tier of its first access; pages the trace never
    touches default to CXL (1).  `tier` values above 2 clamp to 2
    (CXL-SSD); sentinel entries (< 0) are ignored.  Returns (n_pages,)
    int32 on the trace's device.
    """
    line = line_addr.to(torch.int32)
    tier = tier.to(torch.int32).clamp(0, 2)
    n = line.shape[0]
    page = (line // LINES_PER_PAGE).clamp(0, n_pages - 1).long()
    order = torch.arange(n, dtype=torch.int32, device=line.device)
    slot = torch.where(line >= 0, order, n)
    first = torch.full((n_pages,), n, dtype=torch.int32, device=line.device)
    first = first.scatter_reduce(0, page, slot, reduce="amin")
    return torch.where(first < n, tier[first.clamp(0, n - 1).long()],
                       1).to(torch.int32)


def describe(policy: Policy) -> str:
    """Short human-readable policy label (sweep row `policy` column)."""
    if isinstance(policy, ZNuma):
        return f"znuma(cxl={policy.cxl_fraction:.0%})"
    if isinstance(policy, FlatMode):
        return f"flat(dram_pages={policy.dram_pages})"
    if isinstance(policy, ExplicitPageMap):
        n = len(policy.page_tiers)
        return f"pagemap({sum(policy.page_tiers)}/{n} cxl)"
    return f"interleave({policy.dram_weight}:{policy.cxl_weight})"
