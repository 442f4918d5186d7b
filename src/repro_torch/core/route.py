"""Per-access target routing: placement policy + committed HDM decode.

The paper models CXL devices "at their correct position on the I/O bus",
with true interleaving with system DRAM, so the hot path cannot collapse
memory into a binary DRAM/CXL tier.  This module closes the gap between
:mod:`repro_torch.core.topology` (whose enumeration pass commits
:class:`~repro_torch.core.hdm.InterleaveProgram`s into a
:class:`~repro_torch.core.topology.SystemMap`) and the batched engine:

  1. the OS page-placement policy (:mod:`repro_torch.core.numa`) decides,
     per page, whether an access lands in local DRAM or in the CXL window;
  2. CXL-destined lines are pushed through the region's committed HDM
     interleave program (line -> way -> endpoint, the CXL 2.0 §8.2.5.12
     decode), yielding a global **target id**: 0 = local DRAM, 1..K = the
     K expander endpoints;
  3. each target carries its *effective* timing: the direct-attach
     :class:`~repro_torch.core.timing.CXLTiming`, or the switch-derived one
     (:func:`repro_torch.core.switch.fanout_timing`) for endpoints below a
     shared upstream switch port.  Targets below one switch share a
     **group**, which :func:`repro_torch.core.machine.time_batch` couples.

With one direct-attach expander the routed targets equal the binary
``numa.tier_of_lines`` tiers, and the per-target stats layout is the
historical 12-slot one.  Routing runs with torch ops on the device of the
trace.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch

from repro_torch.core import numa as numa_mod
from repro_torch.core import topology as topo
from repro_torch.core.hdm import InterleaveProgram
from repro_torch.core.switch import (SwitchConfig, fanout_timing,
                                     usp_payload_gbps)
from repro_torch.core.timing import (CXLTiming, DramTiming, SSDTiming,
                                     TimingConfig)


# ---------------------------------------------------------------------------
# Topology shorthands (the sweepable axis)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """A sweepable expander topology: K cards, optionally behind one switch.

    All expanders attach below one host bridge, so enumeration commits one
    K-way interleaved region.  `switch` places every endpoint behind one
    CXL 2.0 switch: +2 hop latency and a shared-USP bandwidth group.
    ``ssd_gib > 0`` adds one CXL-SSD (flash media) on its own host bridge,
    never interleaved with the DRAM expanders: the third tier the dynamic
    tierer can demote cold pages into.
    """
    name: str
    expander_gib: Tuple[int, ...] = (16,)
    switch: Optional[SwitchConfig] = None
    dram_gib: int = 16
    ssd_gib: int = 0

    @property
    def n_expanders(self) -> int:
        return len(self.expander_gib)


def direct(n: int = 1, gib: int = 16, ssd_gib: int = 0) -> TopologySpec:
    """`n` direct-attach expanders, n-way interleaved under one bridge
    (named ``direct{n}``, ``direct{n}+ssd`` with a CXL-SSD tier)."""
    suffix = "+ssd" if ssd_gib else ""
    return TopologySpec(name=f"direct{n}{suffix}",
                        expander_gib=(gib,) * n, ssd_gib=ssd_gib)


def switched(n: int = 4, gib: int = 16,
             switch: Optional[SwitchConfig] = None) -> TopologySpec:
    """`n` expanders pooled behind one CXL switch (named ``switch{n}``;
    the switch defaults to `n` downstream ports)."""
    sw = switch or SwitchConfig(n_downstream=n)
    return TopologySpec(name=f"switch{n}", expander_gib=(gib,) * n,
                        switch=sw)


# ---------------------------------------------------------------------------
# Routed targets
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Target:
    """One memory target: local DRAM or a CXL expander endpoint.

    `timing` is the effective path timing (switch-derived for grouped
    targets).  `group >= 0` marks targets sharing an upstream switch port;
    `group_payload_gbps` is that USP's payload bandwidth and
    `device_payload_gbps` the endpoint's own ceiling through an idle
    switch.
    """
    tid: int
    name: str
    kind: str                                  # 'dram' | 'cxl' | 'ssd'
    timing: Union[DramTiming, CXLTiming, SSDTiming]
    group: int = -1
    group_payload_gbps: float = 0.0
    device_payload_gbps: float = 0.0


@dataclasses.dataclass(frozen=True)
class RouteMap:
    """Targets + the committed interleave programs that select among them.

    `programs[i].targets` hold *global* target ids, so decode output
    indexes `targets` directly.  ``ssd_tid`` is the global id of the (at
    most one) CXL-SSD target, or 0 when there is none (target 0 is always
    local DRAM).  The SSD's program is left out of ``programs``: only a
    tier intent >= 2 routes there.
    """
    name: str
    targets: Tuple[Target, ...]
    programs: Tuple[InterleaveProgram, ...]
    ssd_tid: int = 0

    @property
    def n_targets(self) -> int:
        return len(self.targets)

    @property
    def cxl_targets(self) -> Tuple[Target, ...]:
        return tuple(t for t in self.targets if t.kind == "cxl")

    def target_of_lines(self, policy: numa_mod.Policy,
                        line_addr: torch.Tensor, n_pages: int
                        ) -> torch.Tensor:
        """Per-access target id for a line-granular trace: the policy maps
        pages to {DRAM, CXL}, then CXL lines decode through the committed
        HDM program(s).  Returns (N,) int32 on the trace's device."""
        tier = numa_mod.tier_of_lines(policy, line_addr, n_pages)
        return self.targets_of_tiered_lines(tier, line_addr)

    def targets_of_tiered_lines(self, tier: torch.Tensor,
                                line_addr: torch.Tensor) -> torch.Tensor:
        """Route lines whose DRAM/CXL intent is already decided.

        `tier` is 0 for local DRAM and nonzero for the CXL window, except
        on a route with an SSD tier, where >= 2 routes to the SSD target.
        With several regions, pages round-robin across regions and the
        HDM program interleaves lines within each.
        """
        tier = tier.to(torch.int32)
        if not self.programs:              # no CXL-DRAM capacity
            if self.ssd_tid:
                return torch.where(tier >= 2, self.ssd_tid, 0) \
                    .to(torch.int32)
            return torch.zeros_like(tier)
        cxl_t = self.cxl_targets_of_lines(line_addr)
        routed = torch.where(tier == 0, 0, cxl_t)
        if self.ssd_tid:
            routed = torch.where(tier >= 2, self.ssd_tid, routed)
        return routed.to(torch.int32)

    def cxl_targets_of_lines(self, line_addr: torch.Tensor) -> torch.Tensor:
        """The endpoint each line hits *if* it is CXL-resident.

        Every line is pushed through the committed HDM program(s)
        whatever its tier; the dynamic tierer precomputes this once per
        trace and its page map then only chooses DRAM *vs* this target.
        Returns (N,) int32 ids in ``[1, n_targets)`` (zeros when the
        route has no CXL capacity).
        """
        line = line_addr.to(torch.int32)
        if not self.programs:
            return torch.zeros_like(line)

        def decode(prog):
            way, _ = prog.decode_lines(line)
            return torch.tensor(prog.targets, dtype=torch.int32,
                                device=line.device)[way.long()]

        if len(self.programs) == 1:
            return decode(self.programs[0])
        region = (line // numa_mod.LINES_PER_PAGE) % len(self.programs)
        cxl_t = torch.zeros_like(line)
        for i, prog in enumerate(self.programs):
            cxl_t = torch.where(region == i, decode(prog), cxl_t)
        return cxl_t

    def targets_of_dynamic_lines(self, page_tiers: torch.Tensor,
                                 line_addr: torch.Tensor) -> torch.Tensor:
        """Route lines through a page -> tier map (a snapshot of the
        dynamic tierer's map): ``page_tiers[p] == 0`` keeps page ``p`` in
        DRAM, anything else routes through the committed HDM decode."""
        line = line_addr.to(torch.int32)
        page = (line // numa_mod.LINES_PER_PAGE).clamp(
            0, page_tiers.shape[0] - 1)
        return self.targets_of_tiered_lines(
            page_tiers.to(torch.int32)[page.long()], line)

    def page_target_lines(self, n_pages: int, width: Optional[int] = None,
                          device=None) -> torch.Tensor:
        """Per-page per-target line counts under the committed decode.

        ``out[p, k]`` is how many of page ``p``'s ``LINES_PER_PAGE``
        cachelines the HDM interleave maps to target ``k`` when the page
        is CXL-resident: the table the dynamic tierer charges migration
        traffic by.  `width` (>= ``n_targets``) pads to a batch's widest
        route.  Returns (n_pages, width) int32; column 0 is zero.
        """
        t = width or self.n_targets
        lines = torch.arange(n_pages * numa_mod.LINES_PER_PAGE,
                             dtype=torch.int32, device=device)
        tgt = self.cxl_targets_of_lines(lines).long()
        page = (lines // numa_mod.LINES_PER_PAGE).long()
        out = torch.zeros((n_pages, t), dtype=torch.int32, device=device)
        # integer scatter-add: the same table whatever the order of adds
        return out.index_put_((page, tgt), torch.ones_like(lines),
                              accumulate=True)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------
def build_route_from_system(sysmap: topo.SystemMap, timing: TimingConfig,
                            switch: Optional[SwitchConfig] = None,
                            name: str = "system") -> RouteMap:
    """Route map over an enumerated system's committed decode chains.

    Target 0 is local DRAM (`timing.dram`); every endpoint of every region
    becomes a CXL target in enumeration order, and a flash-only region the
    SSD target.  `switch` places every DRAM endpoint behind one switch:
    switch-derived timing and one USP bandwidth group.
    """
    targets: List[Target] = [Target(0, "dram", "dram", timing.dram)]
    programs: List[InterleaveProgram] = []
    ssd_tid = 0
    if switch is not None:
        eff = fanout_timing(timing.cxl, switch)
        usp = usp_payload_gbps(switch)
    for region in sysmap.regions:
        medias = {dev.media for dev in region.devices}
        if medias == {"flash"}:
            # the CXL-SSD tier: its own region, never HDM-interleaved with
            # the DRAM expanders and never a policy decode target
            if len(region.devices) != 1 or ssd_tid:
                raise ValueError("at most one CXL-SSD target per route")
            if switch is not None:
                raise ValueError("a CXL-SSD cannot share the switch "
                                 "group with DRAM expanders")
            ssd_tid = len(targets)
            targets.append(Target(ssd_tid, region.devices[0].name, "ssd",
                                  timing.ssd))
            continue
        if "flash" in medias:
            raise ValueError("flash and dram media cannot interleave in "
                             "one region; give the SSD its own bridge")
        tids = []
        for dev in region.devices:
            tid = len(targets)
            if switch is None:
                targets.append(Target(tid, dev.name, "cxl", timing.cxl))
            else:
                targets.append(Target(
                    tid, dev.name, "cxl", eff, group=0,
                    group_payload_gbps=usp,
                    device_payload_gbps=min(timing.cxl.payload_read_gbps,
                                            usp)))
            tids.append(tid)
        programs.append(dataclasses.replace(region.program,
                                            targets=tuple(tids)))
    return RouteMap(name=name, targets=tuple(targets),
                    programs=tuple(programs), ssd_tid=ssd_tid)


def build_route(spec: TopologySpec, timing: TimingConfig) -> RouteMap:
    """Build and enumerate `spec`'s system (the driver-equivalent pass of
    :func:`repro_torch.core.topology.enumerate_system`: bind checks, HDM
    decoder programming and commit), then derive its route map."""
    sys_ = topo.System(dram_size=spec.dram_gib * topo.GiB)
    for i, gib in enumerate(spec.expander_gib):
        sys_.add_expander(f"{spec.name}.mem{i}", gib * topo.GiB,
                          bridge_uid=0)
    if spec.ssd_gib:
        # the SSD gets its own host bridge => its own CFMWS window and
        # region, enumerated after the DRAM expanders
        sys_.add_expander(f"{spec.name}.ssd", spec.ssd_gib * topo.GiB,
                          bridge_uid=1, media="flash")
    sysmap = topo.enumerate_system(sys_)
    return build_route_from_system(sysmap, timing, switch=spec.switch,
                                   name=spec.name)
