"""CXLRAMSim facade: build -> enumerate -> online -> characterize.

One object wires the whole paper together: topology + firmware + enumeration
(:mod:`.topology`), routing (:mod:`.route`), per-tier timing
(:mod:`.timing`), the cache/tier machine (:mod:`.machine`), placement
policies (:mod:`.numa`), dynamic tiering (:mod:`.tiering_dyn`), sampled
simulation (:mod:`.sampling`) and the workloads of
:mod:`repro_torch.workloads`, with the cache simulation on a torch device —
the CUDA card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core import cache as cache_sim
from repro_torch.core import engine as engine_mod
from repro_torch.core import numa as numa_mod
from repro_torch.core import route as route_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core import topology as topo
from repro_torch.core.machine import CPUModel, Machine, RunResult
from repro_torch.core.timing import TimingConfig
from repro_torch.runtime.trace import span


@dataclasses.dataclass
class SimConfig:
    dram_gib: int = 16
    expander_gib: Sequence[int] = (16,)
    n_cores: int = 4
    cache: cache_sim.CacheParams = dataclasses.field(
        default_factory=cache_sim.CacheParams)
    timing: TimingConfig = dataclasses.field(default_factory=TimingConfig)
    cpu: CPUModel = dataclasses.field(default_factory=CPUModel)


class CXLRAMSim:
    """Full-system CXL memory-expander simulator (PyTorch).

    `device` is where traces are built and the cache hierarchy is
    simulated: ``None`` means the CUDA card, and construction raises when
    there is none; pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, config: SimConfig | None = None, device=None):
        self.device = engine_mod.resolve_device(device)
        self.config = config or SimConfig()
        self.system, self.map, self.cli = topo.build_default_system(
            dram_gib=self.config.dram_gib,
            expander_gib=tuple(self.config.expander_gib),
            n_cores=self.config.n_cores)
        self.machine = Machine(self.config.cache, self.config.timing,
                               self.config.cpu)
        self._onlined = False

    # ---- lifecycle (CXL-CLI flow) ----------------------------------------
    def online(self, mode: str = "znuma") -> List[Dict]:
        """Online every region (the `cxl create-region` + ndctl flow)."""
        for r in list(self.map.regions):
            self.cli.online_memory(r.name, mode=mode)
        self._onlined = True
        return self.cli.list_regions()

    def memdevs(self) -> List[Dict]:
        return self.cli.list_memdevs()

    def numastat(self) -> Dict[int, Dict]:
        return self.cli.numastat()

    # ---- routing ----------------------------------------------------------
    def route(self, switch=None) -> route_mod.RouteMap:
        """N-target route map over this system's committed HDM decoders.

        Target 0 = local DRAM, 1..K = this system's expander endpoints;
        pass a `SwitchConfig` to model all endpoints behind one switch.
        """
        return route_mod.build_route_from_system(
            self.map, self.config.timing, switch=switch)

    # ---- characterization -------------------------------------------------
    def _check_policy(self, policy: numa_mod.Policy) -> None:
        if not self._onlined and not isinstance(policy, numa_mod.ZNuma):
            raise RuntimeError("online() the CXL region first")

    def run_stream(self, kernel: str, footprint_bytes: int,
                   policy: numa_mod.Policy,
                   cpu: Optional[CPUModel] = None) -> RunResult:
        """One STREAM kernel pass through the cache/tier machine."""
        self._check_policy(policy)
        layout = stream_mod.layout_for_footprint(footprint_bytes)
        addr, is_write = stream_mod.stream_trace(kernel, layout, self.device)
        machine = self.machine if cpu is None else Machine(
            self.config.cache, self.config.timing, cpu)
        return machine.run_trace(addr, is_write, policy, layout.n_pages)

    def stream_suite(self, footprint_factors: Sequence[int] = (2, 4, 6, 8),
                     policy: Optional[numa_mod.Policy] = None,
                     kernel: str = "triad",
                     cpu: Optional[CPUModel] = None,
                     backend: Optional[str] = None,
                     topologies=None) -> List[Dict]:
        """The paper's §IV sweep: STREAM at k x L2 footprints.

        All footprints run as ONE batched device call through
        :mod:`repro_torch.core.engine`.
        """
        policy = policy or numa_mod.ZNuma(cxl_fraction=1.0)
        return self.sweep(footprint_factors, policies=(policy,),
                          cpus=(cpu or self.config.cpu,), kernel=kernel,
                          backend=backend, topologies=topologies)

    def sweep(self, footprint_factors: Sequence[int] = (2, 4, 6, 8),
              policies: Optional[Sequence[numa_mod.Policy]] = None,
              cpus: Optional[Sequence[CPUModel]] = None,
              kernel: str = "triad",
              backend: Optional[str] = None,
              topologies=None,
              workloads: Optional[Sequence] = None,
              tiering: Optional[Sequence] = None,
              sampling: Optional[Sequence] = None,
              distributions: Optional[Sequence] = None,
              mesh=None,
              stream_chunk: Optional[int] = None,
              resume=None,
              fault_plan=None,
              report=None) -> List[Dict]:
        """The full grid — (sampling x tiering x topology x workload x
        footprint x policy x CPU) — batched.

        Every simulated cell runs in one device call; CPU models and
        `distributions` entries vary only the timing fixed point.
        `topologies` (:func:`repro_torch.core.route.direct` /
        :func:`~repro_torch.core.route.switched` specs) route accesses to
        N targets; `workloads` takes :mod:`repro_torch.workloads`
        generators; `tiering` takes
        :class:`~repro_torch.core.tiering_dyn.DynamicTiering` entries and
        `sampling` :class:`~repro_torch.core.sampling.SamplingSpec` entries
        (``None`` = static / exact, the rows of the static path), which
        run the epoch-structured kernel.  `backend` is ``None`` (follow
        the device), ``'reference'`` or ``'cuda'``.

        `mesh` shards the grid's batch rows (a
        :class:`repro_torch.core.distribute.Mesh` or an int shard count)
        and `stream_chunk` streams each trace through the carry in
        fixed-size segments (bounded device memory) — execution
        strategies, never result changes: any mesh/chunk choice gives the
        rows of the defaults (``None``/``None`` = the one-call path).

        `resume` (a checkpoint directory or
        :class:`repro_torch.core.resilience.CheckpointPolicy`),
        `fault_plan` (a :class:`repro_torch.core.resilience.FaultPlan`) and
        `report` (a :class:`repro_torch.core.resilience.RunReport` event
        sink) run the sweep through the fault-tolerant
        :class:`repro_torch.core.distribute.ResilientExecutor`: carries
        checkpoint every N segments, and a killed sweep rerun with the
        same `resume=` fast-forwards to where it died — with rows
        bitwise-identical to an uninterrupted run.
        """
        with span("sweep"):
            spec = self.sweep_spec(footprint_factors, policies, cpus, kernel,
                                   backend, topologies, workloads, tiering,
                                   sampling, distributions)
            if (mesh is None and stream_chunk is None and resume is None
                    and fault_plan is None and report is None):
                return engine_mod.run_sweep(spec, self.config.cache,
                                            self.config.timing,
                                            device=self.device)
            # deferred: distribute builds on engine
            from repro_torch.core import distribute
            return distribute.run_sweep(spec, self.config.cache,
                                        self.config.timing, mesh=mesh,
                                        stream_chunk=stream_chunk,
                                        resume=resume, fault_plan=fault_plan,
                                        report=report, device=self.device)

    def sweep_spec(self, footprint_factors: Sequence[int] = (2, 4, 6, 8),
                   policies: Optional[Sequence[numa_mod.Policy]] = None,
                   cpus: Optional[Sequence[CPUModel]] = None,
                   kernel: str = "triad",
                   backend: Optional[str] = None,
                   topologies=None,
                   workloads: Optional[Sequence] = None,
                   tiering: Optional[Sequence] = None,
                   sampling: Optional[Sequence] = None,
                   distributions: Optional[Sequence] = None
                   ) -> engine_mod.SweepSpec:
        """The :class:`~repro_torch.core.engine.SweepSpec` that
        :meth:`sweep` runs for these arguments (default policy ZNuma at
        100% CXL, default CPU the config's)."""
        policies = tuple(policies) if policies else (
            numa_mod.ZNuma(cxl_fraction=1.0),)
        for p in policies:
            self._check_policy(p)
        return engine_mod.SweepSpec(
            footprint_factors=tuple(footprint_factors), policies=policies,
            cpus=tuple(cpus) if cpus else (self.config.cpu,), kernel=kernel,
            backend=backend,
            topologies=tuple(topologies) if topologies else (),
            workloads=tuple(workloads) if workloads else (),
            tiering=tuple(tiering) if tiering else (),
            sampling=tuple(sampling) if sampling else (),
            distributions=tuple(distributions) if distributions else ())

    def stream_suite_sequential(self,
                                footprint_factors: Sequence[int]
                                = (2, 4, 6, 8),
                                policy: Optional[numa_mod.Policy] = None,
                                kernel: str = "triad",
                                cpu: Optional[CPUModel] = None
                                ) -> List[Dict]:
        """Per-config sequential path (one kernel call per footprint).

        The baseline the batched :meth:`stream_suite` is held against:
        its stats are bitwise the same.
        """
        policy = policy or numa_mod.ZNuma(cxl_fraction=1.0)
        rows = []
        for k in footprint_factors:
            fp = k * self.config.cache.l2_bytes
            r = self.run_stream(kernel, fp, policy, cpu=cpu)
            rows.append({"footprint_x_l2": k, "kernel": kernel,
                         "policy": numa_mod.describe(policy),
                         "cpu": r.cpu, **r.row(), "stats": r.stats})
        return rows

    def latency_breakdown(self) -> Dict[str, float]:
        return self.config.timing.cxl.stage_breakdown()
