"""CXLRAMSim facade: build -> enumerate -> online -> characterize.

One object wires the whole paper together: topology + firmware + enumeration
(:mod:`.topology`), per-tier timing (:mod:`.timing`), the cache/tier machine
(:mod:`.machine`), placement policies (:mod:`.numa`) and STREAM workloads
(:mod:`.stream`), with the cache simulation on a torch device — the CUDA
card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core import cache as cache_sim
from repro_torch.core import engine as engine_mod
from repro_torch.core import numa as numa_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core import topology as topo
from repro_torch.core.machine import CPUModel, Machine, RunResult
from repro_torch.core.timing import TimingConfig


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
    def route(self, switch=None):
        """N-target route map over this system's committed HDM decoders."""
        raise NotImplementedError(
            "CXLRAMSim.route needs core/route.py, which is not ported to "
            "repro_torch yet (ROADMAP queue 1, item 4)")

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
        """The grid — (workload x footprint x policy x CPU) — batched.

        Every (workload, footprint, policy) cell is simulated in one device
        call; CPU models and `distributions` entries vary only the timing
        fixed point.  `backend` is ``None`` (follow the device),
        ``'reference'`` or ``'cuda'``.

        Not ported yet, and raising ``NotImplementedError`` when given:
        `topologies` (ROADMAP queue 1, item 4), non-STREAM `workloads`
        (item 5), `mesh` and `stream_chunk` (item 6), non-None `tiering`
        and `sampling` entries (item 7), and `resume`, `fault_plan` and
        `report` (item 8).
        """
        if mesh is not None or stream_chunk is not None:
            raise NotImplementedError(
                "mesh/stream_chunk need core/distribute.py, which is not "
                "ported to repro_torch yet (ROADMAP queue 1, item 6)")
        policies = tuple(policies) if policies else (
            numa_mod.ZNuma(cxl_fraction=1.0),)
        for p in policies:
            self._check_policy(p)
        cpus = tuple(cpus) if cpus else (self.config.cpu,)
        spec = engine_mod.SweepSpec(
            footprint_factors=tuple(footprint_factors), policies=policies,
            cpus=cpus, kernel=kernel, backend=backend,
            topologies=tuple(topologies) if topologies else (),
            workloads=tuple(workloads) if workloads else (),
            tiering=tuple(tiering) if tiering else (),
            sampling=tuple(sampling) if sampling else (),
            distributions=tuple(distributions) if distributions else ())
        return engine_mod.run_sweep(spec, self.config.cache,
                                    self.config.timing, device=self.device,
                                    resume=resume, fault_plan=fault_plan,
                                    report=report)

    def latency_breakdown(self) -> Dict[str, float]:
        return self.config.timing.cxl.stage_breakdown()
