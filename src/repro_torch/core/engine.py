"""Batched trace engine: the characterization sweep as one device call.

The paper's §IV suite sweeps STREAM footprints x page-placement policies x
CPU models; the scenario axes widen it to topologies (N routed targets),
workloads, dynamic tiering, sampled simulation and latency distributions.
This engine stacks every (topology, workload, footprint, policy) cell into
a leading batch dimension, pads the traces to a common length with
sentinel entries, and runs the exact two-level MESI model of
:mod:`repro_torch.core.cache` over the whole batch in one kernel call
(:mod:`repro_torch.kernels.cache_sim`).  CPU models do not touch cache
state, so the engine simulates each cell once and broadcasts the stats
across the CPU axis before closing the Picard timing fixed point
(:func:`repro_torch.core.machine.time_batch`, host NumPy float64).

A sweep with a dynamic-tiering or sampling entry runs the epoch-structured
program instead (:mod:`repro_torch.core.tiering_dyn`, one call of the
``mesi_dyn_segment`` kernel): static and exact rows ride along in the
same batch, with stats equal to the static path's.

Traces come from the workload generators of :mod:`repro_torch.workloads`,
built on the simulation device; :func:`stack_device_traces` pads and
stacks them there too.

Devices and backends
--------------------
:func:`run_sweep` runs on the CUDA device unless the caller passes
``device="cpu"``, and raises when no CUDA device is present.  The cache
simulation follows the device of its trace: CUDA tensors go to the
hand-written kernels, CPU tensors to their plain PyTorch versions.
``backend="reference"`` selects the plain versions on either device
(parity checks); ``backend="cuda"`` (or the JAX package's name,
``"pallas"``) insists on the kernels.

Sentinel convention
-------------------
Padded trace entries carry ``addr == SENTINEL`` (= -1).  Both backends skip
all state/stat updates for them, so stats over a padded trace are bitwise
equal to the unpadded run.  Padding is only ever appended at the end of a
trace (logical time still advances across sentinels).

The executor seam
-----------------
:func:`run_sweep` builds the batch, routes it and closes the timing; how
the stacked batch is simulated is its executor's business
(:class:`LocalExecutor`, one resident kernel call, by default).
:mod:`repro_torch.core.distribute` plugs in sharded, streamed and
resilient executors, whose counters are bitwise the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core import numa as numa_mod
from repro_torch.core import route as route_mod
from repro_torch.core import sampling as sampling_mod
from repro_torch.core import tiering_dyn
from repro_torch.core.cache import init_batch_carry  # noqa: F401  (engine API)
from repro_torch.core.device import resolve_device  # noqa: F401  (engine API)
from repro_torch.core.machine import CPUModel, RunResult, time_batch
from repro_torch.core.timing import LatencyDistribution, TimingConfig
from repro_torch.kernels import ops
from repro_torch.kernels.cache_sim import check_chunk, pad_trace
from repro_torch.runtime.trace import span
from repro_torch.workloads.base import Stream, Workload

SENTINEL = cache_mod.SENTINEL   # padded trace entries: addr == SENTINEL


# ---------------------------------------------------------------------------
# Sweep specification
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """The characterization grid, batched into one device call.

    The cache model runs once per (workload, footprint, policy) cell;
    `cpus` and `distributions` only vary the analytic timing layer.

    Parameters
    ----------
    footprint_factors : tuple of int
        Multiples of the machine's L2 size (the paper runs STREAM at
        {2,4,6,8} x L2).
    policies : tuple of numa.Policy
        Page-placement policies.
    cpus : tuple of CPUModel
        Analytic issue models; broadcast over the simulated cells.
    kernel : str
        STREAM kernel of the default workload axis (used when `workloads`
        is empty).
    backend : str, optional
        ``None`` (follow the device), ``'reference'`` (plain PyTorch) or
        ``'cuda'`` (the kernels; ``'pallas'`` is the same).
    topologies : tuple of route.TopologySpec
        Each spec is enumerated (committed HDM decoders) and its N-target
        route map drives per-access routing, all in one batch (stats
        padded to the widest target count).  Empty = the binary DRAM/CXL
        tier path, equal to one direct-attach expander.
    workloads : tuple of workloads.Workload
        Trace generators; empty = ``(Stream(kernel),)``.
    tiering : tuple of Optional[tiering_dyn.DynamicTiering]
        Epoch-based dynamic tiering; ``None`` entries run static placement
        and give the static rows.  Empty = static only.
    sampling : tuple of Optional[sampling.SamplingSpec]
        SMARTS-style sampled simulation; ``None`` entries run exact.
        Sampled rows carry whole-trace estimates and ``*_ci95`` columns.
    distributions : tuple of Optional[timing.LatencyDistribution]
        Load-dependent latency distributions; each entry re-closes the
        timing fixed point over the same device run (``None`` = point
        timing).
    """
    footprint_factors: Tuple[int, ...] = (2, 4, 6, 8)
    policies: Tuple[numa_mod.Policy, ...] = (numa_mod.ZNuma(1.0),)
    cpus: Tuple[CPUModel, ...] = (CPUModel(kind="o3"),)
    kernel: str = "triad"
    backend: Optional[str] = None
    topologies: Tuple[route_mod.TopologySpec, ...] = ()
    workloads: Tuple[Workload, ...] = ()
    tiering: Tuple[Optional[tiering_dyn.DynamicTiering], ...] = ()
    sampling: Tuple[Optional[sampling_mod.SamplingSpec], ...] = ()
    distributions: Tuple[Optional[LatencyDistribution], ...] = ()

    @property
    def workload_axis(self) -> Tuple[Workload, ...]:
        """The workload loop; defaults to STREAM with `self.kernel`."""
        return self.workloads if self.workloads else (Stream(self.kernel),)

    @property
    def sim_cells(self) -> List[Tuple[Workload, int, numa_mod.Policy]]:
        """All (workload, footprint-factor, policy) cells, workload-major."""
        return [(wl, k, pol) for wl in self.workload_axis
                for k in self.footprint_factors
                for pol in self.policies]

    @property
    def topology_axis(self) -> Tuple[Optional[route_mod.TopologySpec], ...]:
        """The topology loop: `(None,)` = the binary-tier path."""
        return self.topologies if self.topologies else (None,)

    @property
    def tiering_axis(self) -> Tuple[
            Optional[tiering_dyn.DynamicTiering], ...]:
        """The tiering loop: `(None,)` = static placement only."""
        return self.tiering if self.tiering else (None,)

    @property
    def sampling_axis(self) -> Tuple[
            Optional[sampling_mod.SamplingSpec], ...]:
        """The sampling loop: `(None,)` = exact simulation only."""
        return self.sampling if self.sampling else (None,)

    @property
    def distributions_axis(self) -> Tuple[
            Optional[LatencyDistribution], ...]:
        """The latency-distribution loop: `(None,)` = point timing."""
        return self.distributions if self.distributions else (None,)


# ---------------------------------------------------------------------------
# Trace batching
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceBatch:
    """Stacked per-config traces, sentinel-padded to a common length.

    All arrays are (B, N) int32 (NumPy from :func:`stack_traces`, device
    tensors from :func:`stack_device_traces`); `n_valid[b]` real entries
    per row, the rest sentinel-padded (`addr == SENTINEL`, other fields
    zero).
    """
    addr: object
    is_write: object
    core: object
    tier: object
    n_valid: np.ndarray

    @property
    def batch(self) -> int:
        return self.addr.shape[0]

    @property
    def length(self) -> int:
        return self.addr.shape[1]

    @property
    def total_accesses(self) -> int:
        return int(self.n_valid.sum())


def stack_traces(traces: Sequence[Tuple], pad_to_multiple: int = 1
                 ) -> TraceBatch:
    """Stack host (addr, is_write[, core[, tier]]) traces of unequal length.

    Rows are padded at the end with `SENTINEL` addresses (zero for the
    other fields), to the longest row rounded up to a multiple of
    `pad_to_multiple`.  `None` fields become zeros.  Returns host-resident
    (B, N) NumPy arrays.
    """
    if not traces:
        raise ValueError("no traces to stack (empty sweep grid?)")
    if pad_to_multiple < 1:
        raise ValueError(f"pad_to_multiple must be >= 1, got "
                         f"{pad_to_multiple}")
    n_valid = np.asarray([np.asarray(t[0]).shape[0] for t in traces],
                         np.int64)
    n_max = int(n_valid.max())
    n_max = -(-n_max // pad_to_multiple) * pad_to_multiple
    b = len(traces)
    addr = np.full((b, n_max), SENTINEL, np.int32)
    is_write = np.zeros((b, n_max), np.int32)
    core = np.zeros((b, n_max), np.int32)
    tier = np.zeros((b, n_max), np.int32)
    for i, t in enumerate(traces):
        a = np.asarray(t[0], np.int32)
        n = a.shape[0]
        addr[i, :n] = a
        is_write[i, :n] = np.asarray(t[1], np.int32)
        if len(t) > 2 and t[2] is not None:
            core[i, :n] = np.asarray(t[2], np.int32)
        if len(t) > 3 and t[3] is not None:
            tier[i, :n] = np.asarray(t[3], np.int32)
    return TraceBatch(addr=addr, is_write=is_write, core=core, tier=tier,
                      n_valid=n_valid)


def stack_device_traces(traces: Sequence[Tuple], pad_to_multiple: int = 1
                        ) -> TraceBatch:
    """Device-resident :func:`stack_traces`: pad + stack with torch ops.

    The traces stay on their device (that of the first address tensor);
    `n_valid` stays host-side (shape metadata).  The common length is
    rounded up to a multiple of `pad_to_multiple` with sentinel entries,
    as the JAX package's stacker does for its kernel's chunk size.
    """
    if not traces:
        raise ValueError("no traces to stack (empty sweep grid?)")
    if pad_to_multiple < 1:
        raise ValueError(f"pad_to_multiple must be >= 1, got "
                         f"{pad_to_multiple}")
    device = traces[0][0].device
    n_valid = np.asarray([int(t[0].shape[0]) for t in traces], np.int64)
    n_max = int(n_valid.max())
    n_max = -(-n_max // pad_to_multiple) * pad_to_multiple

    def field(i, fill=0):
        rows = []
        for t in traces:
            if len(t) > i and t[i] is not None:
                x = t[i].to(torch.int32)
                rows.append(torch.nn.functional.pad(
                    x, (0, n_max - x.shape[0]), value=fill))
            else:
                rows.append(torch.zeros((n_max,), dtype=torch.int32,
                                        device=device))
        return torch.stack(rows)

    return TraceBatch(addr=field(0, fill=SENTINEL), is_write=field(1),
                      core=field(2), tier=field(3), n_valid=n_valid)


# ---------------------------------------------------------------------------
# Batched simulation: segment-carry primitives
# ---------------------------------------------------------------------------
# The batched run is expressed as *segments threaded through an explicit
# carry*: `init_batch_carry` builds the per-row packed cache state, and
# `run_batch_segment` advances every row by one (B, n_seg) slice of the
# trace.  The resident path is ONE segment spanning the whole trace.
# Because the cache model is integer arithmetic and the carry threads the
# exact state (including the logical clock `t`), splitting a trace into
# segments is bitwise-neutral.

def run_batch_segment(p: cache_mod.CacheParams, carry, addr, is_write,
                      core, tier, *, donate: bool = False,
                      backend: Optional[str] = None, chunk: int = 512):
    """One segment: `(carry, (B, n_seg) slice) -> carry`.

    Parameters
    ----------
    p : CacheParams
        Cache geometry.
    carry : tuple
        `(l1p, l2p, stats, t)` from :func:`init_batch_carry` or a prior
        segment call (or converted from the JAX package's carry by
        :mod:`repro_torch.convert`).
    addr, is_write, core, tier : (B, n_seg) int32 tensors
        The segment; `addr == SENTINEL` marks padding.
    donate : bool
        The JAX package's buffer donation: accepted and ignored, since
        neither backend writes its input carry.
    backend : str, optional
        ``None`` (follow the device), ``'reference'`` or ``'cuda'``.  Both
        thread the identical carry, so segments may alternate backends
        freely with bitwise-equal results.
    chunk : int
        The JAX package's trace elements per Pallas grid step, a TPU
        tiling parameter: accepted (>= 1) and ignored.

    Returns
    -------
    tuple
        The advanced carry; `carry[2]` is the running (B, nstats) stats.
    """
    check_chunk(chunk)
    return ops.mesi_run_segment(carry, addr, is_write, core, tier,
                                params=p, backend=backend)


def run_traces(p: cache_mod.CacheParams, addr, is_write=None,
               core=None, tier=None, *, backend: Optional[str] = None,
               chunk: int = 512, segment: Optional[int] = None,
               ) -> Tuple[torch.Tensor, cache_mod.CacheState]:
    """Simulate a (B, N) batch of sentinel-padded traces in one call.

    Args:
      p: cache geometry (shared across the batch).
      addr: (B, N) int32 tensor, `SENTINEL` marks padding; its device is
        where the simulation runs.
      is_write/core/tier: (B, N) int32 tensors (or None for zeros).
      backend: ``None`` (follow the device), ``'reference'`` (plain
        PyTorch) or ``'cuda'`` (the MESI kernel).
      chunk: the JAX package's trace elements per Pallas grid step, a TPU
        tiling parameter: accepted (>= 1) and ignored.
      segment: thread the trace through the carry in (B, segment) slices
        — one call per slice instead of one over the whole length.  The
        trace is sentinel-padded up to a multiple; stats and final state
        are bitwise-equal to the resident path.

    Returns: (stats (B, nstats(p.n_targets)) int32, batched CacheState).
    """
    check_chunk(chunk)
    addr = torch.as_tensor(addr).to(torch.int32)
    if addr.ndim != 2:
        raise ValueError("run_traces expects a (B, N) batch; "
                         "use addr[None] for a single trace")

    def field(x):
        if x is None:
            return torch.zeros_like(addr)
        return torch.as_tensor(x, device=addr.device).to(torch.int32)

    is_write, core, tier = field(is_write), field(core), field(tier)
    if segment is not None:
        return _run_traces_segmented(p, addr, is_write, core, tier,
                                     segment=segment, backend=backend)
    return ops.mesi_cache_sim(addr, is_write, core, tier, params=p,
                              backend=backend)


def _run_traces_segmented(p: cache_mod.CacheParams, addr, is_write, core,
                          tier, *, segment: int,
                          backend: Optional[str] = None
                          ) -> Tuple[torch.Tensor, cache_mod.CacheState]:
    """Host loop threading the carry through fixed-size segments.

    One call per (B, segment) slice; only the carry (packed cache state +
    stats) persists between calls.  Sentinel padding rounds the length up
    to a segment multiple (padding is inert, so stats stay bitwise-equal
    to the resident run).
    """
    if segment < 1:
        raise ValueError(f"segment must be >= 1, got {segment}")
    b, n = addr.shape
    segment = min(segment, n)   # never pad beyond the trace itself
    addr, is_write, core, tier = pad_trace(segment, addr, is_write, core,
                                           tier)
    carry = init_batch_carry(p, b, device=addr.device)
    for s in range(0, addr.shape[1], segment):
        carry = run_batch_segment(
            p, carry, addr[:, s:s + segment], is_write[:, s:s + segment],
            core[:, s:s + segment], tier[:, s:s + segment], backend=backend)
    l1p, l2p, stats, _ = carry
    return stats, cache_mod.unpack_state(l1p, l2p)


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------
def _routed_tier(wt, pol, route) -> torch.Tensor:
    """Per-access target of a static cell (the binary tier without a
    route).  Workloads that carry their own tier intent route through it
    instead of the placement policy."""
    if wt.tier is not None:
        return (wt.tier if route is None
                else route.targets_of_tiered_lines(wt.tier, wt.addr))
    if route is None:
        return numa_mod.tier_of_lines(pol, wt.addr, wt.n_pages)
    return route.target_of_lines(pol, wt.addr, wt.n_pages)


def _cell_traces(spec: SweepSpec, cache: cache_mod.CacheParams, device):
    """Each (workload, footprint) trace, generated once on `device`."""
    with span("engine.traces"):
        out = {}
        for wl, k, _ in spec.sim_cells:
            if (wl, k) not in out:
                out[(wl, k)] = wl.device_trace(k * cache.l2_bytes, device)
        return out


def build_stream_batch(spec: SweepSpec, cache: cache_mod.CacheParams,
                       chunk: int = 512,
                       routes: Optional[Sequence[
                           Optional[route_mod.RouteMap]]] = None, *,
                       device=None) -> TraceBatch:
    """The batch of :func:`build_sweep_batch` without its cell -> row map."""
    batch, _ = build_sweep_batch(spec, cache, chunk, routes=routes,
                                 device=device)
    return batch


def build_sweep_batch(spec: SweepSpec, cache: cache_mod.CacheParams,
                      chunk: int = 512, *,
                      routes: Optional[Sequence[
                          Optional[route_mod.RouteMap]]] = None,
                      device=None) -> Tuple[TraceBatch, List[int]]:
    """Materialize the (topology x workload x footprint x policy) batch.

    Each workload generates its trace once per footprint on the device;
    routes and policies only relabel each access's target
    (:meth:`repro_torch.core.route.RouteMap.target_of_lines`, or the
    binary :func:`repro_torch.core.numa.tier_of_lines` without a route),
    so the trace is shared across the topology/policy cells.  Cells whose
    workload carries its own tier map are policy-independent and share
    one row.  Rows are padded to the longest row.  `chunk`, the JAX
    package's pad granularity for its kernel, is accepted (>= 1) and
    ignored: padding is inert.

    Returns
    -------
    (TraceBatch, list of int)
        The device-resident batch, and one batch-row index per logical cell
        in ``topology-major x sim_cells`` order.
    """
    with span("engine.build"):
        check_chunk(chunk)
        device = resolve_device(device)
        if routes is None:
            routes = [None] * len(spec.topology_axis)
        cell_traces = _cell_traces(spec, cache, device)
        traces: List[Tuple] = []
        row_of = {}
        cell_rows: List[int] = []
        for ti, route in enumerate(routes):
            for wl, k, pol in spec.sim_cells:
                wt = cell_traces[(wl, k)]
                key = (ti, wl, k) if wt.tier is not None else (ti, wl, k, pol)
                if key not in row_of:
                    traces.append((wt.addr, wt.is_write, None,
                                   _routed_tier(wt, pol, route)))
                    row_of[key] = len(traces) - 1
                cell_rows.append(row_of[key])
        return stack_device_traces(traces), cell_rows


def _narrow_idx(t_max: int, t_route: int) -> List[int]:
    """Stat columns a `t_route`-target route occupies in a `t_max`-wide
    layout (the complement is identically zero — see `_narrow_stats`)."""
    return (list(range(4)) + list(range(4, 4 + t_route))
            + list(range(4 + t_max, 4 + t_max + t_route))
            + list(range(4 + 2 * t_max, 8 + 2 * t_max)))


def _narrow_stats(stats: np.ndarray, t_max: int, t_route: int) -> np.ndarray:
    """Drop the (all-zero) per-target columns a narrower route never hit.

    The batch sizes every row's stats for the widest topology (`t_max`
    targets); a route with `t_route < t_max` targets only routes ids
    `< t_route`, so the dropped read/write columns are zero.
    """
    if t_route == t_max:
        return stats
    return stats[:, _narrow_idx(t_max, t_route)]


class LocalExecutor:
    """Default sweep executor: the whole batch as ONE resident kernel call.

    The executor seam is what :mod:`repro_torch.core.distribute` plugs
    into — it owns only the simulation of an already-built batch (grid
    flattening, routing, timing and row assembly stay in this module), so
    any executor that returns the same counters gives the same rows.
    """

    def run_static(self, p: cache_mod.CacheParams, batch: TraceBatch,
                   *, backend: Optional[str], chunk: int) -> np.ndarray:
        """Simulate the stacked batch; return host (B, nstats) int64."""
        stats, _ = run_traces(p, batch.addr, batch.is_write, core=None,
                              tier=batch.tier, backend=backend, chunk=chunk)
        return stats.cpu().numpy().astype(np.int64)

    def run_dynamic(self, p: cache_mod.CacheParams, tb: "TieringBatch",
                    *, slot_len: int, k_max: int,
                    backend: Optional[str] = None
                    ) -> tiering_dyn.DynOutputs:
        """Run the epoch-structured batch in one kernel call."""
        return tiering_dyn.run_dynamic(
            p, tb.batch.addr, tb.batch.is_write, tb.batch.core,
            tb.batch.tier, slot_len=slot_len, k_max=k_max,
            dyn_flag=tb.dyn_flag, page_map0=tb.page_map0,
            n_pages=tb.n_pages, budget=tb.budget, threshold=tb.threshold,
            period=tb.period, dram_cap=tb.dram_cap,
            page_target_lines=tb.page_target_lines,
            ssd_tid=tb.ssd_tid, cxl_cap=tb.cxl_cap,
            s_warm=tb.s_warm, s_meas=tb.s_meas, s_per=tb.s_per,
            backend=backend)


_LOCAL_EXECUTOR = LocalExecutor()


def _resolve_executor(executor, resume, fault_plan, report):
    """The executor the resilience knobs select (None = LocalExecutor).

    ``resume`` / ``fault_plan`` / ``report`` build a
    :class:`repro_torch.core.distribute.ResilientExecutor` (deferred import
    — distribute sits above engine); they are mutually exclusive with an
    explicit ``executor``, which owns its own configuration.
    """
    if resume is None and fault_plan is None and report is None:
        return executor
    if executor is not None:
        raise ValueError(
            "pass either executor= or the resilience knobs "
            "(resume/fault_plan/report), not both — configure a "
            "ResilientExecutor directly for full control")
    from repro_torch.core import distribute
    return distribute.ResilientExecutor(checkpoint=resume,
                                        fault_plan=fault_plan,
                                        report=report)


def run_sweep(spec: SweepSpec, cache: cache_mod.CacheParams,
              timing: TimingConfig, *, chunk: int = 512, executor=None,
              resume=None, fault_plan=None, report=None,
              device=None) -> List[Dict]:
    """Run the whole characterization suite as one batched device call.

    Parameters
    ----------
    spec : SweepSpec
        The (sampling x tiering x topology x workload x footprint x policy
        x cpu) grid, with the distributions axis outermost.
    cache : CacheParams
        Cache geometry (the stats width follows the widest route).
    timing : TimingConfig
        Per-tier timing model closing the Picard fixed point.
    chunk : int
        The JAX package's Pallas grid step (and stacking pad): a TPU
        tiling parameter, checked (>= 1) and handed to the executor, which
        ignores it.
    executor : optional
        How the stacked batch is simulated (the ``run_static`` /
        ``run_dynamic`` duck type).  Default: :class:`LocalExecutor`, one
        resident kernel call; :class:`repro_torch.core.distribute.
        ShardedExecutor` shards rows and/or streams trace segments.  Every
        executor returns the same counters, so rows never depend on it.
    resume : CheckpointPolicy, path, or None
        Run (or resume) through a :class:`repro_torch.core.distribute.
        ResilientExecutor` checkpointing to this directory: a sweep killed
        at a segment boundary and rerun with the same ``resume=``
        fast-forwards past the completed segments and shards and gives
        the same rows.
    fault_plan : repro_torch.core.resilience.FaultPlan, optional
        Deterministic failure injection (selects the resilient executor,
        like ``resume``).
    report : repro_torch.core.resilience.RunReport, optional
        Event sink recording retries, resumes, degradations and
        checkpoint timings.
    device : str or torch.device, optional
        Where traces are built and simulated; ``None`` means the CUDA
        card (raises when there is none).

    Returns
    -------
    list of dict
        One row per grid point — the `RunResult.row()` schema plus the
        raw `stats` counters, a `workload` label, the STREAM `kernel`, and
        `topology` / `tiering` / `sampling` / `distribution` labels when
        the spec sweeps those axes.
    """
    results = sweep_results(spec, cache, timing, chunk=chunk,
                            executor=executor, resume=resume,
                            fault_plan=fault_plan, report=report,
                            device=device)
    with span("engine.rows"):
        rows: List[Dict] = []
        i = 0
        for dist in spec.distributions_axis:
            for sp in spec.sampling_axis:
                for tr in spec.tiering_axis:
                    for topo in spec.topology_axis:
                        for wl, k, pol in spec.sim_cells:
                            for _cpu in spec.cpus:
                                r = results[i]
                                row = {"workload": wl.name,
                                       "footprint_x_l2": k,
                                       "policy": numa_mod.describe(pol),
                                       "cpu": r.cpu, **r.row(),
                                       "stats": r.stats}
                                if isinstance(wl, Stream):
                                    row["kernel"] = wl.kernel
                                if topo is not None:
                                    row["topology"] = topo.name
                                if spec.tiering:
                                    row["tiering"] = tiering_dyn.describe(tr)
                                if spec.sampling:
                                    row["sampling"] = sampling_mod.describe(sp)
                                if spec.distributions:
                                    row["distribution"] = (
                                        "off" if dist is None else dist.label)
                                rows.append(row)
                                i += 1
    return rows


def sweep_results(spec: SweepSpec, cache: cache_mod.CacheParams,
                  timing: TimingConfig, *, chunk: int = 512, executor=None,
                  resume=None, fault_plan=None, report=None,
                  device=None) -> List[RunResult]:
    """`run_sweep` returning full RunResults (row order identical).

    One device call simulates every (topology, workload, footprint,
    policy) cell; topologies with different target counts share it by
    padding the stats width to the widest route (the unused per-target
    counters stay zero and are dropped again before timing).  Each cell's
    stats are then broadcast across the CPU-model axis and the Picard
    timing fixed point closes per topology group, with each group's own
    route.  A tiering or sampling entry sends the sweep through the
    epoch-structured program (:func:`_sweep_results_dynamic`).  The
    keywords are :func:`run_sweep`'s.
    """
    check_chunk(chunk)
    executor = _resolve_executor(executor, resume, fault_plan, report)
    executor = executor if executor is not None else _LOCAL_EXECUTOR
    device = resolve_device(device)
    routes = sweep_routes(spec, timing)
    if (any(tr is not None for tr in spec.tiering_axis)
            or any(sp is not None for sp in spec.sampling_axis)):
        return _sweep_results_dynamic(spec, cache, timing, routes,
                                      device=device, executor=executor)
    t_max = max(2 if r is None else r.n_targets for r in routes)
    p = dataclasses.replace(cache, n_targets=t_max)
    batch, cell_rows = build_sweep_batch(spec, cache, routes=routes,
                                         device=device)
    with span("engine.simulate"):
        stats = executor.run_static(p, batch, backend=spec.backend,
                                    chunk=chunk)
    n_cells = len(spec.sim_cells)
    rows_cpus = [wl.cpu_for(cpu) for wl, _k, _pol in spec.sim_cells
                 for cpu in spec.cpus]
    out: List[RunResult] = []
    # the distributions axis only re-closes the timing fixed point — the
    # device call above ran once for every entry
    for dist in spec.distributions_axis:
        results: List[RunResult] = []
        for ti, route in enumerate(routes):
            block = stats[cell_rows[ti * n_cells:(ti + 1) * n_cells]]
            t_route = 2 if route is None else route.n_targets
            block = _narrow_stats(block, t_max, t_route)
            rows_stats = np.repeat(block, len(spec.cpus), axis=0)
            results.extend(time_batch(timing, rows_cpus, rows_stats,
                                      route=route, dist=dist))
        # explicit all-None tiering/sampling axes repeat the static block
        # per entry — independent copies, so no rows share mutable state
        out.extend(results)
        n_copies = len(spec.sampling_axis) * len(spec.tiering_axis)
        for _ in range(n_copies - 1):
            out.extend(_copy_result(r) for r in results)
    return out


def sweep_routes(spec: SweepSpec, timing: TimingConfig
                 ) -> List[Optional[route_mod.RouteMap]]:
    """One route per topology entry (``None``: the default two targets)."""
    return [None if tp is None else route_mod.build_route(tp, timing)
            for tp in spec.topology_axis]


def _copy_result(r: RunResult) -> RunResult:
    """Independent copy of a RunResult (no shared mutable containers)."""
    return dataclasses.replace(
        r, stats=dict(r.stats), miss_rates=dict(r.miss_rates),
        achieved_gbps=dict(r.achieved_gbps),
        loaded_latency_ns=dict(r.loaded_latency_ns),
        lat_percentiles=(None if r.lat_percentiles is None else
                         {k: dict(v) for k, v in r.lat_percentiles.items()}))


# ---------------------------------------------------------------------------
# Dynamic tiering and sampling: the epoch-structured sweep path
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TieringBatch:
    """Per-row inputs of the epoch program (see `tiering_dyn.run_dynamic`).

    `batch.tier` carries the per-line CXL decode target for dynamic rows
    and the final per-access target for static (`tiering=None`) rows;
    `dyn_flag` selects which reading each row uses.  Traces, the page maps
    and the migration table live on the simulation device; the per-row
    scalars are host int64 arrays.
    """
    batch: TraceBatch
    dyn_flag: np.ndarray                # (B,) 1 = page map routes, 0 = static
    page_map0: torch.Tensor             # (B, P) initial page -> {0, 1[, 2]}
    n_pages: np.ndarray                 # (B,)
    budget: np.ndarray                  # (B,)
    threshold: np.ndarray               # (B,)
    period: np.ndarray                  # (B,) slots per epoch
    dram_cap: np.ndarray                # (B,)
    ssd_tid: np.ndarray                 # (B,) SSD target id; 0 = two-tier row
    cxl_cap: np.ndarray                 # (B,) level-1 capacity (pages)
    page_target_lines: torch.Tensor     # (B, P, T)
    s_warm: np.ndarray                  # (B,) sampling warm slots (slot units)
    s_meas: np.ndarray                  # (B,) sampling measure slots
    s_per: np.ndarray                   # (B,) sampling period; 0 = exact
    cell_rows: List[int]                # logical cell -> batch row


def build_tiering_batch(spec: SweepSpec, cache: cache_mod.CacheParams,
                        routes: Sequence[Optional[route_mod.RouteMap]],
                        slot: int, t_max: int, *, device=None
                        ) -> TieringBatch:
    """Materialize the (sampling x tiering x topology x workload x
    footprint x policy) batch for the epoch program.

    Row sharing mirrors :func:`build_sweep_batch`: cells whose workload
    owns its residency map are policy-independent (dynamic rows then seed
    the tierer with the first-touch page map of the workload's own tier
    stream, :func:`repro_torch.core.numa.first_touch_page_map`); every
    ``tiering=None`` cell shares one row across all ``None`` entries, and
    likewise every ``sampling=None`` cell across ``None`` sampling
    entries.  The stacked traces are sentinel-padded to a multiple of
    `slot`; the stats width is `t_max` (the widest route).
    """
    device = resolve_device(device)
    cells = spec.sim_cells
    cell_traces = _cell_traces(spec, cache, device)
    p_max = max(wt.n_pages for wt in cell_traces.values())
    ptl_of = []
    for route in routes:
        if route is None:
            ptl = torch.zeros((p_max, t_max), dtype=torch.int32,
                              device=device)
            ptl[:, 1] = numa_mod.LINES_PER_PAGE
        else:
            ptl = route.page_target_lines(p_max, width=t_max, device=device)
        ptl_of.append(ptl)

    traces: List[Tuple] = []
    pmap0s: List[torch.Tensor] = []
    scalars: List[Tuple[int, ...]] = []
    row_of: Dict = {}
    cell_rows: List[int] = []
    for si, sp in enumerate(spec.sampling_axis):
        skey = si if sp is not None else -1  # exact entries share rows
        sw, sm, spr = sampling_mod.scan_scalars(sp, slot)
        for tri, tr in enumerate(spec.tiering_axis):
            tkey = tri if tr is not None else -1  # static entries share rows
            for ti, route in enumerate(routes):
                for wl, k, pol in cells:
                    wt = cell_traces[(wl, k)]
                    key = ((skey, tkey, ti, wl, k) if wt.tier is not None
                           else (skey, tkey, ti, wl, k, pol))
                    if key not in row_of:
                        tier, pmap0, sc = _tiering_row(tr, wt, pol, route,
                                                       slot)
                        if wt.n_pages < p_max:  # pad: CXL, never eligible
                            pmap0 = torch.nn.functional.pad(
                                pmap0, (0, p_max - wt.n_pages), value=1)
                        traces.append((wt.addr, wt.is_write, None, tier))
                        pmap0s.append(pmap0)
                        scalars.append(sc + (sw, sm, spr, ti))
                        row_of[key] = len(traces) - 1
                    cell_rows.append(row_of[key])
    batch = stack_device_traces(traces)
    addr, is_write, core, tier = pad_trace(slot, batch.addr, batch.is_write,
                                           batch.core, batch.tier)
    batch = TraceBatch(addr=addr, is_write=is_write, core=core, tier=tier,
                       n_valid=batch.n_valid)
    sc = np.asarray(scalars, np.int64)
    return TieringBatch(
        batch=batch, dyn_flag=sc[:, 0], page_map0=torch.stack(pmap0s),
        n_pages=sc[:, 1], budget=sc[:, 2], threshold=sc[:, 3],
        period=sc[:, 4], dram_cap=sc[:, 5], ssd_tid=sc[:, 6],
        cxl_cap=sc[:, 7],
        page_target_lines=torch.stack([ptl_of[ti] for ti in sc[:, 11]]),
        s_warm=sc[:, 8], s_meas=sc[:, 9], s_per=sc[:, 10],
        cell_rows=cell_rows)


def _tiering_row(tr, wt, pol, route, slot: int):
    """``(tier, page_map0, scalars)`` of one epoch-program row.

    Dynamic rows carry each line's CXL decode target and start from the
    placement's page map; static rows carry their final targets, exactly
    the static path's, and never migrate.
    """
    unbounded = tiering_dyn.UNBOUNDED_PAGES
    device = wt.addr.device
    if tr is None:
        return (_routed_tier(wt, pol, route),
                torch.ones((wt.n_pages,), dtype=torch.int32, device=device),
                (0, wt.n_pages, 0, 1, 1, unbounded, 0, unbounded))
    tier = (torch.ones_like(wt.addr, dtype=torch.int32) if route is None
            else route.cxl_targets_of_lines(wt.addr))
    if wt.tier is not None:
        pmap0 = numa_mod.first_touch_page_map(wt.tier, wt.addr, wt.n_pages)
    else:
        pmap0 = (pol.tiers(wt.n_pages, device=device) != 0).to(torch.int32)
    cap = (unbounded if tr.dram_capacity_pages is None
           else tr.dram_capacity_pages)
    l1cap = (unbounded if tr.cxl_capacity_pages is None
             else tr.cxl_capacity_pages)
    ssd_t = 0 if route is None else route.ssd_tid
    return tier, pmap0, (1, wt.n_pages, tr.budget, tr.threshold,
                         tr.epoch_len // slot, cap, ssd_t, l1cap)


class DynamicLaunch(NamedTuple):
    """The epoch kernel's launch for a tiering/sampling sweep:
    ``tiering_dyn.run_dynamic(params, *trace, **kwargs)``."""
    params: cache_mod.CacheParams     # stats width = the widest route's
    batch: TieringBatch
    kwargs: Dict                      # slot_len, k_max and per-row scalars

    @property
    def trace(self) -> Tuple[torch.Tensor, ...]:
        b = self.batch.batch
        return b.addr, b.is_write, b.core, b.tier


def dynamic_launch(spec: SweepSpec, cache: cache_mod.CacheParams,
                   routes: Sequence[Optional[route_mod.RouteMap]],
                   *, device) -> DynamicLaunch:
    """Build a tiering/sampling sweep's batch and derive its scan slot and
    top-k width.

    The slot is the gcd of the tierers' epoch lengths (and of the sampling
    slot when the sweep also samples); the top-k width is the largest
    budget.  Raises ``ValueError`` when an epoch is not a whole number of
    slots.
    """
    with span("engine.build"):
        t_max = max(2 if r is None else r.n_targets for r in routes)
        p = dataclasses.replace(cache, n_targets=t_max)
        dyn = [tr for tr in spec.tiering_axis if tr is not None]
        sampled = [sp for sp in spec.sampling_axis if sp is not None]
        if dyn:
            # sampling slots must nest inside epoch slots: scan at the gcd
            slot = tiering_dyn.slot_length(dyn)
            if sampled:
                slot = math.gcd(slot, sampling_mod.SLOT_LEN)
            k_max = max(1, max(tr.budget for tr in dyn))
        else:
            slot = sampling_mod.SLOT_LEN
            k_max = 1
        for tr in dyn:
            if tr.epoch_len % slot:
                raise ValueError(
                    f"epoch_len {tr.epoch_len} is not a multiple of the "
                    f"sweep's epoch gcd {slot}")
        tb = build_tiering_batch(spec, cache, routes, slot, t_max,
                                 device=device)
        return DynamicLaunch(p, tb, dict(
            slot_len=slot, k_max=k_max, dyn_flag=tb.dyn_flag,
            page_map0=tb.page_map0, n_pages=tb.n_pages, budget=tb.budget,
            threshold=tb.threshold, period=tb.period, dram_cap=tb.dram_cap,
            page_target_lines=tb.page_target_lines, ssd_tid=tb.ssd_tid,
            cxl_cap=tb.cxl_cap, s_warm=tb.s_warm, s_meas=tb.s_meas,
            s_per=tb.s_per))


def _sweep_results_dynamic(spec: SweepSpec, cache: cache_mod.CacheParams,
                           timing: TimingConfig,
                           routes: Sequence[Optional[route_mod.RouteMap]],
                           *, device, executor) -> List[RunResult]:
    """The epoch-structured twin of the static `sweep_results` body.

    One epoch-kernel call (:func:`dynamic_launch`, run by the executor's
    ``run_dynamic``) simulates every (sampling, tiering, topology,
    workload, footprint, policy) cell;
    static rows ride along with a zero budget and their precomputed
    targets.  Migration line counts feed `time_batch(mig_lines=...)`;
    dynamic rows also get `migrated_pages` and per-epoch DRAM hit-tier
    fractions.  Sampled rows replace the gated device counters with
    whole-trace estimates (:func:`repro_torch.core.sampling.estimate` over
    the per-slot snapshot deltas) before the timing fixed point and carry
    per-counter 95% confidence intervals.
    """
    launch = dynamic_launch(spec, cache, routes, device=device)
    tb, slot = launch.batch, launch.kwargs["slot_len"]
    t_max = launch.params.n_targets
    with span("engine.simulate"):
        out = executor.run_dynamic(launch.params, tb, slot_len=slot,
                                   k_max=launch.kwargs["k_max"],
                                   backend=spec.backend)
        stats = out.stats.cpu().numpy().astype(np.int64)
        mig = np.stack([out.mig_read.cpu().numpy().astype(np.int64),
                        out.mig_write.cpu().numpy().astype(np.int64)], axis=1)
        slots = out.slots.cpu().numpy().astype(np.int64)     # (B, E, 4)
        snaps = out.snapshots.cpu().numpy()                   # (B, E, nstats)
        meas = out.meas.cpu().numpy()                         # (B, E)
    cells = spec.sim_cells
    n_cells = len(cells)
    n_cpus = len(spec.cpus)
    n_tier = len(spec.tiering_axis)
    rows_cpus = [wl.cpu_for(cpu) for wl, _k, _pol in cells
                 for cpu in spec.cpus]

    # whole-trace estimates per sampled batch row (a batch row belongs to
    # exactly one sampling entry)
    est_of: Dict[int, sampling_mod.Estimate] = {}

    def _est(br: int, sp: sampling_mod.SamplingSpec):
        if br not in est_of:
            est_of[br] = sampling_mod.estimate(
                cache_mod.snapshot_deltas(snaps[br]), slots[br, :, 0],
                meas[br], confidence=sp.confidence)
        return est_of[br]

    results: List[RunResult] = []
    # the distributions axis only re-closes the timing fixed point
    for dist in spec.distributions_axis:
        for si, sp in enumerate(spec.sampling_axis):
            for tri, tr in enumerate(spec.tiering_axis):
                for ti, route in enumerate(routes):
                    base = (((si * n_tier + tri) * len(routes) + ti)
                            * n_cells)
                    block_rows = tb.cell_rows[base:base + n_cells]
                    t_route = 2 if route is None else route.n_targets
                    if sp is None:
                        block = stats[block_rows]
                        ests = None
                    else:
                        ests = [_est(br, sp) for br in block_rows]
                        block = np.stack([e.stats for e in ests])
                    block = _narrow_stats(block, t_max, t_route)
                    rows_mig = np.repeat(mig[block_rows][:, :, :t_route],
                                         n_cpus, axis=0)
                    res = time_batch(timing, rows_cpus,
                                     np.repeat(block, n_cpus, axis=0),
                                     route=route, mig_lines=rows_mig,
                                     dist=dist)
                    for j, r in enumerate(res):
                        br = block_rows[j // n_cpus]
                        if tr is not None:
                            r.migrated_pages = int(slots[br, :, 2].sum()
                                                   + slots[br, :, 3].sum())
                            r.epoch_dram_frac = tiering_dyn.epoch_fractions(
                                slots[br], tr.epoch_len // slot)
                        if ests is not None:
                            e = ests[j // n_cpus]
                            r.sampled_frac = e.sampled_frac
                            r.sample_windows = e.n_windows
                            r.stats_ci95 = {
                                nm: float(e.ci[ci]) for nm, ci in zip(
                                    cache_mod.stat_names(t_route),
                                    _narrow_idx(t_max, t_route))}
                            r.l2_miss_rate_ci95 = e.l2_miss_rate_ci()[1]
                    results.extend(res)
    return results
