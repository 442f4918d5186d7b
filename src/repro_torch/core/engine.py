"""Batched trace engine: the §IV characterization sweep as one device call.

The paper's §IV suite sweeps STREAM footprints x page-placement policies x
CPU models.  This engine stacks every (workload, footprint, policy) cell
into a leading batch dimension, pads the traces to a common length with
sentinel entries, and runs the exact two-level MESI model of
:mod:`repro_torch.core.cache` over the whole batch in one call of the MESI
kernel (:mod:`repro_torch.kernels.cache_sim`).  CPU models do not touch
cache state, so the engine simulates each cell once and broadcasts the
stats across the CPU axis before closing the Picard timing fixed point
(:func:`repro_torch.core.machine.time_batch`, host NumPy float64).

Traces come from the workload generators of :mod:`repro_torch.workloads`,
built on the simulation device; :func:`stack_device_traces` pads and
stacks them there too.

Devices and backends
--------------------
:func:`run_sweep` runs on the CUDA device unless the caller passes
``device="cpu"``, and raises when no CUDA device is present.  The cache
simulation follows the device of its trace: CUDA tensors go to the
hand-written kernel, CPU tensors to the plain PyTorch version.
``backend="reference"`` selects the plain version on either device
(parity checks); ``backend="cuda"`` insists on the kernel.

Sentinel convention
-------------------
Padded trace entries carry ``addr == SENTINEL`` (= -1).  Both backends skip
all state/stat updates for them, so stats over a padded trace are bitwise
equal to the unpadded run.  Padding is only ever appended at the end of a
trace (logical time still advances across sentinels).

Not ported yet (each raises ``NotImplementedError``): the topology axis
and routing (ROADMAP queue 1, item 4), workloads other than STREAM
(item 5), sharded or streamed execution (item 6), dynamic tiering and
sampling (item 7), and checkpoint/resume with fault injection (item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core import numa as numa_mod
from repro_torch.core.cache import init_batch_carry  # noqa: F401  (engine API)
from repro_torch.core.machine import CPUModel, RunResult, time_batch
from repro_torch.core.timing import LatencyDistribution, TimingConfig
from repro_torch.kernels import ops
from repro_torch.kernels.cache_sim import pad_trace
from repro_torch.workloads.base import Stream, Workload

SENTINEL = cache_mod.SENTINEL   # padded trace entries: addr == SENTINEL


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises when CUDA is asked for (explicitly or by default) and no CUDA
    device is present; the caller must pass ``device="cpu"`` to run on
    the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "simulator on the CPU")
    return dev


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1, "
        f"item {item})")


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
        ``'cuda'`` (the MESI kernel).
    topologies, workloads, tiering, sampling
        The other scenario axes of the JAX package.  Only the static
        STREAM path is ported: `topologies` must be empty, `workloads`
        may hold only :class:`~repro_torch.workloads.base.Stream`, and
        `tiering` / `sampling` may hold only ``None`` entries (static,
        exact).  Anything else raises ``NotImplementedError``.
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
    topologies: Tuple = ()
    workloads: Tuple[Workload, ...] = ()
    tiering: Tuple = ()
    sampling: Tuple = ()
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
    def tiering_axis(self) -> Tuple[None, ...]:
        """The tiering loop: static placement only."""
        return self.tiering if self.tiering else (None,)

    @property
    def sampling_axis(self) -> Tuple[None, ...]:
        """The sampling loop: exact simulation only."""
        return self.sampling if self.sampling else (None,)

    @property
    def distributions_axis(self) -> Tuple[
            Optional[LatencyDistribution], ...]:
        """The latency-distribution loop: `(None,)` = point timing."""
        return self.distributions if self.distributions else (None,)

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for any axis the port lacks."""
        if self.topologies:
            raise _not_ported("the topologies axis (core/route.py)", 4)
        if any(not isinstance(wl, Stream) for wl in self.workload_axis):
            raise _not_ported("a workload other than STREAM", 5)
        if any(tr is not None for tr in self.tiering):
            raise _not_ported("dynamic tiering", 7)
        if any(sp is not None for sp in self.sampling):
            raise _not_ported("sampled simulation", 7)


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


def stack_traces(traces: Sequence[Tuple]) -> TraceBatch:
    """Stack host (addr, is_write[, core[, tier]]) traces of unequal length.

    Rows are padded at the end, to the longest row, with `SENTINEL`
    addresses (zero for the other fields).  `None` fields become zeros.
    Returns host-resident (B, N) NumPy arrays.
    """
    if not traces:
        raise ValueError("no traces to stack (empty sweep grid?)")
    n_valid = np.asarray([np.asarray(t[0]).shape[0] for t in traces],
                         np.int64)
    n_max = int(n_valid.max())
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


def stack_device_traces(traces: Sequence[Tuple]) -> TraceBatch:
    """Device-resident :func:`stack_traces`: pad + stack with torch ops.

    The traces stay on their device (that of the first address tensor);
    `n_valid` stays host-side (shape metadata).
    """
    if not traces:
        raise ValueError("no traces to stack (empty sweep grid?)")
    device = traces[0][0].device
    n_valid = np.asarray([int(t[0].shape[0]) for t in traces], np.int64)
    n_max = int(n_valid.max())

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
                      core, tier, *, backend: Optional[str] = None):
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
    backend : str, optional
        ``None`` (follow the device), ``'reference'`` or ``'cuda'``.  Both
        thread the identical carry, so segments may alternate backends
        freely with bitwise-equal results.

    Returns
    -------
    tuple
        The advanced carry; `carry[2]` is the running (B, nstats) stats.
    """
    return ops.mesi_run_segment(carry, addr, is_write, core, tier,
                                params=p, backend=backend)


def run_traces(p: cache_mod.CacheParams, addr, is_write=None,
               core=None, tier=None, *, backend: Optional[str] = None,
               segment: Optional[int] = None,
               ) -> Tuple[torch.Tensor, cache_mod.CacheState]:
    """Simulate a (B, N) batch of sentinel-padded traces in one call.

    Args:
      p: cache geometry (shared across the batch).
      addr: (B, N) int32 tensor, `SENTINEL` marks padding; its device is
        where the simulation runs.
      is_write/core/tier: (B, N) int32 tensors (or None for zeros).
      backend: ``None`` (follow the device), ``'reference'`` (plain
        PyTorch) or ``'cuda'`` (the MESI kernel).
      segment: thread the trace through the carry in (B, segment) slices
        — one call per slice instead of one over the whole length.  The
        trace is sentinel-padded up to a multiple; stats and final state
        are bitwise-equal to the resident path.

    Returns: (stats (B, nstats(p.n_targets)) int32, batched CacheState).
    """
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
# The §IV sweep
# ---------------------------------------------------------------------------
def build_sweep_batch(spec: SweepSpec, cache: cache_mod.CacheParams, *,
                      device=None) -> Tuple[TraceBatch, List[int]]:
    """Materialize the (workload x footprint x policy) batch on `device`.

    Each workload generates its trace once per footprint on the device;
    policies only relabel each access's DRAM/CXL tier
    (:func:`repro_torch.core.numa.tier_of_lines`), so the trace is shared
    across the policy cells.  Rows are padded to the longest row.

    Returns
    -------
    (TraceBatch, list of int)
        The device-resident batch, and one batch-row index per logical cell
        in ``sim_cells`` order.
    """
    spec.check_ported()
    device = resolve_device(device)
    cell_traces = {}
    for wl, k, _ in spec.sim_cells:
        if (wl, k) not in cell_traces:
            cell_traces[(wl, k)] = wl.device_trace(k * cache.l2_bytes,
                                                   device)
    traces: List[Tuple] = []
    row_of = {}
    cell_rows: List[int] = []
    for wl, k, pol in spec.sim_cells:
        key = (wl, k, pol)
        if key not in row_of:
            wt = cell_traces[(wl, k)]
            tier = numa_mod.tier_of_lines(pol, wt.addr, wt.n_pages)
            traces.append((wt.addr, wt.is_write, None, tier))
            row_of[key] = len(traces) - 1
        cell_rows.append(row_of[key])
    return stack_device_traces(traces), cell_rows


def _check_knobs(resume, fault_plan, report) -> None:
    if resume is not None or fault_plan is not None or report is not None:
        raise _not_ported("checkpoint/resume, fault injection and run "
                          "reports (resume/fault_plan/report)", 8)


def run_sweep(spec: SweepSpec, cache: cache_mod.CacheParams,
              timing: TimingConfig, *, device=None, resume=None,
              fault_plan=None, report=None) -> List[Dict]:
    """Run the whole characterization suite as one batched device call.

    Parameters
    ----------
    spec : SweepSpec
        The (workload x footprint x policy x cpu) grid.
    cache : CacheParams
        Cache geometry.
    timing : TimingConfig
        Per-tier timing model closing the Picard fixed point.
    device : str or torch.device, optional
        Where traces are built and simulated; ``None`` means the CUDA
        card (raises when there is none).
    resume, fault_plan, report
        Not ported yet (ROADMAP queue 1, item 8): anything but ``None``
        raises ``NotImplementedError``.

    Returns
    -------
    list of dict
        One row per (workload, footprint, policy, cpu) — the
        `RunResult.row()` schema plus the raw `stats` counters, a
        `workload` label and the STREAM `kernel`.
    """
    results = sweep_results(spec, cache, timing, device=device,
                            resume=resume, fault_plan=fault_plan,
                            report=report)
    rows: List[Dict] = []
    i = 0
    for dist in spec.distributions_axis:
        for _sp in spec.sampling_axis:
            for _tr in spec.tiering_axis:
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
                        if spec.tiering:
                            row["tiering"] = "static"
                        if spec.sampling:
                            row["sampling"] = "exact"
                        if spec.distributions:
                            row["distribution"] = (
                                "off" if dist is None else dist.label)
                        rows.append(row)
                        i += 1
    return rows


def sweep_results(spec: SweepSpec, cache: cache_mod.CacheParams,
                  timing: TimingConfig, *, device=None, resume=None,
                  fault_plan=None, report=None) -> List[RunResult]:
    """`run_sweep` returning full RunResults (row order identical).

    One device call simulates every (workload, footprint, policy) cell.
    Each cell's stats are then broadcast across the CPU-model axis (CPU
    models never touch cache state) and the Picard timing fixed point
    closes vectorized on the host.

    Returns
    -------
    list of RunResult
        One per grid row, ordered distribution-major, then workload,
        footprint, policy, cpu.
    """
    _check_knobs(resume, fault_plan, report)
    spec.check_ported()
    # the binary DRAM/CXL path: two targets, whatever `cache` says
    p = dataclasses.replace(cache, n_targets=2)
    batch, cell_rows = build_sweep_batch(spec, cache, device=device)
    stats, _ = run_traces(p, batch.addr, batch.is_write, core=None,
                          tier=batch.tier, backend=spec.backend)
    stats = stats.cpu().numpy().astype(np.int64)
    rows_cpus = [wl.cpu_for(cpu) for wl, _k, _pol in spec.sim_cells
                 for cpu in spec.cpus]
    rows_stats = np.repeat(stats[cell_rows], len(spec.cpus), axis=0)
    out: List[RunResult] = []
    # the distributions axis only re-closes the timing fixed point — the
    # device call above ran once for every entry
    for dist in spec.distributions_axis:
        results = time_batch(timing, rows_cpus, rows_stats, dist=dist)
        # explicit all-None tiering/sampling axes repeat the static block
        # per entry — independent copies, so no rows share mutable state
        out.extend(results)
        n_copies = len(spec.sampling_axis) * len(spec.tiering_axis)
        for _ in range(n_copies - 1):
            out.extend(_copy_result(r) for r in results)
    return out


def _copy_result(r: RunResult) -> RunResult:
    """Independent copy of a RunResult (no shared mutable containers)."""
    return dataclasses.replace(
        r, stats=dict(r.stats), miss_rates=dict(r.miss_rates),
        achieved_gbps=dict(r.achieved_gbps),
        loaded_latency_ns=dict(r.loaded_latency_ns),
        lat_percentiles=(None if r.lat_percentiles is None else
                         {k: dict(v) for k, v in r.lat_percentiles.items()}))
