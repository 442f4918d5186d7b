"""Sharded + streaming sweep executors: past one batch, past one memory.

The batched trace engine (:mod:`repro_torch.core.engine`) simulates a
whole characterization grid in ONE kernel call — which keeps every stacked
trace resident at once and runs each row's trace in one launch.  This
module scales the same engine along both axes without changing a single
simulated number:

**Sharding** (`Mesh`)
    The flattened sweep grid — tiering x topologies x workloads x
    footprints x policies, already deduplicated into batch rows by the
    engine's batch builders — is partitioned row-wise into shards.
    Shards are padded with all-sentinel rows so every shard has the same
    shape, placed round-robin on the mesh's devices and launched one
    after another on the device's current stream without a host wait;
    the results are gathered once at the end.  On one card the shards
    run as sequential launches on one stream.  Rows are simulated
    independently (no kernel carries cross-row state), so sharded stats
    are **bitwise-equal** to the one-call path, dynamic-tiering rows
    included.

**Streaming** (`stream_chunk` / :func:`stream_traces`)
    The trace axis is cut into fixed-size segments threaded through the
    carry (`engine.init_batch_carry` / `engine.run_batch_segment`;
    dynamic-tiering rows thread the full tierer carry — page map, epoch
    counters, migration totals, slot index — via
    `tiering_dyn.run_dynamic_segment`).  Only one segment plus the carry
    need be resident, so trace lengths beyond device memory run in
    bounded memory.  Segmentation is bitwise-neutral (integer state
    machine, exact carry hand-off).

**Resilience** (:class:`ResilientExecutor`)
    The same segment loop, one shard at a time, with per-shard carry
    checkpoints, bounded retries, OOM halving and host eviction
    (:mod:`repro_torch.core.resilience`).

``mesh=None`` with ``stream_chunk=None`` is *the* one-call path (the
executor seam defaults to `engine.LocalExecutor`).  The JAX package maps
shards over its devices with ``pmap``; here a shard is a plain launch of
the engine's kernels on its device.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core import engine
from repro_torch.core import resilience
from repro_torch.core import tiering_dyn
from repro_torch.core.engine import SENTINEL, SweepSpec, TraceBatch
from repro_torch.core.machine import RunResult
from repro_torch.core.resilience import (CheckpointPolicy, FaultPlan,  # noqa: F401
                                         RetryPolicy, RunReport,
                                         SweepCheckpointer)
from repro_torch.core.timing import TimingConfig
from repro_torch.kernels.cache_sim import check_chunk, pad_trace
from repro_torch.runtime.fault import FleetState

_UNBOUNDED_PAGES = tiering_dyn.UNBOUNDED_PAGES


# ---------------------------------------------------------------------------
# Mesh: where the shards go
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Mesh:
    """Row-partition plan for a sweep batch.

    Parameters
    ----------
    n_shards : int
        How many row-shards to cut the batch into.  ``0`` (default) =
        one shard per device.  More shards than devices are placed
        round-robin, so on one card a multi-shard mesh bounds the rows per
        launch and runs the shards one after another.
    devices : tuple of torch.device, optional
        The devices to place shards on; ``None`` = every CUDA device
        (``torch.cuda.device_count()``), or the CPU when the sweep itself
        runs there.  Naming a device twice gives two logical hosts on one
        device (the resilient executor evicts hosts, not devices).

    Notes
    -----
    Shards never change results: rows are simulated independently, so
    any partition yields bitwise-identical stats.
    """
    n_shards: int = 0
    devices: Optional[Tuple] = None

    def __post_init__(self) -> None:
        if self.n_shards < 0:
            raise ValueError(f"n_shards must be >= 0, got {self.n_shards}")

    def resolve_devices(self, like=None) -> Tuple[torch.device, ...]:
        """The mesh's devices: the named ones, else every CUDA device.

        `like` is the device the sweep's batch lies on; a CPU batch with
        no named devices stays on the CPU.  Raises when CUDA devices are
        needed and there are none.
        """
        if self.devices:
            return tuple(torch.device(d) for d in self.devices)
        if like is not None and torch.device(like).type == "cpu":
            return (torch.device("cpu"),)
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device is available for the mesh; name its "
                "devices (Mesh(devices=(torch.device('cpu'),))) or run the "
                "sweep with device='cpu'")
        return tuple(torch.device("cuda", i) for i in range(n))

    def shard_count(self, b: int, like=None) -> int:
        """Shards actually cut for a ``b``-row batch (never more than b)."""
        n = self.n_shards if self.n_shards > 0 \
            else len(self.resolve_devices(like))
        return max(1, min(n, b))


def auto_mesh() -> Mesh:
    """One shard per device — the default multi-device layout."""
    return Mesh()


def _as_mesh(mesh) -> Optional[Mesh]:
    """Accept `Mesh`, an int shard count, or None."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, int):
        return Mesh(n_shards=mesh)
    raise TypeError(f"mesh must be a Mesh, int, or None, got {type(mesh)}")


# ---------------------------------------------------------------------------
# Shard arithmetic
# ---------------------------------------------------------------------------
def shard_plan(b: int, n_shards: int) -> Tuple[int, int]:
    """Rows-per-shard and padded row count for ``b`` rows over shards.

    Returns ``(rows_per_shard, b_padded)`` with ``b_padded = n_shards *
    rows_per_shard >= b``; the ``b_padded - b`` filler rows are
    all-sentinel traces whose stats are identically zero.
    """
    if b < 1:
        raise ValueError("empty batch")
    rows = -(-b // n_shards)
    return rows, rows * n_shards


def _pad_rows(x, b_to: int, fill: int):
    """Append `fill`-valued rows so the (B, ...) tensor or array has `b_to`
    rows (a tensor stays on its device, an array stays on the host)."""
    b = x.shape[0]
    if b == b_to:
        return x
    if isinstance(x, torch.Tensor):
        pad = torch.full((b_to - b,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        return torch.cat([x, pad], dim=0)
    x = np.asarray(x)
    return np.concatenate([x, np.full((b_to - b,) + x.shape[1:], fill,
                                      x.dtype)], axis=0)


def trace_working_set_bytes(b: int, n: int, fields: int = 4,
                            itemsize: int = 4) -> int:
    """Device bytes a resident (B, N) stacked trace occupies.

    Four int32 streams per row (addr, is_write, core, tier).  The
    streaming path's working set is ``trace_working_set_bytes(b,
    segment)`` plus the carry, regardless of total trace length.
    """
    return b * n * fields * itemsize


def _static_fields(batch: TraceBatch, b_pad: int):
    """The batch's four (B, N) int32 streams, rows padded to `b_pad`
    (sentinel addresses, zero fields)."""
    addr = torch.as_tensor(batch.addr).to(torch.int32)
    z = torch.zeros_like(addr)
    others = [z if a is None else
              torch.as_tensor(a, device=addr.device).to(torch.int32)
              for a in (batch.is_write, batch.core, batch.tier)]
    return ([_pad_rows(addr, b_pad, SENTINEL)]
            + [_pad_rows(a, b_pad, 0) for a in others])


def _dynamic_scalars(tb, b_pad: int) -> dict:
    """The epoch program's per-row inputs, padded to `b_pad` rows.

    Padding rows are inert static rows: flag 0, budget 0, a one-page map
    filled with 1, threshold and period 1, unbounded capacities, zeros
    elsewhere (the sampling scalars' zeros measure every slot; padding
    rows never reach the results anyway).
    """
    fills = {"dyn_flag": 0, "page_map0": 1, "n_pages": 1, "budget": 0,
             "threshold": 1, "period": 1, "dram_cap": _UNBOUNDED_PAGES,
             "ssd_tid": 0, "cxl_cap": _UNBOUNDED_PAGES,
             "page_target_lines": 0, "s_warm": 0, "s_meas": 0, "s_per": 0}
    return {k: _pad_rows(getattr(tb, k), b_pad, fill)
            for k, fill in fills.items()}


def _to(x, device):
    """A row slice on `device` (host arrays stay host arrays)."""
    return x.to(device) if isinstance(x, torch.Tensor) else x


# ---------------------------------------------------------------------------
# Streaming: segments through the carry
# ---------------------------------------------------------------------------
def segment_batch(batch_or_arrays, segment: int
                  ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Slice a resident stacked trace into (B, segment) streaming tuples.

    Accepts a :class:`~repro_torch.core.engine.TraceBatch` or an ``(addr,
    is_write, core, tier)`` tuple of (B, N) tensors or arrays; the final
    slice is sentinel-padded to the full segment length (inert).  This is
    the parity-testing source — a real beyond-memory run generates each
    segment on the fly instead (any iterable of tuples works, see
    :func:`stream_traces`).
    """
    if isinstance(batch_or_arrays, TraceBatch):
        arrays = (batch_or_arrays.addr, batch_or_arrays.is_write,
                  batch_or_arrays.core, batch_or_arrays.tier)
    else:
        arrays = batch_or_arrays
    addr = torch.as_tensor(arrays[0]).to(torch.int32)
    n = addr.shape[1]
    rest = [torch.zeros_like(addr) if a is None else
            torch.as_tensor(a, device=addr.device).to(torch.int32)
            for a in arrays[1:]]
    for s in range(0, n, segment):
        e = min(s + segment, n)
        yield pad_trace(segment, addr[:, s:e], *(a[:, s:e] for a in rest))


def stream_traces(p: cache_mod.CacheParams,
                  source: Iterable[Tuple], *,
                  checkpoint=None,
                  report: Optional[RunReport] = None,
                  backend: Optional[str] = None,
                  chunk: int = 512,
                  device=None,
                  carry=None,
                  ) -> Tuple[torch.Tensor, cache_mod.CacheState]:
    """Consume a trace as a stream of fixed-size segments, bounded memory.

    Parameters
    ----------
    p : CacheParams
        Cache geometry.
    source : iterable of (addr, is_write, core, tier) tuples
        Each a (B, n_seg) int32 tensor or array (``None`` fields become
        zeros; ``addr == SENTINEL`` marks padding).  The source may
        *generate* segments lazily, which is what lets the total trace
        length exceed device memory: only one segment plus the carry is
        resident.
    checkpoint : CheckpointPolicy, path, or None
        Persist the carry every
        :attr:`~repro_torch.core.resilience.CheckpointPolicy.
        every_segments` consumed segments; a rerun against the same
        directory (with a deterministically regenerable ``source``)
        **fast-forwards** past the already-completed segments without a
        single kernel call and produces bitwise-identical results.
    report : RunReport, optional
        Event sink for ``resume`` / ``checkpoint`` records.
    backend : str, optional
        ``None`` (follow the device), ``'reference'`` or ``'cuda'``: both
        thread the same ``(l1p, l2p, stats, t)`` carry, bitwise-equal.
    chunk : int
        The JAX package's Pallas grid step: checked (>= 1) and ignored.
    device : str or torch.device, optional
        Where segments are simulated; ``None`` means the device of the
        first segment's address tensor (the CUDA card for host arrays).
    carry : tuple, optional
        Continue from this ``(l1p, l2p, stats, t)`` carry (for instance
        one converted from the JAX package's stream by
        :func:`repro_torch.convert.carry_from_numpy`) instead of a fresh
        one.

    Returns
    -------
    (stats, state)
        Exactly :func:`repro_torch.core.engine.run_traces`'s return — and
        bitwise-equal to it on the concatenated trace.
    """
    check_chunk(chunk)
    policy = resilience.as_checkpoint_policy(checkpoint)
    ckpt: Optional[SweepCheckpointer] = None
    started = False
    done = 0
    idx = 0
    for seg in source:
        addr = seg[0]
        if device is None:
            device = (addr.device if isinstance(addr, torch.Tensor)
                      else engine.resolve_device(None))
        addr = torch.as_tensor(addr).to(device=device, dtype=torch.int32)
        if not started:
            started = True
            if carry is None:
                carry = engine.init_batch_carry(p, addr.shape[0],
                                                device=device)
            carry = tuple(x.to(device) for x in carry)
            if policy is not None:
                ckpt = SweepCheckpointer(policy)
                ckpt.verify_meta({"kind": "stream",
                                  "b": int(addr.shape[0]),
                                  "n_targets": p.n_targets})
                got = ckpt.restore(0, {"carry": carry}, report=report)
                if got is not None:
                    done, tree = got
                    carry = tree["carry"]
        idx += 1
        if idx <= done:
            continue        # fast-forward: replayed segments cost no call
        fields = [torch.zeros_like(addr) if (len(seg) <= i or seg[i] is None)
                  else torch.as_tensor(seg[i]).to(device=device,
                                                  dtype=torch.int32)
                  for i in (1, 2, 3)]
        carry = engine.run_batch_segment(p, carry, addr, *fields,
                                         backend=backend)
        if ckpt is not None and idx % policy.every_segments == 0:
            ckpt.save(0, idx, {"carry": resilience.host_tree(carry)},
                      report=report)
    if not started:
        raise ValueError("empty trace source")
    if ckpt is not None:
        ckpt.wait()
    l1p, l2p, stats, _ = carry
    return stats, cache_mod.unpack_state(l1p, l2p)


# ---------------------------------------------------------------------------
# The sharded executor (plugs into engine.run_sweep's executor seam)
# ---------------------------------------------------------------------------
class ShardedExecutor:
    """Execute a built sweep batch sharded across a mesh and/or streamed.

    Drop-in for :class:`repro_torch.core.engine.LocalExecutor` — same
    ``run_static`` / ``run_dynamic`` contract, bitwise-identical
    counters, different execution strategy:

    * rows are cut into ``mesh.shard_count(B)`` equal shards (sentinel
      padding rows square off ragged grids),
    * each shard is launched on its device (round-robin over the mesh)
      without a host wait; the final gather waits once,
    * with ``stream_chunk``, every shard's trace streams through the
      carry in ``stream_chunk``-sized segments (dynamic-tiering rows
      stream whole epoch slots: the chunk is rounded to the sweep's slot
      length).

    Parameters
    ----------
    mesh : Mesh, int, or None
        Row partition; int = shard count; ``None`` = no sharding.
    stream_chunk : int, optional
        Trace elements per streamed segment; ``None`` = resident traces.
    """

    def __init__(self, mesh=None, stream_chunk: Optional[int] = None):
        if stream_chunk is not None and stream_chunk < 1:
            raise ValueError(
                f"stream_chunk must be >= 1, got {stream_chunk}")
        self.mesh = _as_mesh(mesh)
        self.stream_chunk = stream_chunk

    def _plan(self, b: int, like):
        mesh = self.mesh or Mesh(n_shards=1)
        devices = mesh.resolve_devices(like)
        n_shards = mesh.shard_count(b, like)
        return devices, n_shards, shard_plan(b, n_shards)

    # -- static (flat-scan) rows -------------------------------------------
    def run_static(self, p: cache_mod.CacheParams, batch: TraceBatch,
                   *, backend: Optional[str], chunk: int) -> np.ndarray:
        """Each shard through `engine.run_traces` (``segment=`` when
        streamed: the kernel's segment path threads the packed carry)."""
        b = batch.batch
        home = torch.as_tensor(batch.addr).device
        devices, n_shards, (bp, b_pad) = self._plan(b, home)
        fields = _static_fields(batch, b_pad)
        outs = []
        for i in range(n_shards):
            rows = slice(i * bp, (i + 1) * bp)
            dev = devices[i % len(devices)]    # round-robin shard placement
            stats, _ = engine.run_traces(
                p, *(a[rows].to(dev) for a in fields), backend=backend,
                chunk=chunk, segment=self.stream_chunk)
            outs.append(stats.to(home))
        stats = torch.cat(outs, dim=0).cpu().numpy()     # the one wait
        return stats[:b].astype(np.int64)

    # -- dynamic (epoch-structured) rows -----------------------------------
    def run_dynamic(self, p: cache_mod.CacheParams, tb,
                    *, slot_len: int, k_max: int,
                    backend: Optional[str] = None
                    ) -> tiering_dyn.DynOutputs:
        """Shard the epoch program row-wise; stream whole epoch slots.

        Padding rows are inert static rows (all-sentinel trace, zero
        budget), so the padded program's real rows are bitwise-equal to
        the one-call path; per-row outputs are concatenated and the
        padding dropped.  ``stream_chunk`` streams ``max(1, chunk //
        slot_len)`` slots per segment — the tierer carry (page map,
        counters, migration totals, slot index) threads between segments.
        """
        b = tb.batch.batch
        home = torch.as_tensor(tb.batch.addr).device
        devices, n_shards, (bp, b_pad) = self._plan(b, home)
        seg_slots = (None if self.stream_chunk is None
                     else max(1, self.stream_chunk // slot_len))
        fields = _static_fields(tb.batch, b_pad)
        scal = _dynamic_scalars(tb, b_pad)
        outs = []
        for i in range(n_shards):
            rows = slice(i * bp, (i + 1) * bp)
            dev = devices[i % len(devices)]    # round-robin shard placement
            out = tiering_dyn.run_dynamic(
                p, *(a[rows].to(dev) for a in fields), slot_len=slot_len,
                k_max=k_max, segment_slots=seg_slots, backend=backend,
                **{k: _to(v[rows], dev) for k, v in scal.items()})
            outs.append(tiering_dyn.DynOutputs(*(x.to(home) for x in out)))
        return tiering_dyn.DynOutputs(*(
            torch.cat([getattr(o, f) for o in outs], dim=0)[:b]
            for f in tiering_dyn.DynOutputs._fields))


# ---------------------------------------------------------------------------
# The resilient executor: checkpoints, retries, degradation, eviction
# ---------------------------------------------------------------------------
class ResilientExecutor:
    """Fault-tolerant sweep execution on the same executor seam.

    Drop-in for :class:`~repro_torch.core.engine.LocalExecutor` /
    :class:`ShardedExecutor` — same ``run_static`` / ``run_dynamic``
    contract, bitwise-identical counters — that survives the failure modes
    a long sweep meets:

    * **crash / kill** — every shard's carry is checkpointed every
      ``checkpoint.every_segments`` completed segments (atomic, async,
      keep-K via :class:`~repro_torch.core.resilience.SweepCheckpointer`);
      a rerun against the same directory restores each shard's newest
      carry and fast-forwards past the completed segments without a
      single kernel call;
    * **transient errors** — each segment dispatch retries with
      exponential backoff (:class:`~repro_torch.core.resilience.
      RetryPolicy`), raising :class:`~repro_torch.core.resilience.
      ResilienceError` only when the budget is exhausted (a real CUDA
      error is fatal, see :func:`~repro_torch.core.resilience.
      classify_failure`);
    * **OOM** — the failing shard's segments are halved (re-dispatched
      as two half-width calls from the intact pre-segment carry — the
      kernels' wrappers never write their input carry — and again on
      repeat) up to ``retry.max_halvings`` times; segment boundaries are
      bitwise-neutral, so degraded rows are identical;
    * **device loss** — the losing logical host is evicted from a
      :class:`repro_torch.runtime.fault.FleetState` and the shard requeues
      onto the next surviving device.

    Shards run one after another (recovery needs per-shard carries),
    which changes *strategy*, never *results*.  With no checkpoint and no
    fault plan the static path falls through to plain sharded dispatch —
    the recovery scaffolding costs nothing when there is nothing to
    recover.

    Every recovery action lands in :attr:`report`; injected failures come
    from an optional :class:`~repro_torch.core.resilience.FaultPlan`,
    making all of the above deterministic and testable on one host.

    Parameters
    ----------
    mesh : Mesh, int, or None
        Row partition (also the logical host pool for eviction);
        ``None`` = one shard.
    stream_chunk : int, optional
        Trace elements per streamed segment — also the checkpoint and
        recovery granularity.  ``None`` = one segment per trace
        (checkpoint only at completion).
    checkpoint : CheckpointPolicy, path, or None
        Where/how often to persist carries; a bare path uses the policy
        defaults.  ``None`` disables persistence (retry/OOM recovery
        still work from in-memory carries).
    fault_plan : FaultPlan, optional
        Deterministic failure injection (tests, chaos drills).
    retry : RetryPolicy, optional
        Backoff and degradation bounds.
    report : RunReport, optional
        Event sink; a fresh one is created when omitted.
    sleeper : callable
        Injectable ``time.sleep`` (tests pass a recorder).
    """

    def __init__(self, mesh=None, stream_chunk: Optional[int] = None, *,
                 checkpoint=None, fault_plan: Optional[FaultPlan] = None,
                 retry: Optional[RetryPolicy] = None,
                 report: Optional[RunReport] = None,
                 sleeper=time.sleep):
        if stream_chunk is not None and stream_chunk < 1:
            raise ValueError(
                f"stream_chunk must be >= 1, got {stream_chunk}")
        self.mesh = _as_mesh(mesh)
        self.stream_chunk = stream_chunk
        self.checkpoint = resilience.as_checkpoint_policy(checkpoint)
        self.fault_plan = fault_plan
        self.retry = retry if retry is not None else RetryPolicy()
        self.report = report if report is not None else RunReport()
        self.sleeper = sleeper

    # -- shared recovery machinery -----------------------------------------
    def _checkpointer(self, meta: dict) -> Optional[SweepCheckpointer]:
        if self.checkpoint is None:
            return None
        ckpt = SweepCheckpointer(self.checkpoint)
        ckpt.verify_meta(meta)
        return ckpt

    def _fleet_devices(self, like):
        mesh = self.mesh or Mesh(n_shards=1)
        devices = mesh.resolve_devices(like)
        return mesh, devices, FleetState(n_hosts=len(devices))

    def _shard_device(self, shard: int, fleet: FleetState, devices):
        live = fleet.live_hosts()
        if not live:
            raise resilience.ResilienceError(
                "no surviving devices: every logical host was evicted")
        return live[shard % len(live)], devices[live[shard % len(live)]]

    def _dispatch(self, shard: int, segment: int, width: int,
                  fleet: FleetState, devices, call):
        """Run one kernel call under the full recovery policy.

        ``call()`` is re-invoked on transient errors (bounded retry,
        exponential backoff) and after device eviction; OOM and crash
        propagate to the caller (the segment loop owns degradation, the
        user owns resume).  Returns ``call()``'s value.
        """
        attempts = 0
        while True:
            try:
                if self.fault_plan is not None:
                    self.fault_plan.check(shard, segment, width=width,
                                          report=self.report,
                                          sleeper=self.sleeper)
                return call()
            except Exception as exc:     # RunKilled (BaseException) flies
                kind = resilience.classify_failure(exc)
                if kind == "fatal":
                    raise
                if kind == "oom":
                    raise               # the segment loop halves + reruns
                if kind == "device_lost":
                    host, _ = self._shard_device(shard, fleet, devices)
                    fleet.evict(host, "device_lost",
                                log=self.report.events)
                    # requeue onto a survivor; does not spend a retry
                    self._shard_device(shard, fleet, devices)
                    continue
                if attempts >= self.retry.max_retries:
                    raise resilience.ResilienceError(
                        f"retry budget exhausted ({self.retry.max_retries}"
                        f" retries) at shard {shard}, segment {segment}"
                    ) from exc
                backoff = self.retry.backoff(attempts)
                self.report.add("retry", shard=shard, segment=segment,
                                attempt=attempts + 1, backoff_s=backoff,
                                error=str(exc))
                self.sleeper(backoff)
                attempts += 1

    def _run_segment_degraded(self, shard: int, segment: int, carry,
                              halvings: List[int], fleet, devices,
                              units: int, unit_elems: int, advance):
        """One top-level segment with OOM degradation.

        ``advance(carry, lo, hi)`` advances the carry over the
        ``[lo, hi)`` sub-slice of the segment's ``units`` (trace columns
        for static rows, epoch slots for dynamic rows — ``unit_elems``
        trace elements per unit).  On OOM the whole segment re-runs from
        the intact pre-segment carry in twice as many pieces —
        sub-splitting is bitwise-neutral, so the degraded result is
        identical.  The per-shard halving level sticks (later segments
        stay degraded).
        """
        seg_carry = carry
        while True:
            pieces = 1 << halvings[shard]
            step = max(1, -(-units // pieces))
            try:
                carry = seg_carry
                for lo in range(0, units, step):
                    hi = min(lo + step, units)
                    carry = self._dispatch(
                        shard, segment, (hi - lo) * unit_elems, fleet,
                        devices,
                        lambda c=carry, lo=lo, hi=hi: advance(c, lo, hi))
                return carry
            except Exception as exc:
                if resilience.classify_failure(exc) != "oom":
                    raise
                if step <= 1 or halvings[shard] >= self.retry.max_halvings:
                    raise resilience.ResilienceError(
                        f"OOM persists at minimum segment width (shard "
                        f"{shard}, segment {segment}, "
                        f"{halvings[shard]} halvings)") from exc
                halvings[shard] += 1
                self.report.add("degrade", shard=shard, segment=segment,
                                halvings=halvings[shard],
                                pieces=1 << halvings[shard])

    # -- static (flat-scan) rows -------------------------------------------
    def run_static(self, p: cache_mod.CacheParams, batch: TraceBatch,
                   *, backend: Optional[str], chunk: int) -> np.ndarray:
        if self.checkpoint is None and self.fault_plan is None:
            # nothing to checkpoint, nothing to inject: plain sharded
            # dispatch (bitwise-equal — the carry loop below would only
            # add per-segment host round-trips)
            return ShardedExecutor(
                mesh=self.mesh, stream_chunk=self.stream_chunk
            ).run_static(p, batch, backend=backend, chunk=chunk)
        b, n = batch.batch, batch.length
        home = torch.as_tensor(batch.addr).device
        mesh, devices, fleet = self._fleet_devices(home)
        n_shards = mesh.shard_count(b, home)
        bp, b_pad = shard_plan(b, n_shards)
        seg = min(self.stream_chunk or n, n)
        fields = pad_trace(seg, *_static_fields(batch, b_pad))
        n_segments = fields[0].shape[1] // seg
        ckpt = self._checkpointer({
            "kind": "static", "b": b, "n": n, "n_shards": n_shards,
            "segment": seg, "n_targets": p.n_targets})
        halvings = [0] * n_shards
        outs: List[torch.Tensor] = []
        for shard in range(n_shards):
            rows = slice(shard * bp, (shard + 1) * bp)
            sh = [a[rows] for a in fields]
            carry = engine.init_batch_carry(p, bp, device=home)
            start = 0
            if ckpt is not None:
                got = ckpt.restore(shard, {"carry": carry},
                                   report=self.report)
                if got is not None:
                    start, tree = got
                    carry = tree["carry"]

            def advance(c, lo, hi, sh=sh, shard=shard, s0=0):
                # placement follows the shard's current host (requeued
                # shards land on a survivor); the wrapper never writes
                # `c`, so a failed call leaves it intact for the retry
                _, dev = self._shard_device(shard, fleet, devices)
                args = [a[:, s0 + lo:s0 + hi].to(dev) for a in sh]
                return engine.run_batch_segment(
                    p, tuple(x.to(dev) for x in c), *args, backend=backend)

            for si in range(start, n_segments):
                carry = self._run_segment_degraded(
                    shard, si, carry, halvings, fleet, devices, seg, 1,
                    functools.partial(advance, s0=si * seg))
                done = si + 1
                if ckpt is not None and (
                        done % self.checkpoint.every_segments == 0
                        or done == n_segments):
                    ckpt.save(shard, done,
                              {"carry": resilience.host_tree(carry)},
                              report=self.report)
            outs.append(carry[2].to(home))
        if ckpt is not None:
            ckpt.wait()
        stats = torch.cat(outs, dim=0).cpu().numpy()
        return stats[:b].astype(np.int64)

    # -- dynamic (epoch-structured) rows -----------------------------------
    def run_dynamic(self, p: cache_mod.CacheParams, tb,
                    *, slot_len: int, k_max: int,
                    backend: Optional[str] = None
                    ) -> tiering_dyn.DynOutputs:
        b = tb.batch.batch
        home = torch.as_tensor(tb.batch.addr).device
        mesh, devices, fleet = self._fleet_devices(home)
        n_shards = mesh.shard_count(b, home)
        bp, b_pad = shard_plan(b, n_shards)
        # padding rows are inert static rows — same fills as the sharded
        # executor, so padded programs share its invariance
        a3, w3, c3, t3, pmap0, scalars, k_max, count_bound = \
            tiering_dyn.prep_dynamic_inputs(
                *_static_fields(tb.batch, b_pad), slot_len=slot_len,
                k_max=k_max, **_dynamic_scalars(tb, b_pad))
        e = a3.shape[1]
        seg_slots = (e if self.stream_chunk is None
                     else min(max(1, self.stream_chunk // slot_len), e))
        n_segments = -(-e // seg_slots)
        nstats = cache_mod.nstats(p.n_targets)
        ckpt = self._checkpointer({
            "kind": "dynamic", "b": b, "slots": e, "slot_len": slot_len,
            "n_shards": n_shards, "segment_slots": seg_slots,
            "n_targets": p.n_targets})
        halvings = [0] * n_shards
        outs = []
        for shard in range(n_shards):
            rows = slice(shard * bp, (shard + 1) * bp)
            xs = [a[rows] for a in (a3, w3, c3, t3)]
            sc = [s[rows] for s in scalars]
            carry = tiering_dyn.init_dyn_carry(p, pmap0[rows])
            # host accumulators keep the checkpoint tree shape-stable:
            # completed segments fill their slice, the rest stays zero
            acc = resilience.dyn_accumulators(bp, e, nstats)
            start = 0
            if ckpt is not None:
                got = ckpt.restore(shard, {"carry": carry, **acc},
                                   report=self.report)
                if got is not None:
                    start, tree = got
                    carry = tree["carry"]
                    acc = {k: tree[k] for k in acc}

            def advance(c, lo, hi, xs=xs, sc=sc, shard=shard, s0=0,
                        acc=acc):
                _, dev = self._shard_device(shard, fleet, devices)
                args = [a[:, s0 + lo:s0 + hi].to(dev) for a in xs]
                c, slots, snaps, meas = tiering_dyn.run_dynamic_segment(
                    p, k_max, count_bound, tuple(x.to(dev) for x in c),
                    *args, *(x.to(dev) for x in sc), backend=backend)
                sl = slice(s0 + lo, s0 + hi)
                acc["slots"][:, sl] = slots.cpu().numpy()
                acc["snaps"][:, sl] = snaps.cpu().numpy()
                acc["meas"][:, sl] = meas.cpu().numpy()
                return c

            for si in range(start, n_segments):
                s0 = si * seg_slots
                width = min(seg_slots, e - s0)
                carry = self._run_segment_degraded(
                    shard, si, carry, halvings, fleet, devices, width,
                    slot_len, functools.partial(advance, s0=s0))
                done = si + 1
                if ckpt is not None and (
                        done % self.checkpoint.every_segments == 0
                        or done == n_segments):
                    ckpt.save(shard, done,
                              {"carry": resilience.host_tree(carry),
                               **acc},
                              report=self.report)
            _, _, stats, _, pmap_f, _, mig_rd, mig_wr, _ = carry
            outs.append(tiering_dyn.DynOutputs(
                *(x.cpu() for x in (stats, pmap_f, mig_rd, mig_wr)),
                *(torch.from_numpy(acc[k]) for k in ("slots", "snaps",
                                                     "meas"))))
        if ckpt is not None:
            ckpt.wait()
        return tiering_dyn.DynOutputs(*(
            torch.cat([getattr(o, f) for o in outs], dim=0)[:b]
            for f in tiering_dyn.DynOutputs._fields))


# ---------------------------------------------------------------------------
# Facade: the sharded/streaming twins of engine.run_sweep
# ---------------------------------------------------------------------------
def run_sweep(spec: SweepSpec, cache: cache_mod.CacheParams,
              timing: TimingConfig, *, mesh=None,
              stream_chunk: Optional[int] = None,
              chunk: int = 512, resume=None,
              fault_plan: Optional[FaultPlan] = None,
              retry: Optional[RetryPolicy] = None,
              report: Optional[RunReport] = None,
              device=None) -> List[dict]:
    """`engine.run_sweep` with sharding, streaming and resilience knobs.

    Parameters
    ----------
    spec, cache, timing, chunk, device
        As in :func:`repro_torch.core.engine.run_sweep` (``device=None``
        is the CUDA card).
    mesh : Mesh, int, or None
        Row partition across devices.  ``None`` (with ``stream_chunk``
        also ``None``) is **exactly** the one-call path — same executor,
        same rows.
    stream_chunk : int, optional
        Stream every trace through the carry in segments of this many
        accesses (bounded device memory per call).
    resume : CheckpointPolicy, path, or None
        Checkpoint directory for the :class:`ResilientExecutor`: carries
        persist every :attr:`~repro_torch.core.resilience.
        CheckpointPolicy.every_segments` segments, and a rerun against
        the same directory fast-forwards past completed segments and
        shards — with rows bitwise-equal to an uninterrupted run.
    fault_plan : FaultPlan, optional
        Deterministic failure injection; any of the resilience knobs
        (``resume`` / ``fault_plan`` / ``retry`` / ``report``) selects
        the :class:`ResilientExecutor`.
    retry : RetryPolicy, optional
        Retry/backoff/degradation bounds.
    report : RunReport, optional
        Event sink for retries, resumes, degradations, checkpoints.

    Returns
    -------
    list of dict
        Identical rows — schema and values — to `engine.run_sweep` for
        any mesh/chunk/resilience choice.
    """
    executor = _executor_for(mesh, stream_chunk, resume=resume,
                             fault_plan=fault_plan, retry=retry,
                             report=report)
    return engine.run_sweep(spec, cache, timing, chunk=chunk,
                            executor=executor, device=device)


def sweep_results(spec: SweepSpec, cache: cache_mod.CacheParams,
                  timing: TimingConfig, *, mesh=None,
                  stream_chunk: Optional[int] = None,
                  chunk: int = 512, resume=None,
                  fault_plan: Optional[FaultPlan] = None,
                  retry: Optional[RetryPolicy] = None,
                  report: Optional[RunReport] = None,
                  device=None) -> List[RunResult]:
    """`engine.sweep_results` with sharding/streaming/resilience knobs
    (see :func:`run_sweep`)."""
    executor = _executor_for(mesh, stream_chunk, resume=resume,
                             fault_plan=fault_plan, retry=retry,
                             report=report)
    return engine.sweep_results(spec, cache, timing, chunk=chunk,
                                executor=executor, device=device)


def _executor_for(mesh, stream_chunk, resume=None, fault_plan=None,
                  retry=None, report=None):
    if any(k is not None for k in (resume, fault_plan, retry, report)):
        return ResilientExecutor(mesh=mesh, stream_chunk=stream_chunk,
                                 checkpoint=resume, fault_plan=fault_plan,
                                 retry=retry, report=report)
    if mesh is None and stream_chunk is None:
        return None                     # engine.LocalExecutor
    return ShardedExecutor(mesh=mesh, stream_chunk=stream_chunk)
