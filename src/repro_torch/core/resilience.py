"""Fault-tolerant sweep runtime: checkpoints, retries, fault injection.

Long sampled simulations and serving co-simulation sweeps would die on
the first transient device error or OOM if the batched engine
(:mod:`repro_torch.core.engine`) and the sharded executor
(:mod:`repro_torch.core.distribute`) ran open-loop.  This module supplies
the primitives the :class:`repro_torch.core.distribute.ResilientExecutor`
composes into a recoverable run, under the standing invariant: **a
run that is killed, degraded, or retried produces bitwise-identical
rows to an uninterrupted run** (test- and golden-enforced).  That holds
because every recovery action is expressed in terms the engine already
proved bitwise-neutral — segment boundaries move (OOM degradation
sub-splits a segment), segments re-run from an exact carry (retry), or
the carry is reloaded from disk (resume) — never in terms that touch
the per-access arithmetic.  The carry is backend-agnostic: the CUDA
segment kernels take and return the same ``(l1p, l2p, stats, t)`` /
epoch-carry tuples as their plain versions, so a checkpoint written under
one backend resumes under the other.

The pieces
----------
:class:`FaultPlan`
    Deterministic, seeded fault injector.  Faults address *dispatch
    sites* — ``(shard, segment)`` — and fire a bounded number of times,
    so every recovery path (transient retry, OOM halving, device
    eviction, crash + resume) is testable on one CPU host with no real
    hardware failures.  Probabilistic faults hash the site with a
    SplitMix64 mix of the seed, so firing is independent of dispatch
    order and identical across processes.
:class:`RunReport`
    The event log: retries, backoffs, degradations, evictions, resumes
    and checkpoint timings, as plain dicts — recovery is observable,
    never silent.
:class:`RetryPolicy`
    Bounded retry + exponential backoff knobs, and the OOM-halving cap.
:class:`SweepCheckpointer`
    Per-shard scan-carry checkpoints on
    :class:`repro_torch.checkpoint.manager.CheckpointManager` (atomic, async,
    keep-K), plus a run-level ``meta.json`` that refuses to resume a
    checkpoint directory under a different grid/shard/segment plan.
:func:`classify_failure`
    Maps an exception to a recovery action (``'oom'`` / ``'transient'``
    / ``'device_lost'`` / ``'fatal'``), covering the injected exception
    types below and a real CUDA out-of-memory error.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager


# ---------------------------------------------------------------------------
# Failure taxonomy
# ---------------------------------------------------------------------------
class ResilienceError(RuntimeError):
    """A recovery path ran out of options (retry budget, devices, ...)."""


class TransientDeviceError(RuntimeError):
    """A device error expected to succeed on retry (injected or real)."""


class SimulatedOOM(MemoryError):
    """An injected device OOM; the executor degrades the segment size."""


class DeviceLostError(RuntimeError):
    """A device dropped out; its shards requeue onto survivors."""

    def __init__(self, device_index: int, msg: str = ""):
        super().__init__(msg or f"device {device_index} lost")
        self.device_index = device_index


class RunKilled(BaseException):
    """An injected hard crash (stand-in for SIGKILL / power loss).

    Derives from ``BaseException`` so no recovery path can swallow it —
    exactly like a real process death, the only way forward is a fresh
    ``run_sweep(resume=...)`` against the checkpoint directory.
    """


FAULT_KINDS = ("crash", "transient", "oom", "device_lost", "slow")


def classify_failure(exc: BaseException) -> str:
    """Map an exception to a recovery action.

    Returns one of ``'oom'``, ``'transient'``, ``'device_lost'`` or
    ``'fatal'``.  Injected types map directly, and a real
    ``torch.cuda.OutOfMemoryError`` is ``'oom'`` (the allocation failed
    before any kernel ran, so halving the segment can succeed).  Every
    other exception is fatal and re-raised unchanged: a CUDA fault is
    sticky in a PyTorch process, so retrying a failed launch would only
    hide a broken kernel.
    """
    if isinstance(exc, (SimulatedOOM, torch.cuda.OutOfMemoryError)):
        return "oom"
    if isinstance(exc, DeviceLostError):
        return "device_lost"
    if isinstance(exc, TransientDeviceError):
        return "transient"
    return "fatal"


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault at a dispatch site.

    Parameters
    ----------
    kind : str
        One of :data:`FAULT_KINDS`: ``'crash'`` raises
        :class:`RunKilled`, ``'transient'`` raises
        :class:`TransientDeviceError`, ``'oom'`` raises
        :class:`SimulatedOOM`, ``'device_lost'`` raises
        :class:`DeviceLostError` for the dispatching device, ``'slow'``
        stalls the dispatch by ``delay_s`` (straggler injection).
    shard, segment : int
        The dispatch site; ``segment`` counts top-level streamed
        segments within the shard (``-1`` matches every segment).
    count : int
        Consecutive dispatch attempts this fault fires on before it is
        exhausted (a transient that fires twice is survived by a retry
        budget of two).  Ignored when ``oom_above`` is set.
    oom_above : int, optional
        ``'oom'`` only: fire whenever the dispatch covers more than
        this many trace elements per row — the executor must halve the
        segment until it fits, deterministically exercising multi-step
        degradation.
    delay_s : float
        ``'slow'`` only: injected stall seconds.
    """
    kind: str
    shard: int
    segment: int = -1
    count: int = 1
    oom_above: Optional[int] = None
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; pick from {FAULT_KINDS}")
        if self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")


def _splitmix64(x: int) -> int:
    """SplitMix64 finalizer — the deterministic site-hash mixer."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


class FaultPlan:
    """Deterministic fault injector for the resilient executor.

    Two trigger sources compose:

    * **explicit** :class:`Fault` entries — exact ``(shard, segment)``
      sites, the workhorse of the recovery tests;
    * **seeded probabilistic** transients — site ``(shard, segment)``
      fires a :class:`TransientDeviceError` (once) when
      ``hash(seed, shard, segment)`` falls under ``p_transient``.  The
      hash makes firing independent of dispatch order and identical
      across processes, so a retried or resumed run sees exactly the
      same fault sites.

    Firing state (attempt counts per site) is in-memory: a retry of the
    same site sees the fault already partially or fully exhausted, which
    is what lets bounded-count transients be *survivable*.  A resumed
    run constructs a fresh plan — like a real restart.

    Parameters
    ----------
    faults : sequence of Fault
        Explicit triggers.
    seed : int
        Site-hash seed for the probabilistic triggers.
    p_transient : float
        Per-site probability of one injected transient error.
    """

    def __init__(self, faults: Tuple[Fault, ...] = (), *, seed: int = 0,
                 p_transient: float = 0.0):
        if not 0.0 <= p_transient <= 1.0:
            raise ValueError(f"p_transient must be in [0, 1], "
                             f"got {p_transient}")
        self.faults = tuple(faults)
        self.seed = int(seed)
        self.p_transient = float(p_transient)
        self._attempts: Dict[Tuple[int, int, int], int] = {}
        self._random_fired: set = set()

    def _site_u(self, shard: int, segment: int) -> float:
        h = _splitmix64(self.seed ^ _splitmix64(
            (shard << 32) ^ (segment & 0xFFFFFFFF)))
        return h / 2.0 ** 64

    def check(self, shard: int, segment: int, *, width: Optional[int] = None,
              report: Optional["RunReport"] = None,
              sleeper=time.sleep) -> None:
        """Raise / stall per the plan at one dispatch attempt.

        Called by the executor immediately before each (sub-)dispatch;
        ``width`` is the trace elements per row this dispatch covers
        (drives ``oom_above`` faults).  ``'slow'`` faults stall via
        ``sleeper`` and log a ``slow`` event instead of raising.
        """
        for i, f in enumerate(self.faults):
            if f.shard != shard or (f.segment not in (-1, segment)):
                continue
            if f.kind == "oom" and f.oom_above is not None:
                if width is not None and width > f.oom_above:
                    raise SimulatedOOM(
                        f"injected OOM: width {width} > {f.oom_above} "
                        f"(shard {shard}, segment {segment})")
                continue
            key = (i, shard, segment)
            if self._attempts.get(key, 0) >= f.count:
                continue
            self._attempts[key] = self._attempts.get(key, 0) + 1
            if f.kind == "slow":
                if report is not None:
                    report.add("slow", shard=shard, segment=segment,
                               delay_s=f.delay_s)
                sleeper(f.delay_s)
                continue
            if f.kind == "crash":
                raise RunKilled(f"injected crash at shard {shard}, "
                                f"segment {segment}")
            if f.kind == "transient":
                raise TransientDeviceError(
                    f"injected transient error (shard {shard}, "
                    f"segment {segment}, attempt {self._attempts[key]})")
            if f.kind == "oom":
                raise SimulatedOOM(f"injected OOM (shard {shard}, "
                                   f"segment {segment})")
            if f.kind == "device_lost":
                raise DeviceLostError(-1, f"injected device loss "
                                          f"(shard {shard}, "
                                          f"segment {segment})")
        if self.p_transient > 0.0:
            site = (shard, segment)
            if site not in self._random_fired \
                    and self._site_u(shard, segment) < self.p_transient:
                self._random_fired.add(site)
                raise TransientDeviceError(
                    f"injected transient error (seeded, shard {shard}, "
                    f"segment {segment})")


# ---------------------------------------------------------------------------
# Observability: the event log
# ---------------------------------------------------------------------------
class RunReport:
    """Event log of one resilient run — recovery is never silent.

    Every recovery action appends one plain dict to :attr:`events`
    (the schema of the JAX package's ``docs/resilience.md``): ``retry``,
    ``degrade``, ``evict``, ``resume``, ``checkpoint``, ``slow``,
    ``restore_failed``.  The executor exposes its report as
    ``executor.report``; pass your own instance through
    ``run_sweep(report=...)`` to collect events from the facade APIs.
    """

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    def add(self, event: str, **fields: Any) -> None:
        """Append one event record (``{'event': event, **fields}``)."""
        self.events.append({"event": event, **fields})

    def count(self, event: str) -> int:
        """How many events of one kind were recorded."""
        return sum(1 for e in self.events if e["event"] == event)

    @property
    def retries(self) -> int:
        return self.count("retry")

    @property
    def degradations(self) -> int:
        return self.count("degrade")

    @property
    def resumes(self) -> int:
        return self.count("resume")

    @property
    def checkpoints(self) -> int:
        return self.count("checkpoint")

    def summary(self) -> Dict[str, Any]:
        """Aggregate counters + checkpoint/resume timings (seconds)."""
        ckpt = [e["elapsed_s"] for e in self.events
                if e["event"] == "checkpoint"]
        ff = [e["fast_forward_segments"] for e in self.events
              if e["event"] == "resume"]
        return {
            "retries": self.retries,
            "degradations": self.degradations,
            "evictions": self.count("evict"),
            "resumes": self.resumes,
            "fast_forwarded_segments": int(sum(ff)),
            "checkpoints": self.checkpoints,
            "checkpoint_s_total": round(float(sum(ckpt)), 6),
            "checkpoint_s_max": round(float(max(ckpt)), 6) if ckpt else 0.0,
            "slow_events": self.count("slow"),
        }


# ---------------------------------------------------------------------------
# Retry / degradation policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry + exponential backoff + OOM degradation knobs.

    Parameters
    ----------
    max_retries : int
        Transient-error retries per dispatch site before
        :class:`ResilienceError` is raised.
    backoff_s : float
        First backoff sleep; attempt ``k`` sleeps ``backoff_s *
        backoff_factor**k`` (capped at ``backoff_max_s``).
    backoff_factor : float
        Exponential growth per attempt.
    backoff_max_s : float
        Backoff ceiling.
    max_halvings : int
        OOM degradations per shard: each halves the dispatched segment
        (``2**max_halvings`` sub-segments at most) before OOM becomes
        fatal.  Halving is bitwise-neutral — segment boundaries carry
        no state.
    """
    max_retries: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0
    max_halvings: int = 6

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.max_halvings < 0:
            raise ValueError(f"max_halvings must be >= 0, "
                             f"got {self.max_halvings}")

    def backoff(self, attempt: int) -> float:
        """Backoff seconds before retry number ``attempt`` (0-based)."""
        return min(self.backoff_s * self.backoff_factor ** attempt,
                   self.backoff_max_s)


# ---------------------------------------------------------------------------
# Scan-carry checkpoints (per shard, on CheckpointManager)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Where and how often the executor persists scan carries.

    Parameters
    ----------
    directory : str or Path
        Run directory; each shard checkpoints under
        ``<directory>/shard_<i>/step_<segments_done>``.
    every_segments : int
        Checkpoint cadence in completed top-level segments (the final
        segment always checkpoints, so finished shards fast-forward
        entirely on resume).
    keep : int
        Newest checkpoints kept per shard (older ones are GC'd).
    blocking : bool
        ``False`` (default) saves on the manager's worker thread — the
        sweep loop lends only the device-to-host copy.
    """
    directory: pathlib.Path
    every_segments: int = 4
    keep: int = 2
    blocking: bool = False

    def __post_init__(self) -> None:
        object.__setattr__(self, "directory",
                           pathlib.Path(self.directory))
        if self.every_segments < 1:
            raise ValueError(f"every_segments must be >= 1, "
                             f"got {self.every_segments}")
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")


def as_checkpoint_policy(checkpoint) -> Optional[CheckpointPolicy]:
    """Accept a CheckpointPolicy, a directory path, or None."""
    if checkpoint is None or isinstance(checkpoint, CheckpointPolicy):
        return checkpoint
    if isinstance(checkpoint, (str, pathlib.Path)):
        return CheckpointPolicy(directory=pathlib.Path(checkpoint))
    raise TypeError(f"checkpoint must be a CheckpointPolicy, path, or "
                    f"None, got {type(checkpoint)}")


class SweepCheckpointer:
    """Per-shard scan-carry checkpoints + run-level plan verification.

    Wraps one :class:`~repro_torch.checkpoint.manager.CheckpointManager` per
    shard (atomic tmp→rename writes, async worker, keep-K GC) and a
    run-level ``meta.json`` recording the execution plan (rows, trace
    length, shard count, segment length, program kind).  Resuming a
    directory whose plan differs raises :class:`ResilienceError` —
    carries are only exchangeable between identical plans, and a silent
    shape mismatch would surface as a confusing restore error (or worse,
    wrong rows) later.
    """

    def __init__(self, policy: CheckpointPolicy):
        self.policy = policy
        self.dir = policy.directory
        self.dir.mkdir(parents=True, exist_ok=True)
        self._managers: Dict[int, CheckpointManager] = {}

    # -- plan verification -------------------------------------------------
    def verify_meta(self, meta: Dict[str, Any]) -> None:
        """Record the run plan, or refuse a directory that disagrees."""
        path = self.dir / "meta.json"
        if path.exists():
            stored = json.loads(path.read_text())
            if stored != meta:
                raise ResilienceError(
                    f"checkpoint directory {self.dir} was written under a "
                    f"different execution plan: stored {stored}, this run "
                    f"{meta}; resume must use the same grid, mesh and "
                    f"stream_chunk (or a fresh directory)")
        else:
            path.write_text(json.dumps(meta, sort_keys=True))

    # -- per-shard persistence ---------------------------------------------
    def manager(self, shard: int) -> CheckpointManager:
        if shard not in self._managers:
            self._managers[shard] = CheckpointManager(
                self.dir / f"shard_{shard:03d}", keep=self.policy.keep)
        return self._managers[shard]

    def save(self, shard: int, segments_done: int, tree: Any,
             *, report: Optional[RunReport] = None) -> None:
        """Persist one shard's carry after ``segments_done`` segments."""
        t0 = time.perf_counter()
        self.manager(shard).save(segments_done, tree,
                                 blocking=self.policy.blocking)
        if report is not None:
            report.add("checkpoint", shard=shard,
                       segments_done=segments_done,
                       blocking=self.policy.blocking,
                       elapsed_s=round(time.perf_counter() - t0, 6))

    def restore(self, shard: int, like: Any,
                *, report: Optional[RunReport] = None
                ) -> Optional[Tuple[int, Any]]:
        """Latest ``(segments_done, tree)`` for a shard, or None; tensor
        leaves of `like` come back as tensors on their device."""
        mgr = self.manager(shard)
        step = mgr.latest_step()
        if step is None:
            return None
        t0 = time.perf_counter()
        step, tree = mgr.restore(step, like)
        if report is not None:
            report.add("resume", shard=shard, fast_forward_segments=step,
                       elapsed_s=round(time.perf_counter() - t0, 6))
        return step, tree

    def wait(self) -> None:
        """Drain every shard's async save worker (raise on failure)."""
        for mgr in self._managers.values():
            mgr.wait()


def host_tree(tree: Any) -> Any:
    """Copy a carry tree (tuples, lists, dicts of tensors) to host NumPy:
    one synchronous device-to-host copy per leaf, before any writer
    thread starts."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(host_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def dyn_accumulators(b: int, e: int, nstats: int) -> dict:
    """Host-side per-slot output accumulators for a dynamic shard.

    The resilient executor's checkpoint tree must stay shape-stable
    across segments, so the per-slot outputs (counters, cumulative stat
    snapshots, and the sampling measurement flags) are accumulated into
    fixed-shape host arrays: completed segments fill their slice, the
    rest stays zero.  Keys mirror the :class:`~repro_torch.core.
    tiering_dyn.DynOutputs` per-slot fields (``slots``, ``snaps``,
    ``meas``).
    """
    return {"slots": np.zeros((b, e, 4), np.int32),
            "snaps": np.zeros((b, e, nstats), np.int32),
            "meas": np.zeros((b, e), np.int32)}
