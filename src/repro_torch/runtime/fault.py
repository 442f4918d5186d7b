"""Fault-tolerant training runtime: restart, stragglers, fleet state.

The port of ``repro.runtime.fault``:

  * **checkpoint/restart**: the loop persists the whole state (parameters
    and optimizer) through :class:`repro_torch.checkpoint.
    CheckpointManager`; a raised :class:`WorkerFailure` rolls back to the
    newest checkpoint and replays (the data pipeline is a pure function
    of the step, so the replay is exact);
  * **straggler mitigation**: per-host step-time EWMAs; a host slower
    than ``straggler_factor`` x the fleet median for ``straggler_grace``
    steps is evicted.  Timings come from `host_timings_fn` (tests feed
    simulated ones);
  * :class:`FleetState`, which hosts are alive, is shared with the
    resilient sweep executor (:class:`repro_torch.core.distribute.
    ResilientExecutor`), which evicts a logical host when its device is
    lost and requeues its shards onto the survivors.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class WorkerFailure(RuntimeError):
    """A (simulated or real) host failure surfaced to the runtime."""
    def __init__(self, host: int, msg: str = ""):
        super().__init__(msg or f"host {host} failed")
        self.host = host


@dataclasses.dataclass
class FleetState:
    n_hosts: int
    step_time_ewma: Dict[int, float] = dataclasses.field(default_factory=dict)
    flagged: Dict[int, int] = dataclasses.field(default_factory=dict)
    evicted: List[int] = dataclasses.field(default_factory=list)

    def live_hosts(self) -> List[int]:
        return [h for h in range(self.n_hosts) if h not in self.evicted]

    def evict(self, host: int, reason: str,
              log: Optional[List[Dict]] = None,
              on_resize: Optional[Callable[[int], None]] = None) -> bool:
        """Mark a host dead (idempotent); returns True if newly evicted.

        Appends an ``evict`` event to ``log`` (the runtime's log, or a
        :class:`repro_torch.core.resilience.RunReport`'s ``events``) and
        calls ``on_resize`` with the surviving host count.
        """
        if host in self.evicted:
            return False
        self.evicted.append(host)
        if log is not None:
            log.append({"event": "evict", "host": host, "reason": reason,
                        "live": len(self.live_hosts())})
        if on_resize:
            on_resize(len(self.live_hosts()))
        return True


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    ckpt_every: int = 20
    keep: int = 3
    straggler_factor: float = 2.0
    straggler_grace: int = 3          # flags before eviction
    ewma_alpha: float = 0.3
    max_restarts: int = 5


class TrainingRuntime:
    """Drives step_fn with checkpointing + failure handling.

    step_fn(state, step) -> (state, metrics); state is the whole tree
    (params, opt, ...).  `host_timings_fn` (tests) returns per-host step
    seconds; `failure_injector` may raise WorkerFailure at chosen steps.
    """

    def __init__(self, step_fn: Callable, ckpt, cfg: RuntimeConfig =
                 RuntimeConfig(), n_hosts: int = 4,
                 host_timings_fn: Optional[Callable[[int], List[float]]] =
                 None,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 on_resize: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.fleet = FleetState(n_hosts=n_hosts)
        self.host_timings_fn = host_timings_fn
        self.failure_injector = failure_injector
        self.on_resize = on_resize
        self.restarts = 0
        self.log: List[Dict] = []

    # ---- straggler policy ---------------------------------------------------
    def _observe_timings(self, step: int) -> None:
        if self.host_timings_fn is None:
            return
        times = self.host_timings_fn(step)
        live = self.fleet.live_hosts()
        for h in live:
            t = times[h] if h < len(times) else times[-1]
            prev = self.fleet.step_time_ewma.get(h, t)
            a = self.cfg.ewma_alpha
            self.fleet.step_time_ewma[h] = (1 - a) * prev + a * t
        med = float(np.median([self.fleet.step_time_ewma[h] for h in live]))
        for h in live:
            if self.fleet.step_time_ewma[h] > self.cfg.straggler_factor * med:
                self.fleet.flagged[h] = self.fleet.flagged.get(h, 0) + 1
                if self.fleet.flagged[h] >= self.cfg.straggler_grace:
                    self._evict(h, reason="straggler")
            else:
                self.fleet.flagged.pop(h, None)

    def _evict(self, host: int, reason: str) -> None:
        self.fleet.evict(host, reason, log=self.log,
                         on_resize=self.on_resize)

    # ---- main loop ----------------------------------------------------------
    def run(self, state, start_step: int, n_steps: int):
        step = start_step
        end = start_step + n_steps
        while step < end:
            try:
                if self.failure_injector:
                    self.failure_injector(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, step)
                dt = time.perf_counter() - t0
                self._observe_timings(step)
                self.log.append({"event": "step", "step": step,
                                 "dt": round(dt, 4),
                                 **{k: float(v) for k, v in metrics.items()}})
                step += 1
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(step, state, blocking=False)
            except WorkerFailure as wf:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError("restart budget exhausted") from wf
                self._evict(wf.host, reason="failure")
                self.ckpt.wait()
                last = self.ckpt.latest_step()
                self.log.append({"event": "restart", "from_step": step,
                                 "resume_step": last or start_step})
                if last is not None:
                    last, state = self.ckpt.restore(last, state)
                    step = last
                else:
                    step = start_step
        self.ckpt.wait()
        return state, step
