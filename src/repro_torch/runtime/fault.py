"""Fleet bookkeeping: which logical hosts are alive.

The resilient sweep executor (:class:`repro_torch.core.distribute.
ResilientExecutor`) evicts a logical host when its device is lost and
requeues the host's shards onto the survivors.  :class:`FleetState` is that
bookkeeping; :class:`WorkerFailure` is the error a host failure surfaces
as.  (The JAX package's training runtime, which shares them, belongs to
the model stack's training half and is not here.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional


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

        Appends an ``evict`` event to ``log`` (a
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
