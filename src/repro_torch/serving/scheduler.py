"""Continuous-batching serving scheduler over the tier-aware paged KV cache.

vLLM-style engine loop, CXL-aware: requests are admitted while the page
pool holds; each engine step either prefills one waiting request or decodes
the whole running batch; when the pool is exhausted the **youngest** running
sequence is preempted (pages released, request re-queued) rather than
failing — and the tier layer underneath is free to demote cold pages to the
CXL pool first, which is exactly the capacity lever the paper provides.

The engine is model-agnostic: callers supply `prefill_fn(request) ->
tokens_consumed` and `decode_fn(seq_ids) -> {seq_id: token}`; the scheduler
owns admission, batching, preemption, completion, and the latency/tier
metrics. :mod:`repro_torch.workloads.kv_decode` drives it; tests use
stub functions so policy behaviour is pinned without model cost.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.memory.kvcache import PagedKVCache


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrived_step: int = 0
    # lifecycle
    state: str = "waiting"          # waiting | running | done
    generated: int = 0
    first_token_step: Optional[int] = None
    done_step: Optional[int] = None
    preemptions: int = 0


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    prefills: int = 0
    decode_steps: int = 0
    decoded_tokens: int = 0
    preemptions: int = 0

    def row(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class ContinuousBatcher:
    def __init__(self, kv: PagedKVCache, *, max_running: int = 8,
                 prefill_chunk: int = 1):
        self.kv = kv
        self.max_running = max_running
        self.prefill_chunk = prefill_chunk
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.done: List[Request] = []
        self.stats = EngineStats()

    # ---- admission / preemption ------------------------------------------
    def submit(self, req: Request) -> None:
        req.arrived_step = self.stats.steps
        self.waiting.append(req)

    def _pages_needed(self, req: Request) -> int:
        total = req.prompt_len + req.max_new_tokens
        return -(-total // self.kv.page_size)

    def _try_admit(self) -> Optional[Request]:
        if not self.waiting or len(self.running) >= self.max_running:
            return None
        req = self.waiting[0]
        if self._pages_needed(req) > len(self.kv.free):
            return None
        self.waiting.pop(0)
        self.kv.allocate(req.rid)
        req.state = "running"
        self.running.append(req)
        return req

    def _preempt_youngest(self) -> bool:
        if not self.running:
            return False
        victim = max(self.running, key=lambda r: r.arrived_step)
        self.running.remove(victim)
        self.kv.release(victim.rid)
        victim.state = "waiting"
        victim.generated = 0          # restart from prompt (pages dropped)
        victim.preemptions += 1
        self.stats.preemptions += 1
        self.waiting.insert(0, victim)
        return True

    # ---- engine loop -------------------------------------------------------
    def step(self, prefill_fn: Callable[[Request], None],
             decode_fn: Callable[[List[int]], Dict[int, int]]) -> None:
        """One engine step: admit+prefill (priority) or batched decode."""
        self.stats.steps += 1
        admitted = self._try_admit()
        if admitted is not None:
            try:
                prefill_fn(admitted)
            except MemoryError:
                self.running.remove(admitted)
                self.kv.release(admitted.rid)
                admitted.state = "waiting"
                self.waiting.insert(0, admitted)
                if not self._preempt_youngest():
                    raise
                return
            admitted.first_token_step = self.stats.steps
            self.stats.prefills += 1
            return
        if not self.running:
            return
        try:
            out = decode_fn([r.rid for r in self.running])
        except MemoryError:
            if not self._preempt_youngest():
                raise
            return
        self.stats.decode_steps += 1
        for r in list(self.running):
            if r.rid in out:
                r.generated += 1
                self.stats.decoded_tokens += 1
                if r.generated >= r.max_new_tokens:
                    r.state = "done"
                    r.done_step = self.stats.steps
                    self.running.remove(r)
                    self.kv.release(r.rid)
                    self.done.append(r)

    def run_until_drained(self, prefill_fn, decode_fn,
                          max_steps: int = 100_000) -> EngineStats:
        while (self.waiting or self.running) and \
                self.stats.steps < max_steps:
            self.step(prefill_fn, decode_fn)
        return self.stats

    # ---- metrics -----------------------------------------------------------
    def ttft(self) -> Dict[int, int]:
        """Time-to-first-token (engine steps) per completed request."""
        return {r.rid: r.first_token_step - r.arrived_step
                for r in self.done if r.first_token_step is not None}
