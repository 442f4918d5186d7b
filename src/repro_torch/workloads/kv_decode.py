"""LLM KV-decode workload: paged-attention gathers from the serving stack.

The paper's motivating use-case is LLM inference with the KV cache spilled
to CXL.  This generator does not invent that traffic — it *records* it
from the port's own serving stack, as the JAX package's ``kv_decode``
does:

1. a :class:`repro_torch.memory.kvcache.PagedKVCache` pool is sized from
   the sweep footprint (so the §IV ``k x L2`` axis scales the pool);
2. a :class:`repro_torch.serving.scheduler.ContinuousBatcher` admits a
   seeded request mix and runs the vLLM-style engine loop (prefill
   priority, batched decode, preemption when the pool is exhausted);
3. every **decode** step records, at page granularity, the block-table
   gather of each running sequence (reads of the full context) and the
   appended token (a write), with each page's HBM/CXL residency *at
   access time*, as the cache's LRU promotion/demotion moves it.

The page-granular log is small host state; the line-granular trace is
expanded by one shared routine either on a torch device
(:meth:`KVDecode.device_trace`) or in NumPy (:meth:`KVDecode.host_trace`),
bitwise equal.  The generator carries its own per-access tier intent
(HBM -> DRAM target 0, CXL -> the expander targets), so the sweep's
placement-policy axis is bypassed.  The recording cache keeps its pool on
the CPU: the log depends on its bookkeeping alone, and no value of the
pool is ever read.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.device import resolve_device
from repro_torch.core.spec import CACHELINE_BYTES
from repro_torch.memory.kvcache import CXL, PagedKVCache
from repro_torch.memory.offload import kv_offload_tiers
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from repro_torch.workloads.base import Workload, WorkloadTrace, pages_for_lines

# One recorded decode step, page-granular:
# (read_pages, read_tiers, write_pages, write_line_offs, write_tiers)
StepLog = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass(frozen=True)
class KVDecode(Workload):
    """Paged-attention decode gathers with HBM/CXL page residency.

    Parameters
    ----------
    arch : str
        Architecture key (:func:`repro_torch.configs.get_smoke`) supplying
        the KV head geometry.
    seed : int
        Drives the request mix (prompt/new-token lengths); the serving
        loop itself is deterministic.
    n_requests, max_running : int
        Offered load and the batcher's running-set cap.
    page_size : int
        Tokens per KV page.
    hbm_fraction : float
        HBM page budget as a fraction of the pool.
    max_pool_pages : int
        Pool-size cap, bounding trace length at large sweep footprints.
    ssd_cold_offload : int
        When positive, the CXL-DRAM page budget: CXL-resident pages beyond
        it, coldest first by the cache's LRU clock, are offloaded to the
        CXL-SSD tier and emit tier-2 intent
        (:func:`repro_torch.memory.offload.kv_offload_tiers`).  0 keeps
        the two-level HBM/CXL stream.
    """
    arch: str = "granite-3-8b"
    seed: int = 3
    n_requests: int = 6
    max_running: int = 4
    page_size: int = 8
    hbm_fraction: float = 0.25
    max_pool_pages: int = 96
    ssd_cold_offload: int = 0

    name = "kv_decode"

    def _trace(self, footprint_bytes: int, xp) -> WorkloadTrace:
        """Expand the page log to lines with the array namespace `xp`."""
        steps, lines_per_page, total_lines = _kv_scenario(self,
                                                          footprint_bytes)
        line = xp.arange(lines_per_page)
        addrs, writes, tiers = [], [], []
        for rp, rt, wp, wo, wt in steps:
            if rp.shape[0]:
                a = (xp.asarray(rp)[:, None] * lines_per_page
                     + line[None, :]).reshape(-1)
                addrs.append(a)
                writes.append(xp.zeros(a.shape[0]))
                tiers.append(xp.repeat(xp.asarray(rt), lines_per_page))
            if wp.shape[0]:
                addrs.append(xp.asarray(wp) * lines_per_page
                             + xp.asarray(wo))
                writes.append(xp.ones(wp.shape[0]))
                tiers.append(xp.asarray(wt))
        if not addrs:
            raise ValueError("kv_decode scenario recorded no decode steps")
        return WorkloadTrace(addr=xp.concatenate(addrs),
                             is_write=xp.concatenate(writes),
                             n_pages=pages_for_lines(total_lines),
                             tier=xp.concatenate(tiers))

    def device_trace(self, footprint_bytes: int,
                     device=None) -> WorkloadTrace:
        return self._trace(footprint_bytes,
                           _TorchInt32(resolve_device(device)))

    def host_trace(self, footprint_bytes: int) -> WorkloadTrace:
        return self._trace(footprint_bytes, _NumpyInt32())


class _NumpyInt32:
    """The int32 array operations of :meth:`KVDecode._trace`, in NumPy."""

    def arange(self, n):
        return np.arange(n, dtype=np.int32)

    def asarray(self, x):
        return np.asarray(x, np.int32)

    def zeros(self, n):
        return np.zeros(n, np.int32)

    def ones(self, n):
        return np.ones(n, np.int32)

    def repeat(self, x, k):
        return np.repeat(x, k)

    def concatenate(self, xs):
        return np.concatenate(xs)


class _TorchInt32:
    """The same operations as int32 tensors on `device`."""

    def __init__(self, device: torch.device):
        self.device = device

    def arange(self, n):
        return torch.arange(n, dtype=torch.int32, device=self.device)

    def asarray(self, x):
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    def zeros(self, n):
        return torch.zeros(n, dtype=torch.int32, device=self.device)

    def ones(self, n):
        return torch.ones(n, dtype=torch.int32, device=self.device)

    def repeat(self, x, k):
        return torch.repeat_interleave(x, k)

    def concatenate(self, xs):
        return torch.cat(xs)


@functools.lru_cache(maxsize=32)
def _kv_scenario(wl: KVDecode, footprint_bytes: int
                 ) -> Tuple[Tuple[StepLog, ...], int, int]:
    """Run the serving stack once and log decode-step page references.

    Returns ``(steps, lines_per_page, total_lines)``; cached per
    (workload, footprint) — the run is deterministic under ``wl.seed``.
    """
    cfg = get_smoke(wl.arch)
    kh, hd = cfg.n_kv_heads, cfg.head_dim
    page_bytes = wl.page_size * kh * hd * 2 * 2          # K+V, 2 B each
    pool = max(4, min(footprint_bytes // page_bytes, wl.max_pool_pages))
    kv = PagedKVCache(cfg, n_pages=pool, page_size=wl.page_size,
                      max_blocks=pool,
                      hbm_page_budget=max(1, int(pool * wl.hbm_fraction)),
                      n_layers=1, device="cpu")
    lines_per_page = kv.lines_per_page()
    token_bytes = max(page_bytes // wl.page_size, 1)

    rng = np.random.default_rng(wl.seed)
    pool_tokens = pool * wl.page_size
    # offered load scales with the requested footprint (bounded at 2x the
    # pool): past the pool cap, bigger footprints mean longer sequences
    # against the same capacity
    offered = min((footprint_bytes // page_bytes) * wl.page_size,
                  2 * pool_tokens)
    budget = max(offered // (wl.n_requests + 2), 2 * wl.page_size)
    cap = max(pool_tokens // 2, wl.page_size + 1)
    batcher = ContinuousBatcher(kv, max_running=wl.max_running)
    for rid in range(wl.n_requests):
        prompt = int(rng.integers(budget // 2, budget + 1))
        new = int(rng.integers(budget // 4 + 1, budget // 2 + 1))
        if prompt + new > cap:
            prompt = max(1, cap - new)
        batcher.submit(Request(rid=rid, prompt_len=prompt,
                               max_new_tokens=new))

    def zeros(t):
        return np.zeros((t, kh, hd), np.float32)

    steps: List[StepLog] = []

    def prefill_fn(req: Request) -> None:
        kv.append_tokens(req.rid, 0, zeros(req.prompt_len),
                         zeros(req.prompt_len))

    def tier3(snapshot):
        # cold-CXL -> SSD demotion from the cache's own LRU clock
        return kv_offload_tiers(snapshot, kv.last_use,
                                cxl_page_budget=wl.ssd_cold_offload)

    def decode_fn(seq_ids):
        tier_now = kv.tier_snapshot()          # residency at access time
        tmap = tier3(tier_now) if wl.ssd_cold_offload > 0 else None
        rp: List[int] = []
        rt: List[int] = []
        for sid in seq_ids:                    # context gather, page-major
            table = kv.block_tables[sid]
            rp.extend(table)
            rt.extend((int(tier_now[p] == CXL) if tmap is None
                       else int(tmap[p])) for p in table)
        kv.gather_args(seq_ids)                # charge fetches, promote hot
        wp, wo, wt, out = [], [], [], {}
        for sid in seq_ids:                    # append this step's token
            kv.append_tokens(sid, 0, zeros(1), zeros(1))
            pos = kv.seq_lens[sid] - 1
            page = kv.block_tables[sid][pos // wl.page_size]
            off = min((pos % wl.page_size) * token_bytes // CACHELINE_BYTES,
                      lines_per_page - 1)
            wp.append(page)
            wo.append(off)
            wt.append(int(kv.tier[page] == CXL) if wl.ssd_cold_offload <= 0
                      else int(tier3(kv.tier_snapshot())[page]))
            out[sid] = 0
        steps.append((np.asarray(rp, np.int32), np.asarray(rt, np.int32),
                      np.asarray(wp, np.int32), np.asarray(wo, np.int32),
                      np.asarray(wt, np.int32)))
        return out

    batcher.run_until_drained(prefill_fn, decode_fn, max_steps=2000)
    return tuple(steps), lines_per_page, pool * lines_per_page
