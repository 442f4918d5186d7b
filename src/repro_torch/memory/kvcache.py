"""Paged, tier-aware KV cache (the paper's motivating LLM use-case).

Pages of `page_size` tokens live in a global pool; a per-sequence block
table maps logical blocks -> page ids.  Each page carries a **tier** tag
(HBM / CXL): the attention math (:func:`repro_torch.kernels.ops.
paged_attention`) is tier-agnostic, while the manager accounts residency,
migrates pages (LRU-hot promotion / cold demotion), and charges every CXL
crossing to the calibrated timing model — a simulated clock the serving
loop reads.

For an MLA configuration the pool holds the latent instead: one row of
``kv_lora_rank + qk_rope_head_dim`` elements a token (the normed
compressed KV, then the roped shared rope key), one pool whose rows are
the keys and whose first ``kv_lora_rank`` columns are the values of the
absorbed decode; a page is priced at that row.

The pools are device tensors in ``cfg.dtype``, written **in place**: the
JAX reference's ``.at[pg, off].set`` returns a new pool (a copy per
token), the port's update does not; the pool values agree.  The block
tables, the tier map, the LRU clock and the stats stay host Python and
NumPy, as in the reference, so :class:`KVStats` matches it exactly
(``sim_seconds`` to the ulp: the same float operations in the same order).
The count of HBM pages in use is kept as pages move, and the LRU victim is
found over NumPy arrays of each page's last use, sequence and block, in
the reference's order (least recent, then first in request order, then
in block order), where the reference walks every block table for each.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.spec import CACHELINE_BYTES
from repro_torch.core.timing import TimingConfig
from repro_torch.runtime.trace import span

HBM, CXL = 0, 1


@dataclasses.dataclass
class KVStats:
    allocs: int = 0
    hbm_hits: int = 0
    cxl_fetches: int = 0
    promotions: int = 0
    demotions: int = 0
    cxl_bytes: int = 0
    sim_seconds: float = 0.0


class PagedKVCache:
    """Global page pool + block tables + tier map for one layer group.

    The pools are ``n_layers`` pairs of (n_pages, page_size, K, hd)
    tensors on `device` (default: the CUDA card); for MLA (``latent``)
    ``n_layers`` single (n_pages, page_size, 1, kv_lora_rank +
    qk_rope_head_dim) pools, ``v_pool`` None.
    """

    def __init__(self, cfg, *, n_pages: int, page_size: int,
                 max_blocks: int, hbm_page_budget: int,
                 timing: Optional[TimingConfig] = None, n_layers: int = 1,
                 device=None):
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.hbm_page_budget = hbm_page_budget
        self.timing = timing or TimingConfig()
        self.device = resolve_device(device)
        self.latent = cfg.attn_kind == "mla"
        kh, hd = self.row()
        dt = getattr(torch, cfg.dtype)
        self.n_layers = n_layers
        shape = (n_pages, page_size, kh, hd)
        self.k_pool = [torch.zeros(shape, dtype=dt, device=self.device)
                       for _ in range(n_layers)]
        self.v_pool = None if self.latent else [
            torch.zeros(shape, dtype=dt, device=self.device)
            for _ in range(n_layers)]
        self.free: List[int] = list(range(n_pages))
        self.tier = np.zeros((n_pages,), np.int8)
        self.last_use = np.zeros((n_pages,), np.int64)
        self.block_tables: Dict[int, List[int]] = {}
        self.seq_lens: Dict[int, int] = {}
        # pages in the block tables on HBM; each page's sequence (its
        # allocation rank, -1 while free) and block, the LRU's tie order
        self._hbm_used = 0
        self._owner = np.full((n_pages,), -1, np.int64)
        self._block = np.zeros((n_pages,), np.int64)
        self._rank: Dict[int, int] = {}
        self._next_rank = 0
        self.max_blocks = max_blocks
        self.clock = 0
        self.stats = KVStats()

    # -- bookkeeping ---------------------------------------------------------
    def row(self) -> Tuple[int, int]:
        """(heads, width) of one token's row in a pool: the kv heads and
        head size, or one latent row for MLA."""
        if self.latent:
            m = self.cfg.mla
            return 1, m.kv_lora_rank + m.qk_rope_head_dim
        return self.cfg.n_kv_heads, self.cfg.head_dim

    def page_bytes(self) -> int:
        kh, hd = self.row()
        pools = 1 if self.latent else 2
        return self.page_size * kh * hd * pools * 2 * self.n_layers

    def lines_per_page(self) -> int:
        """Cachelines one KV page spans (>= 1): the expansion factor the
        trace generator (:mod:`repro_torch.workloads.kv_decode`) uses to
        turn page-granular gathers into line-granular access traces."""
        return max(self.page_bytes() // CACHELINE_BYTES, 1)

    def tier_snapshot(self) -> np.ndarray:
        """Copy of the per-page tier map (HBM=0 / CXL=1) at this instant."""
        return self.tier.copy()

    def hbm_pages_in_use(self) -> int:
        return self._hbm_used

    def _evict_to_cxl_if_needed(self) -> None:
        while self._hbm_used > self.hbm_page_budget:
            used = np.flatnonzero((self._owner >= 0) & (self.tier == HBM))
            lru = used[self.last_use[used] == self.last_use[used].min()]
            victim = lru[np.lexsort((self._block[lru], self._owner[lru]))[0]]
            self.tier[victim] = CXL
            self._hbm_used -= 1
            self.stats.demotions += 1
            self.stats.cxl_bytes += self.page_bytes()
            self.stats.sim_seconds += self.page_bytes() / (
                self.timing.cxl.payload_write_gbps * 1e9)

    # -- sequence lifecycle ---------------------------------------------------
    def allocate(self, seq_id: int) -> None:
        if seq_id in self.block_tables:
            raise KeyError(f"seq {seq_id} already allocated")
        self.block_tables[seq_id] = []
        self.seq_lens[seq_id] = 0
        self._rank[seq_id] = self._next_rank
        self._next_rank += 1

    def release(self, seq_id: int) -> None:
        for p in self.block_tables.pop(seq_id, []):
            self._hbm_used -= int(self.tier[p] == HBM)
            self._owner[p] = -1
            self.free.append(p)
        self.seq_lens.pop(seq_id, None)
        self._rank.pop(seq_id, None)

    def append_tokens(self, seq_id: int, layer: int, k_new,
                      v_new=None) -> None:
        """Append (T, K, hd) keys/values (tensors or arrays) for `seq_id`
        (for the latent pool, (T, 1, width) rows and no values).

        The bookkeeping walks the tokens one by one, as the reference; the
        T rows are then written into the pools with one indexed copy each.
        """
        with span("kv.append_tokens"):
            t = k_new.shape[0]
            table = self.block_tables[seq_id]
            pos = self.seq_lens[seq_id]
            self.clock += 1
            pages, offs = [], []
            try:
                for i in range(t):
                    blk, off = divmod(pos + i, self.page_size)
                    if blk >= len(table):
                        if not self.free:
                            raise MemoryError("KV pool exhausted")
                        pg = self.free.pop()
                        table.append(pg)
                        self.tier[pg] = HBM
                        self._owner[pg] = self._rank[seq_id]
                        self._block[pg] = blk
                        self._hbm_used += 1
                        self.stats.allocs += 1
                        self._evict_to_cxl_if_needed()
                    pg = table[blk]
                    self.last_use[pg] = self.clock
                    pages.append(pg)
                    offs.append(off)
            finally:
                # the rows placed before an exhausted pool, as the reference
                if pages:
                    idx = (torch.tensor(pages, device=self.device),
                           torch.tensor(offs, device=self.device))
                    n = len(pages)
                    writes = [(self.k_pool[layer], k_new)]
                    if not self.latent:
                        writes.append((self.v_pool[layer], v_new))
                    for pool, new in writes:
                        pool[idx] = torch.as_tensor(new[:n]).to(self.device,
                                                                pool.dtype)
            if layer == self.n_layers - 1:
                self.seq_lens[seq_id] = pos + t

    # -- decode-side access ----------------------------------------------------
    def gather_args(self, seq_ids: List[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(block_table (B, max_blocks), context_lens (B,)) int32 tensors on
        the cache's device for the kernel, charging CXL fetches and
        promoting hot pages."""
        with span("kv.gather_args"):
            self.clock += 1
            bt = np.zeros((len(seq_ids), self.max_blocks), np.int32)
            cl = np.zeros((len(seq_ids),), np.int32)
            for row, sid in enumerate(seq_ids):
                table = self.block_tables[sid]
                cl[row] = self.seq_lens[sid]
                for j, pg in enumerate(table[:self.max_blocks]):
                    bt[row, j] = pg
                    self.last_use[pg] = self.clock
                    if self.tier[pg] == CXL:
                        self.stats.cxl_fetches += 1
                        self.stats.cxl_bytes += self.page_bytes()
                        self.stats.sim_seconds += self.page_bytes() / (
                            self.timing.cxl.payload_read_gbps * 1e9)
                        if self._hbm_used < self.hbm_page_budget:
                            self.tier[pg] = HBM          # promote while hot
                            self._hbm_used += 1
                            self.stats.promotions += 1
                    else:
                        self.stats.hbm_hits += 1
            return (torch.from_numpy(bt).to(self.device),
                    torch.from_numpy(cl).to(self.device))

    def tier_histogram(self) -> Dict[str, int]:
        used = [p for t in self.block_tables.values() for p in t]
        return {"hbm_pages": int(sum(1 for p in used if self.tier[p] == HBM)),
                "cxl_pages": int(sum(1 for p in used if self.tier[p] == CXL)),
                "free_pages": len(self.free)}
