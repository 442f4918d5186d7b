"""Paged, tier-aware KV cache (the paper's motivating LLM use-case).

Pages of `page_size` tokens live in a global pool; a per-sequence block
table maps logical blocks -> page ids.  Each page carries a **tier** tag
(HBM / CXL): the attention math (:func:`repro_torch.kernels.ops.
paged_attention`) is tier-agnostic, while the manager accounts residency,
migrates pages (LRU-hot promotion / cold demotion), and charges every CXL
crossing to the calibrated timing model — a simulated clock the serving
loop reads.

For an MLA configuration one pool holds one latent row a token, keys
and values at once (:func:`repro_torch.models.attention.pool_rows`); a
page is priced at that row.  A hybrid model (window and full attention
layers, ``ModelConfig.hybrid``) keeps two kinds of page side by side
(:func:`pool_kinds`): its first full layer's, which grow with a sequence
and may spill, and its first window layer's, a ring of ``window / page``
pages a sequence, rewritten in place (token p at slot p mod window, as the
dense ring cache).  Each kind has its own pool, free list and block
tables and is priced at its own row; one HBM page budget, one LRU clock
and one tier map cover both.

The pools are device tensors in ``cfg.dtype``, written **in place**: the
JAX reference's ``.at[pg, off].set`` returns a new pool (a copy per
token), the port's update does not; the pool values agree.  The block
tables, the tier map, the LRU clock and the stats stay host Python and
NumPy, as in the reference, so :class:`KVStats` matches it exactly
(``sim_seconds`` to the ulp: the same float operations in the same order).
The count of HBM pages in use is kept as pages move, and the LRU victim is
found over NumPy arrays of each page's last use, sequence, kind and block,
in the reference's order (least recent, then first in request order, then
the kinds in :func:`pool_kinds`'s order, the full kind first, then in
block order), where the reference walks every block table for each.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

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


@dataclasses.dataclass(frozen=True)
class PoolKind:
    """One kind of page in the pool: the rows of model layer `layer`,
    `heads` key rows `width` wide and `heads` value rows `v_width` wide a
    token (`v_width` 0: one latent row a token, its values the keys'
    leading columns); at most `ring` pages a sequence, rewritten in place
    (None: pages that grow with the sequence)."""
    name: str
    layer: int
    heads: int
    width: int
    v_width: int
    ring: Optional[int] = None


def pool_kinds(cfg, page_size: int) -> Tuple[PoolKind, ...]:
    """The kinds of page `cfg`'s serving pool holds: MLA's latent rows of
    its first MLA layer (KDA layers keep no pages); GQA's keys and values
    of layer 0; for a hybrid model, its first full layer's and its first
    window layer's (a ring of ``window / page_size`` pages)."""
    if cfg.attn_kind == "mla":
        m = cfg.mla
        first = next(i for i in range(cfg.n_layers)
                     if cfg.layer(i).attn_kind == "mla")
        return (PoolKind("latent", first, 1,
                         m.kv_lora_rank + m.qk_rope_head_dim, 0),)
    windows = [i for i in range(cfg.n_layers) if cfg.is_window_layer(i)]
    if not windows:
        return (PoolKind("full", 0, cfg.n_kv_heads, cfg.head_dim,
                         cfg.v_dim),)
    full = next(i for i in range(cfg.n_layers)
                if not cfg.is_window_layer(i))
    win = cfg.layer(windows[0])
    if win.window % page_size:
        raise ValueError(f"a window of {win.window} is no whole number of "
                         f"{page_size}-token pages")
    return (PoolKind("full", full, cfg.n_kv_heads, cfg.head_dim, cfg.v_dim),
            PoolKind("window", windows[0], win.n_kv_heads, win.head_dim,
                     win.v_dim, win.window // page_size))


@dataclasses.dataclass
class _Kind:
    """Kind `index`'s state: its page ids ``base`` .. ``base + n - 1``,
    their free list, each sequence's block table and the kind's
    counters."""
    index: int
    spec: PoolKind
    base: int
    n: int
    free: List[int]
    tables: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    stats: KVStats = dataclasses.field(default_factory=KVStats)


class PagedKVCache:
    """Global page pool + block tables + tier map for one layer group, or
    for each kind of :func:`pool_kinds` side by side.

    One kind: ``n_layers`` pairs of (n_pages, page_size, K, hd) pools on
    `device` (default: the CUDA card); for MLA (``latent``) ``n_layers``
    single (n_pages, page_size, 1, kv_lora_rank + qk_rope_head_dim) pools,
    ``v_pool`` None.  Several kinds: `n_pages` gives one count a kind, and
    pool j is kind j's one layer, its K pool (n, page, heads, width) and V
    pool (n, page, heads, v_width).  Page ids are global (kind j's follow
    kind j - 1's).  ``block_tables``, ``free``, :meth:`row` and
    :meth:`page_bytes` without a kind are the first kind's: the JAX
    package's API, which single-kind configurations keep.
    """

    def __init__(self, cfg, *, n_pages: Union[int, Sequence[int]],
                 page_size: int, max_blocks: int, hbm_page_budget: int,
                 timing: Optional[TimingConfig] = None, n_layers: int = 1,
                 device=None):
        self.cfg = cfg
        self.page_size = page_size
        self.hbm_page_budget = hbm_page_budget
        self.timing = timing or TimingConfig()
        self.device = resolve_device(device)
        self.latent = cfg.attn_kind == "mla"
        specs = pool_kinds(cfg, page_size)
        counts = ((int(n_pages),) if np.ndim(n_pages) == 0
                  else tuple(int(n) for n in n_pages))
        if len(counts) != len(specs):
            raise ValueError(f"{len(counts)} page counts for "
                             f"{len(specs)} kinds of page")
        if len(specs) > 1 and n_layers != 1:
            raise ValueError("a pool of several kinds holds one layer each")
        self.n_pages = sum(counts)
        self.n_layers = n_layers
        self._kinds: List[_Kind] = []
        base = 0
        for j, (spec, n) in enumerate(zip(specs, counts)):
            self._kinds.append(_Kind(j, spec, base, n,
                                     list(range(base, base + n))))
            base += n
        # pool p's kind: every layer's the one kind's, else kind p's
        self._pools = (self._kinds * n_layers if len(specs) == 1
                       else self._kinds)
        dt = getattr(torch, cfg.dtype)

        def zeros(k: _Kind, width: int) -> torch.Tensor:
            return torch.zeros((k.n, page_size, k.spec.heads, width),
                               dtype=dt, device=self.device)
        self.k_pool = [zeros(k, k.spec.width) for k in self._pools]
        self.v_pool = None if self.latent else [
            zeros(k, k.spec.v_width) for k in self._pools]
        self.free = self._kinds[0].free
        self.block_tables = self._kinds[0].tables
        self.tier = np.zeros((self.n_pages,), np.int8)
        self.last_use = np.zeros((self.n_pages,), np.int64)
        self.seq_lens: Dict[int, int] = {}
        # pages in the block tables on HBM; each page's sequence (its
        # allocation rank, -1 while free), kind and block: the LRU's ties
        self._hbm_used = 0
        self._owner = np.full((self.n_pages,), -1, np.int64)
        self._kind = np.repeat(np.arange(len(counts)), counts)
        self._block = np.zeros((self.n_pages,), np.int64)
        self._rank: Dict[int, int] = {}
        self._next_rank = 0
        self.max_blocks = max_blocks
        self.clock = 0
        self.stats = KVStats()

    # -- bookkeeping ---------------------------------------------------------
    def row(self, kind: int = 0) -> Tuple[int, int]:
        """(heads, width) of one token's key row in `kind`'s pool: the kv
        heads and head size, or one latent row for MLA."""
        spec = self._kinds[kind].spec
        return spec.heads, spec.width

    def page_bytes(self, kind: int = 0) -> int:
        """A page of `kind`: its key and value rows for every layer of the
        pool, 2 B an element."""
        k = self._kinds[kind].spec
        return self.page_size * k.heads * (k.width + k.v_width) * 2 \
            * self.n_layers

    def f32_pools(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """`layer`'s K and V pools cast to float32 for K4; the latent
        pool's V pool is its K pool, so K4 reads each row once."""
        kp = self.k_pool[layer].float()
        return kp, (kp if self.latent else self.v_pool[layer].float())

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

    def _price(self, k: _Kind) -> int:
        """`k`'s page in bytes: a single-kind pool's through
        :meth:`page_bytes` called as the JAX package's API calls it, with
        no kind."""
        if len(self._kinds) == 1:
            return self.page_bytes()
        return self.page_bytes(k.index)

    def _count(self, k: _Kind, field: str, gbps: float = 0.0) -> None:
        """`field` counted once, in the sum and in `k`'s; with `gbps`, one
        of `k`'s pages crossed the CXL link at that rate."""
        nbytes = self._price(k) if gbps else 0
        for st in (self.stats, k.stats):
            setattr(st, field, getattr(st, field) + 1)
            if gbps:
                st.cxl_bytes += nbytes
                st.sim_seconds += nbytes / (gbps * 1e9)

    def _evict_to_cxl_if_needed(self) -> None:
        while self._hbm_used > self.hbm_page_budget:
            used = np.flatnonzero((self._owner >= 0) & (self.tier == HBM))
            lru = used[self.last_use[used] == self.last_use[used].min()]
            victim = lru[np.lexsort((self._block[lru], self._kind[lru],
                                     self._owner[lru]))[0]]
            self.tier[victim] = CXL
            self._hbm_used -= 1
            self._count(self._kinds[self._kind[victim]], "demotions",
                        self.timing.cxl.payload_write_gbps)

    # -- sequence lifecycle ---------------------------------------------------
    def allocate(self, seq_id: int) -> None:
        if seq_id in self.seq_lens:
            raise KeyError(f"seq {seq_id} already allocated")
        for k in self._kinds:
            k.tables[seq_id] = []
        self.seq_lens[seq_id] = 0
        self._rank[seq_id] = self._next_rank
        self._next_rank += 1

    def release(self, seq_id: int) -> None:
        for k in self._kinds:
            for p in k.tables.pop(seq_id, []):
                self._hbm_used -= int(self.tier[p] == HBM)
                self._owner[p] = -1
                k.free.append(p)
        self.seq_lens.pop(seq_id, None)
        self._rank.pop(seq_id, None)

    def append_tokens(self, seq_id: int, layer: int, k_new,
                      v_new=None, n_tokens: Optional[int] = None) -> None:
        """Append `n_tokens` (default: the rows given) to pool `layer` for
        `seq_id`, with (T, K, hd) keys / (T, K, v_width) values (tensors or
        arrays) for the last T of them (all of them unless the pool is a
        ring; for the latent pool, (T, 1, width) rows, values ignored).

        The bookkeeping walks the tokens one by one, as the reference (a
        ring's token p on slot p mod its length); the T rows are then
        written into the pools with one indexed copy each.  The sequence's
        length advances with the last pool's append.
        """
        with span("kv.append_tokens"):
            k = self._pools[layer]
            rows = k_new.shape[0]
            t = rows if n_tokens is None else n_tokens
            slots = (None if k.spec.ring is None
                     else k.spec.ring * self.page_size)
            if rows > t or (slots is None and rows != t) \
                    or (slots is not None and rows > slots):
                raise ValueError(f"{rows} rows for {t} tokens of a "
                                 f"{k.spec.name} pool")
            table = k.tables[seq_id]
            pos = self.seq_lens[seq_id]
            self.clock += 1
            pages, offs = [], []
            try:
                for i in range(t):
                    p = pos + i if slots is None else (pos + i) % slots
                    blk, off = divmod(p, self.page_size)
                    if blk >= len(table):
                        if not k.free:
                            raise MemoryError("KV pool exhausted")
                        pg = k.free.pop()
                        table.append(pg)
                        self.tier[pg] = HBM
                        self._owner[pg] = self._rank[seq_id]
                        self._block[pg] = blk
                        self._hbm_used += 1
                        self._count(k, "allocs")
                        self._evict_to_cxl_if_needed()
                    pg = table[blk]
                    self.last_use[pg] = self.clock
                    if i >= t - rows:
                        pages.append(pg - k.base)
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
            if layer == len(self._pools) - 1:
                self.seq_lens[seq_id] = pos + t

    # -- decode-side access ----------------------------------------------------
    def gather_args(self, seq_ids: List[int], layer: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(block_table (B, blocks), context_lens (B,)) int32 tensors on
        the cache's device for the kernel over pool `layer` (its kind's
        page ids; ``max_blocks`` blocks, or a ring's pages with the
        lengths capped at the ring), charging CXL fetches and promoting hot
        pages."""
        with span("kv.gather_args"):
            k = self._pools[layer]
            ring = k.spec.ring
            blocks = self.max_blocks if ring is None else ring
            cap = None if ring is None else ring * self.page_size
            self.clock += 1
            bt = np.zeros((len(seq_ids), blocks), np.int32)
            cl = np.zeros((len(seq_ids),), np.int32)
            hits = 0
            for row, sid in enumerate(seq_ids):
                table = k.tables[sid]
                n = self.seq_lens[sid]
                cl[row] = n if cap is None else min(n, cap)
                for i, pg in enumerate(table[:blocks]):
                    bt[row, i] = pg - k.base
                    self.last_use[pg] = self.clock
                    if self.tier[pg] == CXL:
                        self._count(k, "cxl_fetches",
                                    self.timing.cxl.payload_read_gbps)
                        if self._hbm_used < self.hbm_page_budget:
                            self.tier[pg] = HBM          # promote while hot
                            self._hbm_used += 1
                            self._count(k, "promotions")
                    else:
                        hits += 1
            for st in (self.stats, k.stats):
                st.hbm_hits += hits
            return (torch.from_numpy(bt).to(self.device),
                    torch.from_numpy(cl).to(self.device))

    def tier_histogram(self) -> Dict[str, int]:
        used = [p for k in self._kinds for t in k.tables.values() for p in t]
        return {"hbm_pages": int(sum(1 for p in used if self.tier[p] == HBM)),
                "cxl_pages": int(sum(1 for p in used if self.tier[p] == CXL)),
                "free_pages": sum(len(k.free) for k in self._kinds)}

    def kind_report(self) -> Dict[str, Dict]:
        """Per kind: its live ``pages`` and its :class:`KVStats` (the
        counters of :attr:`stats` are their sums)."""
        return {k.spec.name: dict(
                    pages=sum(len(t) for t in k.tables.values()),
                    **dataclasses.asdict(k.stats))
                for k in self._kinds}
