"""Plain NumPy reference of a dynamic-tiering sweep on the Table-I host.

Rebuilds each row's trace from the workload parameters the benchmark hands
over (hot/cold, GUPS, and the KV-decode gathers of a paged KV cache under a
continuous batcher), replays the epoch-based tierer over it, then runs
:func:`mesi_sweep.simulate` on the per-access targets that the evolving page
map gives and closes the timing fixed point with the migration traffic.  It
imports nothing of the program: the semantics are restated here.

The tierer (two tiers: 0 DRAM, 1 CXL; pages of ``page_bytes``):

- The trace is cut into slots of the sweep's slot length (the gcd of the
  tiering points' epoch lengths), padded at the end with empty accesses to
  the longest row of the sweep.  An epoch is ``epoch_len / slot`` slots.
- Within a slot every access goes to DRAM when its page maps to DRAM, else
  to CXL; each page counts its accesses.
- After an epoch's last slot, when the budget is above 0: the CXL pages
  counted at least ``threshold`` times are hot.  Pages rank by count, more
  first, ties to the lower page.  ``min(budget, hot)`` pages are wanted;
  the DRAM pages beyond the free DRAM capacity are demoted first, coldest
  first (the fewest counts, ties to the lower page), at most the budget;
  then the hottest ``min(hot, budget, free + demoted)`` pages are promoted.
  A promoted page reads its lines from CXL and writes them to DRAM; a
  demoted one the reverse.  Then every count goes back to 0.
- A row starts from the placement's page map, or, for a workload that
  carries its own tier per access, from each page's first access (pages
  never touched start on CXL).  A static row (no tiering point) keeps the
  targets of its placement or of its workload.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

MASK32 = 0xFFFFFFFF
UNBOUNDED_PAGES = 1 << 30
CXL = 1


# ---------------------------------------------------------------------------
# Workload traces: (line address int64, is_write bool, pages, tier or None)
# ---------------------------------------------------------------------------
def mix32(x: np.ndarray, seed: int) -> np.ndarray:
    """SplitMix-style 32-bit avalanche hash of each counter value."""
    x = np.asarray(x, np.uint32) ^ np.uint32(seed & MASK32)
    x = x * np.uint32(0x9E3779B1)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return (x ^ (x >> np.uint32(16))).astype(np.int64)


def _lines(footprint_bytes: int, t: Dict) -> int:
    return max(footprint_bytes // t["line_bytes"], 2)


def _pages(n_lines: int, t: Dict) -> int:
    return max(-(-n_lines // (t["page_bytes"] // t["line_bytes"])), 1)


def hot_cold(p: Dict, footprint_bytes: int, t: Dict):
    """A scattered hot page set takes ``hot_access_frac`` of the accesses,
    the rest fall anywhere; a quarter of them are writes."""
    lpp = t["page_bytes"] // t["line_bytes"]
    n_lines = _lines(footprint_bytes, t)
    n_pages = _pages(n_lines, t)
    n_hot = max(1, int(n_pages * p["hot_page_frac"]))
    stride = max(n_pages // n_hot, 1)
    hot_pages = (np.arange(n_hot, dtype=np.int64) * stride
                 + stride // 2) % n_pages
    ctr = np.arange(p["accesses_per_line"] * n_lines, dtype=np.int64)
    gate = mix32(ctr, p["seed"])
    pick = mix32(ctr, p["seed"] ^ 0x9E3779B9)
    off = mix32(ctr, p["seed"] ^ 0x7F4A7C15)
    to_hot = gate % 1024 < int(p["hot_access_frac"] * 1024)
    addr = np.where(to_hot, hot_pages[pick % n_hot] * lpp + off % lpp,
                    pick % n_lines)
    return (np.clip(addr, 0, n_lines - 1), (off >> 8) % 4 == 0, n_pages,
            None)


def gups(p: Dict, footprint_bytes: int, t: Dict):
    """Random read-modify-writes over the largest power-of-two table of
    lines that fits."""
    table = 1 << (_lines(footprint_bytes, t).bit_length() - 1)
    u = p["updates_per_line"] * table
    idx = mix32(np.arange(u, dtype=np.int64), p["seed"]) & (table - 1)
    return (np.repeat(idx, 2), np.tile(np.array([False, True]), u),
            _pages(table, t), None)


class _KVPool:
    """Paged KV bookkeeping: a free list, block tables, a tier per page
    (0 HBM, 1 CXL) under an HBM page budget, and a last-use clock."""

    def __init__(self, n_pages: int, page_size: int, hbm_budget: int):
        self.page_size, self.budget = page_size, hbm_budget
        self.free = list(range(n_pages))
        self.tier = np.zeros(n_pages, np.int64)
        self.last_use = np.zeros(n_pages, np.int64)
        self.tables: Dict[int, List[int]] = {}
        self.lens: Dict[int, int] = {}
        self.clock = 0

    def _hbm_used(self) -> List[int]:
        return [pg for tb in self.tables.values() for pg in tb
                if self.tier[pg] == 0]

    def _evict(self) -> None:
        # the least recently used HBM page goes to CXL (first one on ties)
        while len(self._hbm_used()) > self.budget:
            used = self._hbm_used()
            self.tier[min(used, key=lambda pg: self.last_use[pg])] = CXL

    def allocate(self, sid: int) -> None:
        self.tables[sid], self.lens[sid] = [], 0

    def release(self, sid: int) -> None:
        self.free.extend(self.tables.pop(sid, []))
        self.lens.pop(sid, None)

    def append(self, sid: int, n: int) -> None:
        table, pos = self.tables[sid], self.lens[sid]
        self.clock += 1
        for i in range(n):
            blk = (pos + i) // self.page_size
            if blk >= len(table):
                if not self.free:
                    raise MemoryError
                pg = self.free.pop()
                table.append(pg)
                self.tier[pg] = 0
                self._evict()
            self.last_use[table[blk]] = self.clock
        self.lens[sid] = pos + n

    def gather(self, sids: Sequence[int]) -> None:
        # every page of the gathered sequences is used now; a CXL page
        # comes back to HBM while the budget has room
        self.clock += 1
        for sid in sids:
            for pg in self.tables[sid]:
                self.last_use[pg] = self.clock
                if self.tier[pg] == CXL and len(self._hbm_used()) < \
                        self.budget:
                    self.tier[pg] = 0


def _kv_steps(p: Dict, footprint_bytes: int, line_bytes: int):
    """Run the continuous batcher over the pool and log each decode step's
    page reads (with their tier at that moment) and token writes."""
    g = p["kv_geometry"]
    page_bytes = p["page_size"] * g["n_kv_heads"] * g["head_dim"] * 2 * 2
    pool_n = max(4, min(footprint_bytes // page_bytes, p["max_pool_pages"]))
    ps = p["page_size"]
    kv = _KVPool(pool_n, ps, max(1, int(pool_n * p["hbm_fraction"])))
    lpp = max(page_bytes // line_bytes, 1)
    token_bytes = max(page_bytes // ps, 1)
    rng = np.random.default_rng(p["seed"])
    pool_tokens = pool_n * ps
    offered = min((footprint_bytes // page_bytes) * ps, 2 * pool_tokens)
    budget = max(offered // (p["n_requests"] + 2), 2 * ps)
    cap = max(pool_tokens // 2, ps + 1)
    waiting = []                 # [rid, prompt, new, arrived, generated]
    for rid in range(p["n_requests"]):
        prompt = int(rng.integers(budget // 2, budget + 1))
        new = int(rng.integers(budget // 4 + 1, budget // 2 + 1))
        if prompt + new > cap:
            prompt = max(1, cap - new)
        waiting.append([rid, prompt, new, 0, 0])
    running: List[list] = []
    steps = []

    def preempt() -> bool:
        if not running:
            return False
        victim = max(running, key=lambda r: r[3])
        running.remove(victim)
        kv.release(victim[0])
        victim[4] = 0
        waiting.insert(0, victim)
        return True

    def decode(sids):
        snap = kv.tier.copy()
        reads = [(pg, int(snap[pg] == CXL)) for s in sids
                 for pg in kv.tables[s]]
        kv.gather(sids)
        writes = []
        for s in sids:
            kv.append(s, 1)
            pos = kv.lens[s] - 1
            pg = kv.tables[s][pos // ps]
            off = min((pos % ps) * token_bytes // line_bytes, lpp - 1)
            writes.append((pg, off, int(kv.tier[pg] == CXL)))
        steps.append((reads, writes))

    n_steps = 0
    while (waiting or running) and n_steps < 2000:
        n_steps += 1
        req = None
        if waiting and len(running) < p["max_running"] and \
                -(-(waiting[0][1] + waiting[0][2]) // ps) <= len(kv.free):
            req = waiting.pop(0)
            kv.allocate(req[0])
            running.append(req)
        if req is not None:
            try:
                kv.append(req[0], req[1])
            except MemoryError:
                running.remove(req)
                kv.release(req[0])
                waiting.insert(0, req)
                if not preempt():
                    raise
            continue
        if not running:
            continue
        try:
            decode([r[0] for r in running])
        except MemoryError:
            if not preempt():
                raise
            continue
        for r in list(running):
            r[4] += 1
            if r[4] >= r[2]:
                running.remove(r)
                kv.release(r[0])
    return steps, lpp, pool_n * lpp


def kv_decode(p: Dict, footprint_bytes: int, t: Dict):
    """The decode steps' KV gathers, line by line: each step reads every
    page of each running sequence, then writes each sequence's new token;
    the tier is the page's at that moment."""
    steps, lpp, total_lines = _kv_steps(p, footprint_bytes,
                                        t["line_bytes"])
    addr, write, tier = [], [], []
    for reads, writes in steps:
        for pg, tr in reads:
            addr.extend(range(pg * lpp, (pg + 1) * lpp))
            write.extend([False] * lpp)
            tier.extend([tr] * lpp)
        for pg, off, tr in writes:
            addr.append(pg * lpp + off)
            write.append(True)
            tier.append(tr)
    return (np.asarray(addr, np.int64), np.asarray(write, bool),
            _pages(total_lines, t), np.asarray(tier, np.int64))


WORKLOADS = {"hot_cold": hot_cold, "gups": gups, "kv_decode": kv_decode}


def workload_trace(w: Dict, footprint_bytes: int, t: Dict):
    """The trace of one workload entry of a resolved grid."""
    return WORKLOADS[w["kind"]](dict(w["params"], **({"kv_geometry":
                                                      w["kv_geometry"]}
                                                     if "kv_geometry" in w
                                                     else {})),
                                footprint_bytes, t)


# ---------------------------------------------------------------------------
# The epoch replay
# ---------------------------------------------------------------------------
def first_touch(tier: np.ndarray, addr: np.ndarray, n_pages: int,
                lpp: int) -> np.ndarray:
    """Each page's tier at its first access; untouched pages on CXL."""
    page = np.clip(addr // lpp, 0, n_pages - 1)
    first = np.full(n_pages, len(addr), np.int64)
    np.minimum.at(first, page, np.arange(len(addr)))
    out = np.full(n_pages, CXL, np.int64)
    seen = first < len(addr)
    out[seen] = np.clip(tier[first[seen]], 0, 2)
    return out


def _ranked(mask: np.ndarray, count: np.ndarray, n: int) -> np.ndarray:
    """The first `n` pages of `mask`, more counts first, ties to the
    lower page."""
    pages = np.flatnonzero(mask)
    order = np.lexsort((pages, -count[pages]))
    return pages[order[:n]]


def replay(tiering: Dict, addr: np.ndarray, page_map0: np.ndarray,
           n_pages: int, slot: int, n_slots: int, lpp: int):
    """(per-access target, migration lines (2, 2) read / written per
    target, per-slot counters (n_slots, 4): accesses, DRAM accesses,
    promoted, demoted) of one row under one tiering point."""
    n, n_p = len(addr), len(page_map0)
    period = tiering["epoch_len"] // slot
    budget, threshold = tiering["budget"], tiering["threshold"]
    cap = tiering.get("dram_capacity_pages")
    cap = UNBOUNDED_PAGES if cap is None else cap
    cmax = period * slot + 1
    pmap = page_map0.copy()
    pvalid = np.arange(n_p) < n_pages
    a = np.full(n_slots * slot, -1, np.int64)
    a[:n] = addr
    page = np.clip(a // lpp, 0, n_p - 1)
    valid = a >= 0
    target = np.zeros(n_slots * slot, np.int64)
    counts = np.zeros(n_p, np.int64)
    mig = np.zeros((2, 2), np.int64)
    slots = np.zeros((n_slots, 4), np.int64)
    for e in range(n_slots):
        sl = slice(e * slot, (e + 1) * slot)
        pg, v = page[sl], valid[sl]
        intent = pmap[pg]
        target[sl] = np.where(intent == 0, 0, 1)
        slots[e, 0] = v.sum()
        slots[e, 1] = (v & (intent == 0)).sum()
        counts += np.bincount(pg[v], minlength=n_p)
        if (e + 1) % period:
            continue
        if budget > 0:
            hot = (pmap == 1) & pvalid & (counts >= threshold)
            dram = (pmap == 0) & pvalid
            n_want = min(budget, int(hot.sum()))
            free = max(cap - int(dram.sum()), 0)
            n_dem = min(max(n_want - free, 0), budget, int(dram.sum()))
            n_pro = min(int(hot.sum()), budget, free + n_dem)
            promote = _ranked(hot, counts, n_pro)
            demote = _ranked(dram, cmax - counts, n_dem)
            pmap[promote] = 0
            pmap[demote] = 1
            mig[0] += (n_dem * lpp, n_pro * lpp)    # read: DRAM, CXL
            mig[1] += (n_pro * lpp, n_dem * lpp)    # written: DRAM, CXL
            slots[e, 2:] = (n_pro, n_dem)
        counts[:] = 0
    return target[:n], mig, slots


def epoch_fractions(slots: np.ndarray, period: int) -> List[float]:
    """DRAM accesses over accesses of each epoch, trailing empty epochs
    left out."""
    out, last = [], -1
    for s in range(0, slots.shape[0], period):
        tot = int(slots[s:s + period, 0].sum())
        if tot:
            last = len(out)
        out.append(float(slots[s:s + period, 1].sum()) / tot if tot
                   else 0.0)
    return out[:last + 1]


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------
def grid_traces(grid: Dict, config: Dict):
    """{(workload index, footprint): trace} of a resolved grid."""
    l2, t = config["cache"]["l2_bytes"], config["trace"]
    return {(i, k): workload_trace(w, k * l2, t)
            for i, w in enumerate(grid["workloads"])
            for k in grid["footprint_x_l2"]}


def accesses_per_sweep(grid: Dict, config: Dict) -> int:
    """Simulated accesses of one sweep: every row's real trace length."""
    n = sum(len(tr[0]) for tr in grid_traces(grid, config).values())
    return n * len(grid["tiering"]) * len(grid["placements"])


def tiering_rows(grid: Dict, config: Dict, simulate, time_rows,
                 placement_tiers, stat_names, dtype=np.float64,
                 device="cpu") -> List[Dict]:
    """The sweep's rows in the program's order (tiering point x workload x
    footprint x placement x CPU model), each with ``stats``, the timed
    columns, and on tiering rows ``migrated_pages``, ``migration_gbps``
    and ``epoch_dram_frac``."""
    t = config["trace"]
    lpp = t["page_bytes"] // t["line_bytes"]
    traces = grid_traces(grid, config)
    p_max = max(tr[2] for tr in traces.values())
    dyn = [x for x in grid["tiering"] if x is not None]
    slot = math.gcd(*(x["epoch_len"] for x in dyn)) if dyn else 1
    n_slots = -(-max(len(tr[0]) for tr in traces.values()) // slot)
    sims, migs, extra, labels = [], [], [], []
    for tiering in grid["tiering"]:
        for i, w in enumerate(grid["workloads"]):
            for k in grid["footprint_x_l2"]:
                addr, is_write, n_pages, tier = traces[(i, k)]
                page = np.clip(addr // lpp, 0, n_pages - 1)
                for pl in grid["placements"]:
                    if tier is not None:
                        own, pmap0 = tier, first_touch(tier, addr, n_pages,
                                                       lpp)
                    else:
                        own = placement_tiers(pl, n_pages)[page]
                        pmap0 = (placement_tiers(pl, n_pages) != 0) \
                            .astype(np.int64)
                    if tiering is None:
                        target, mig, info = own, np.zeros((2, 2)), None
                    else:
                        pmap0 = np.concatenate(
                            [pmap0, np.full(p_max - n_pages, CXL)])
                        target, mig, slots = replay(
                            tiering, addr, pmap0, n_pages, slot, n_slots,
                            lpp)
                        info = {"migrated_pages": int(slots[:, 2:].sum()),
                                "epoch_dram_frac": epoch_fractions(
                                    slots, tiering["epoch_len"] // slot)}
                    sims.append((addr, is_write, target))
                    migs.append(mig)
                    extra.append(info)
                    labels.append((w["kind"], k))
    stats = simulate(sims, config["cache"], device=device)
    n_cpu = len(grid["cpus"])
    rep = np.repeat(stats, n_cpu, axis=0)
    mig = np.repeat(np.asarray(migs, np.int64), n_cpu, axis=0)
    cpus = [c for _ in sims for c in grid["cpus"]]
    timed = time_rows(rep, cpus, config["timing"], dtype, mig=mig)
    rows = []
    for j, (s, r) in enumerate(zip(rep, timed)):
        (kind, k), info = labels[j // n_cpu], extra[j // n_cpu]
        row = {"workload": kind, "footprint_x_l2": k, "cpu": cpus[j]["kind"],
               "stats": dict(zip(stat_names, map(int, s))), **r}
        if info is None:
            row.pop("migration_gbps")
        else:
            row.update(info)
        rows.append(row)
    return rows
