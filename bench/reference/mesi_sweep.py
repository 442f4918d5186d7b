"""Plain NumPy reference of a static placement sweep on the Table-I host.

Rebuilds each row's trace from the generator parameters the benchmark hands
over (STREAM kernel, footprint, placement), runs a two-level MESI hierarchy
with LRU replacement over it, and closes the analytic timing fixed point.
It imports nothing of the program: the semantics are restated here from the
configuration file.

The hierarchy (one core; a line is 64 B, addresses are line indices):

- L1 (``l1_sets`` x ``l1_ways``) and an inclusive L2 (``l2_sets`` x
  ``l2_ways``), both indexed by the low bits of the line address.  Every
  line holds a tag, a last-use clock and a MESI state (I 0, S 1, E 2, M 3);
  an L2 line also holds the memory target it was filled from.
- The clock of access ``j`` (0-based) of a row is ``j + 1``; an empty way
  has clock 0, so it goes first.  Ties in a tag match or an LRU choice go to
  the lowest way.  The LRU victim is chosen over all ways, invalid ones with
  their old clock included.
- An access looks up L1.  On a miss the L1 victim, if valid, is written
  back into its L2 line (marked M when dirty).  Then L2 is looked up; on an
  L2 miss its victim, if valid, back-invalidates its L1 copies and is
  written to memory when it or an L1 copy is dirty; the line is filled in
  state E with the access's target.  An L2 access on an L1 miss refreshes
  the L2 clock.  The L1 line is installed or updated with the clock, in
  state M on a write and E on a read miss (one core never shares).

Sets of the two levels nest, so the trace splits into ``min(l1_sets,
l2_sets)`` independent chains by the low address bits; the simulation steps
every chain of every row at once, one access per chain and step, in plain
PyTorch on the device it is given.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

I_, S_, E_, M_ = 0, 1, 2, 3
STAT_NAMES = ("l1_hit", "l1_miss", "l2_hit", "l2_miss", "mem_read_dram",
              "mem_read_cxl", "mem_write_dram", "mem_write_cxl", "upgrades",
              "invalidations", "back_invalidations", "writebacks_l1")


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------
STREAM_PATTERN = {"copy": ((1,), 0), "scale": ((1,), 0), "add": ((0, 1), 2),
                  "triad": ((1, 2), 0)}


def stream_layout(footprint_bytes: int, t: Dict) -> Tuple[int, int, int]:
    """(elements per array, lines per array, pages) of the three
    page-aligned, contiguous STREAM arrays whose joint footprint is
    ``footprint_bytes`` (rounded down to whole elements)."""
    elem, line, page = t["elem_bytes"], t["line_bytes"], t["page_bytes"]
    n = max(footprint_bytes // (3 * elem), line // elem)
    lines = -(-n * elem // line)
    per_page = page // line
    lines = -(-lines // per_page) * per_page
    return n, lines, 3 * lines // per_page


def stream_trace(kernel: str, footprint_bytes: int, t: Dict
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(line address int64, is_write bool, pages) of one STREAM pass:
    element ``i`` makes its reads, then its write."""
    reads, write = STREAM_PATTERN[kernel]
    n, lines, pages = stream_layout(footprint_bytes, t)
    per_line = t["line_bytes"] // t["elem_bytes"]
    col = np.arange(n, dtype=np.int64) // per_line
    addr = np.stack([r * lines + col for r in reads] + [write * lines + col],
                    axis=1).reshape(-1)
    is_write = np.tile(np.array([False] * len(reads) + [True]), n)
    return addr, is_write, pages


def placement_tiers(placement: Dict, n_pages: int) -> np.ndarray:
    """Target (0 DRAM, 1 CXL) of every page under a placement."""
    page = np.arange(n_pages, dtype=np.int64)
    if placement["kind"] == "znuma":
        # membind: the first pages on DRAM, the rest on the zNUMA node
        n_dram = int(round(n_pages * (1.0 - placement["cxl_fraction"])))
        return (page >= n_dram).astype(np.int64)
    if placement["kind"] == "interleave":
        d, c = placement["dram_weight"], placement["cxl_weight"]
        return (page % (d + c) >= d).astype(np.int64)
    raise ValueError(f"unknown placement {placement['kind']!r}")


# ---------------------------------------------------------------------------
# The hierarchy
# ---------------------------------------------------------------------------
def simulate(traces: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
             cache: Dict, n_targets: int = 2, device="cpu",
             graph_steps: int = 64) -> np.ndarray:
    """Counters (rows, 8 + 2 n_targets) int64 of each (addr, is_write,
    target) trace, each row from an empty hierarchy; columns as
    :data:`STAT_NAMES` for two targets.  Runs in plain PyTorch on
    `device`, one access of every chain a step; on a CUDA device the steps
    replay as CUDA graphs of `graph_steps` each."""
    if cache["cores"] != 1:
        raise ValueError("the reference models one core")
    line = cache["line_bytes"]
    s1n = cache["l1_bytes"] // (cache["l1_ways"] * line)
    s2n = cache["l2_bytes"] // (cache["l2_ways"] * line)
    w1n, w2n = cache["l1_ways"], cache["l2_ways"]
    chains = min(s1n, s2n)
    shift = chains.bit_length() - 1
    s1, s2 = s1n // chains, s2n // chains

    # one lane per (row, chain): its accesses in trace order, with their clock
    lane_cols = []
    for addr, is_write, tier in traces:
        clock = np.arange(1, len(addr) + 1, dtype=np.int64)
        chain = addr & (chains - 1)
        order = np.argsort(chain, kind="stable")
        counts = np.bincount(chain, minlength=chains)
        lane_cols.append((addr[order], is_write[order], tier[order],
                          clock[order], counts))
    L = len(traces) * chains
    depth = max(int(c[4].max()) for c in lane_cols)
    A = np.full((depth, L), -1, np.int32)
    W = np.zeros((depth, L), bool)
    TR = np.zeros((depth, L), np.int32)
    T = np.zeros((depth, L), np.int32)
    for r, (a, w, tr, t, counts) in enumerate(lane_cols):
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lane = r * chains + np.repeat(np.arange(chains), counts)
        pos = np.arange(len(a)) - np.repeat(starts, counts)
        A[pos, lane], W[pos, lane], TR[pos, lane], T[pos, lane] = a, w, tr, t
    dev = torch.device(device)
    A, W, TR, T = (torch.from_numpy(x).to(dev) for x in (A, W, TR, T))

    i32 = torch.int32
    lanes = torch.arange(L, device=dev)
    # every line packed: L1 [tag, clock, state], L2 [tag, clock, state,
    # target]; sets lane-major, so a lane's set k is set lane * s + k
    l1 = torch.zeros((L * s1 * w1n, 3), dtype=i32, device=dev)
    l2 = torch.zeros((L * s2 * w2n, 4), dtype=i32, device=dev)
    l1[:, 0] = -1
    l2[:, 0] = -1
    l1s, l2s = l1.view(L * s1, w1n, 3), l2.view(L * s2, w2n, 4)
    st = torch.zeros((L, 8 + 2 * n_targets), dtype=torch.int64, device=dev)
    wb = 4 + n_targets

    def first(mask):
        return mask.to(i32).argmax(dim=-1)

    def set1(a):
        return lanes * s1 + ((a >> shift) & (s1 - 1))

    def set2(a):
        return lanes * s2 + ((a >> shift) & (s2 - 1))

    def step(a, w, tr, t):
        v = a >= 0
        r1 = set1(a)
        rows = l1s[r1]
        hits = (rows[..., 0] == a[:, None]) & (rows[..., 2] != I_)
        hit = hits.any(dim=1)
        i1 = r1 * w1n + torch.where(hit, first(hits),
                                    rows[..., 1].argmin(dim=1))
        etag, cur = l1[i1, 0], l1[i1, 2]
        # the L1 victim's writeback into its L2 line
        ev = ~hit & (cur != I_) & v
        edirty = ev & (cur == M_)
        er2 = set2(etag)
        ehits = l2s[er2][..., 0] == etag[:, None]
        ei = er2 * w2n + first(ehits)
        l2[ei, 2] = torch.where(edirty & ehits.any(dim=1), M_, l2[ei, 2])
        # L2 lookup
        r2 = set2(a)
        rows2 = l2s[r2]
        hits2 = rows2[..., 0] == a[:, None]
        raw = hits2.any(dim=1)
        i2 = r2 * w2n + torch.where(raw, first(hits2),
                                    rows2[..., 1].argmin(dim=1))
        vtag, vuse, vst, vtier = l2[i2].unbind(dim=1)
        l2_hit = raw & ~hit & v
        l2_miss = ~raw & ~hit & v
        vvalid = l2_miss & (vst != I_) & (vtag != a)
        # back-invalidation of the L2 victim's L1 copies
        vr1 = set1(vtag)
        crows = l1s[vr1]
        copies = ((crows[..., 0] == vtag[:, None]) & (crows[..., 2] != I_)
                  & vvalid[:, None])
        l1s[vr1, :, 2] = torch.where(copies, I_, crows[..., 2])
        vdirty = vvalid & ((vst == M_)
                           | (copies & (crows[..., 2] == M_)).any(dim=1))
        # fill or touch the L2 line
        l2[i2] = torch.stack([
            torch.where(l2_miss, a, vtag),
            torch.where(l2_hit | l2_miss, t, vuse),
            torch.where(l2_miss, E_, vst),
            torch.where(l2_miss, tr, vtier)], dim=1).to(i32)
        # install or update the L1 line
        new = torch.where(w, M_, torch.where(hit, cur, E_))
        l1[i1] = torch.where(v[:, None], torch.stack([a, t, new], dim=1)
                             .to(i32), l1[i1])
        cols = ([hit & v, ~hit & v, l2_hit, l2_miss]
                + [l2_miss & (tr == k) for k in range(n_targets)]
                + [vdirty & (vtier == k) for k in range(n_targets)]
                + [hit & w & (cur == S_) & v, torch.zeros_like(v)])
        st[:] += torch.cat([torch.stack(cols, dim=1).to(torch.int64),
                            copies.sum(dim=1, keepdim=True),
                            edirty[:, None].to(torch.int64)], dim=1)

    if dev.type != "cuda":
        for j in range(depth):
            step(A[j], W[j], TR[j], T[j])
    else:
        # the same steps, `graph_steps` to a CUDA graph: a padded step (all
        # addresses -1) changes nothing, so the tail and the warm-up are
        # inert
        k = graph_steps
        pad = -depth % k
        if pad:
            A = torch.cat([A, A.new_full((pad, L), -1)])
            W, TR, T = (torch.cat([x, x.new_zeros((pad, L))])
                        for x in (W, TR, T))
        buf = [x[:k].clone().fill_(-1 if x is A else 0)
               for x in (A, W, TR, T)]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):
                step(*(b[0] for b in buf))
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(k):
                step(*(b[i] for b in buf))
        for j in range(0, A.shape[0], k):
            for b, x in zip(buf, (A, W, TR, T)):
                b.copy_(x[j:j + k])
            graph.replay()
    out = st.reshape(len(traces), chains, -1).sum(dim=1)
    return out.cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------
def _queue(idle, service, rho, rho_max, dt):
    rho = np.maximum(np.minimum(rho, dt(rho_max)), dt(0.0))
    return dt(idle) + dt(service) * rho / (dt(2.0) * (dt(1.0) - rho))


def cxl_path(cxl: Dict, dram_idle_ns: float, line_bytes: int
             ) -> Tuple[float, float, float]:
    """(idle ns, read payload GB/s, write payload GB/s) of the CXL.mem path
    from its stages: a request and its response each cross packetizer,
    link and de-packetizer, plus one device DDR access and half the host's
    DRAM latency; a line takes a header slot and four data slots of a
    68-B flit's 17-B slots on the wire, and the device DDR caps it."""
    one_way = cxl["packetize_ns"] + cxl["link_prop_ns"] + cxl["depacketize_ns"]
    idle = 2.0 * one_way + cxl["backend_ns"] + dram_idle_ns / 2
    wire = cxl["lanes"] * cxl["lane_gbps"]
    per_line = (cxl["slots_header"] + cxl["slots_data"]) * cxl["slot_wire_bytes"]
    pay = min(wire * (line_bytes / per_line), cxl["backend_gbps"])
    return idle, pay, pay


def time_rows(stats: np.ndarray, cpus: Sequence[Dict], timing: Dict,
              dtype=np.float64, mig: np.ndarray = None
              ) -> List[Dict[str, float]]:
    """The timing fixed point of each counter row under its CPU model, in
    `dtype`: the instructions' time plus the L2 hits' service plus, per
    memory target, the larger of its misses' loaded latency over the CPU's
    memory-level parallelism and its bytes over its bandwidth, where the
    loaded latency follows an M/D/1 curve of the offered load; iterated
    until the runtime moves by less than a millionth (at most 8 times).
    `mig` (rows, 2, 2), the lines each row migrated, read and written per
    target, adds to each target's traffic; each row then has
    ``migration_gbps``, the migrated bytes over the runtime."""
    dt = dtype
    s = stats.astype(np.int64)
    b = s.shape[0]
    line = dt(timing["line_bytes"])
    dram, cxl = timing["dram"], timing["cxl"]
    cxl_idle, cxl_read, cxl_write = cxl_path(cxl, dram["idle_ns"],
                                             timing["line_bytes"])
    ipc = np.array([c["ipc_core"] for c in cpus], dt)
    freq = np.array([c["freq_ghz"] for c in cpus], dt)
    l2ns = np.array([c["l2_hit_ns"] for c in cpus], dt)
    mlp = np.array([1.0 if c["kind"] == "inorder" else c["mlp"]
                    for c in cpus], dt)
    n_acc = (s[:, 0] + s[:, 1]).astype(dt)
    reads = [s[:, 4].astype(dt), s[:, 5].astype(dt)]
    writes = [s[:, 6].astype(dt), s[:, 7].astype(dt)]
    if mig is not None:
        mig = np.asarray(mig, np.int64)
        reads = [reads[k] + mig[:, 0, k].astype(dt) for k in range(2)]
        writes = [writes[k] + mig[:, 1, k].astype(dt) for k in range(2)]
        mig_bytes = mig.sum(axis=(1, 2)).astype(dt) * line
    lines = [reads[k] + writes[k] for k in range(2)]
    nbytes = [x * line for x in lines]
    # the CXL payload blends its read and write rates by the read share
    rf = reads[1] / np.maximum(lines[1], dt(1.0))
    peak = [dt(dram["channels"] * dram["channel_gbps"]),
            rf * dt(cxl_read) + (dt(1) - rf) * dt(cxl_write)]
    idle = [dt(dram["idle_ns"]), dt(cxl_idle)]
    service = [dram["service_ns"], cxl["service_ns"]]
    base = n_acc / (ipc * freq) + s[:, 2].astype(dt) * l2ns / mlp
    t = np.maximum(base, dt(1.0))
    lat = [np.full(b, idle[k], dt) for k in range(2)]
    done = np.zeros(b, bool)
    for _ in range(8):
        stall = np.zeros(b, dt)
        for k in range(2):
            offered = nbytes[k] / np.maximum(t, dt(1.0))
            loaded = _queue(idle[k], service[k], offered / peak[k],
                            timing["rho_max"], dt)
            has = lines[k] > 0
            lat[k] = np.where(done | ~has, lat[k], loaded)
            t_lat = lines[k] * lat[k] / mlp
            t_bw = nbytes[k] / peak[k]
            stall = stall + np.where(has, np.maximum(t_lat, t_bw), dt(0.0))
        t_new = base + stall
        newly = ~done & (np.abs(t_new - t) / np.maximum(t, dt(1.0))
                         < dt(1e-6))
        t = np.where(done, t, t_new)
        done |= newly
        if done.all():
            break
    ach = [nbytes[k] / np.maximum(t, dt(1.0)) for k in range(2)]
    rows = []
    for i in range(b):
        l2a = max(int(s[i, 2] + s[i, 3]), 1)
        rows.append({
            "time_ns": float(np.where(n_acc[i] > 0, t[i], dt(0.0))),
            "bw_total_gbps": float(ach[0][i] + ach[1][i]),
            "bw_dram_gbps": float(ach[0][i]),
            "bw_cxl_gbps": float(ach[1][i]),
            "l2_miss_rate": float(s[i, 3]) / l2a,
            "lat_dram_ns": float(lat[0][i]),
            "lat_cxl_ns": float(lat[1][i]),
        })
        if mig is not None:
            rows[-1]["migration_gbps"] = float(mig_bytes[i]
                                               / max(t[i], dt(1.0)))
    return rows


TIMED_KEYS = ("time_ns", "bw_total_gbps", "bw_dram_gbps", "bw_cxl_gbps",
              "l2_miss_rate", "lat_dram_ns", "lat_cxl_ns")


def sweep_rows(grid: Dict, config: Dict, dtype=np.float64,
               device="cpu") -> List[Dict]:
    """The sweep's rows, in the program's order (footprint x placement x
    CPU model): each with ``stats`` (dict of :data:`STAT_NAMES`) and the
    timed columns of :data:`TIMED_KEYS`.  A grid with ``workloads`` and
    ``tiering`` is a dynamic-tiering sweep (:mod:`dyn_sweep`)."""
    if "tiering" in grid:
        from reference import dyn_sweep
        return dyn_sweep.tiering_rows(grid, config, simulate, time_rows,
                                      placement_tiers, STAT_NAMES, dtype,
                                      device)
    cache, tr = config["cache"], config["trace"]
    traces, cells = [], []
    for k in grid["footprint_x_l2"]:
        addr, is_write, pages = stream_trace(grid["kernel"],
                                             k * cache["l2_bytes"], tr)
        page = np.minimum(addr // (tr["page_bytes"] // tr["line_bytes"]),
                          pages - 1)
        for pl in grid["placements"]:
            traces.append((addr, is_write, placement_tiers(pl, pages)[page]))
            cells.append(k)
    stats = simulate(traces, cache, device=device)
    rep = np.repeat(stats, len(grid["cpus"]), axis=0)
    cpus = [c for _ in cells for c in grid["cpus"]]
    timed = time_rows(rep, cpus, config["timing"], dtype)
    labels = [(k, c["kind"]) for k in cells for c in grid["cpus"]]
    return [{"footprint_x_l2": k, "cpu": cpu,
             "stats": dict(zip(STAT_NAMES, map(int, s))), **r}
            for (k, cpu), s, r in zip(labels, rep, timed)]
