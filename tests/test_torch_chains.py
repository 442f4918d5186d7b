"""The chain split the MESI kernels rely on, pinned through the plain versions.

Set counts are powers of two and set indices are address masks, so with
m = min(l1_sets, l2_sets) the accesses of line `a` touch only sets whose
index is `a` modulo m.  A row therefore splits into m chains, `a & (m - 1)`,
that share no cache state; `csrc/mesi.cu` and `csrc/mesi_dyn.cu` walk them
on separate warps with the whole row's clock.  Here each chain's run is the
row with every access outside the chain replaced by the sentinel (the clock
still counts it), through the plain version; the chains' sets, put back
together, and their counter deltas, summed, must equal the whole-row run
bitwise.  Geometries: L1 sets above, below and equal to L2 sets, and m = 1;
1, 2 and 4 cores; sentinels mid-row and live negative addresses.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import cache as tcache
from repro_torch.core import tiering_dyn
from repro_torch.kernels import cache_sim as tkernels

S = tcache.SENTINEL
GEOMETRIES = {
    # name: (geometry, log2 m)
    "golden": (dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024,
                    l2_ways=8), 5),          # 64 L1 sets > 32 L2 sets
    "small": (dict(l1_bytes=1024, l1_ways=2, l2_bytes=4096, l2_ways=4),
              3),                            # 8 L1 sets < 16 L2 sets
    "equal": (dict(l1_bytes=2048, l1_ways=2, l2_bytes=8192, l2_ways=8),
              4),                            # 16 sets each
    "one": (dict(l1_bytes=256, l1_ways=4, l2_bytes=4096, l2_ways=4),
            0),                              # a single L1 set: m = 1
}


def geometry(name, cores, n_targets=3):
    kw, bits = GEOMETRIES[name]
    p = tcache.CacheParams(**kw, cores=cores, n_targets=n_targets)
    assert tkernels.chain_bits(p) == bits
    return p, bits


def rows(seed, b, n, p, negative=True):
    """(b, n) int32 fields: addresses crowded over 4x the L2's lines (so
    lines are evicted, written back and back-invalidated), a sentinel run
    mid-row, live negative addresses where `negative`."""
    rng = np.random.default_rng(seed)
    lines = 4 * p.l2_sets * p.l2_ways
    addr = rng.integers(-48 if negative else 0, lines, (b, n))
    addr[addr == S] = 3
    addr[0, n // 3:n // 3 + 25] = S
    addr[-1, n - 7:] = S
    return [torch.from_numpy(x.astype(np.int32)) for x in (
        addr, rng.integers(0, 2, (b, n)),
        rng.integers(0, p.cores, (b, n)),
        rng.integers(0, p.n_targets, (b, n)))]


def per_chain(trace, bits):
    """The (m * B, ...) batch of chain runs, chain-major: row k * B + r is
    row r with every access outside chain k made a sentinel."""
    addr, *fields = trace
    m = 1 << bits
    key = addr & (m - 1)
    masked = torch.cat([torch.where((key == k) & (addr != S), addr, S)
                        for k in range(m)])
    return [masked] + [torch.cat([f] * m) for f in fields]


def repeat(x, m):
    return torch.cat([x] * m)


def chain_sets(runs, before, bits, set_axis):
    """Each set taken from the run of its chain; every other chain's run
    left it as it was."""
    m = 1 << bits
    runs = runs.reshape((m,) + before.shape)
    out = before.clone()
    for s in range(before.shape[set_axis]):
        k = s & (m - 1)
        idx = (slice(None),) * set_axis + (s,)
        out[idx] = runs[k][idx]
        for j in range(m):
            if j != k:
                assert torch.equal(runs[j][idx], before[idx]), \
                    f"chain {j} touched set {s} of chain {k}"
    return out


def summed(runs, before, bits):
    """`before` plus each chain's delta."""
    deltas = runs.reshape((1 << bits,) + before.shape) - before
    return before + deltas.sum(dim=0, dtype=torch.int32)


@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("cores", [1, 2, 4])
def test_mesi_segment_chains_reassemble_the_row(name, cores):
    p, bits = geometry(name, cores)
    b, n, warm = 2, 480, 150
    trace = rows(10 * list(GEOMETRIES).index(name) + cores, b, n + warm, p)
    carry = tcache.init_batch_carry(p, b)
    if name == "golden":    # continue a carry: t0 = 1 + warm, state warm
        carry = tkernels.mesi_segment_ref(
            carry, *[x[:, :warm] for x in trace], params=p)
        assert int(carry[3][0]) == 1 + warm
    trace = [x[:, warm:].contiguous() for x in trace]
    whole = tkernels.mesi_segment_ref(carry, *trace, params=p)

    m = 1 << bits
    runs = tkernels.mesi_segment_ref(tuple(repeat(x, m) for x in carry),
                                     *per_chain(trace, bits), params=p)
    l1p = chain_sets(runs[0], carry[0], bits, set_axis=2)
    l2p = chain_sets(runs[1], carry[1], bits, set_axis=1)
    stats = summed(runs[2], carry[2], bits)
    assert torch.equal(runs[3], repeat(whole[3], m))
    for got, want, what in ((l1p, whole[0], "l1p"), (l2p, whole[1], "l2p"),
                            (stats, whole[2], "stats")):
        assert torch.equal(got, want), what
    s = whole[2]
    assert int(s[:, tcache.L1_HIT].sum()) and int(s[:, tcache.L2_MISS].sum())
    if cores > 1:
        assert int(s[:, tcache.coherence_base(3) + 1].sum())


# (geometry, cores) of the epoch-kernel cases, one per geometry
DYN_CASES = [("golden", 2), ("small", 1), ("equal", 4), ("one", 2)]


def dyn_rows(p, seed, n_p, e, slot):
    """Three rows: static (period 3, so the segment ends an epoch mid-way),
    sampled (measure one slot of every 3, warm one) and dynamic with budget
    2 under a period no slot of the segment ends."""
    b = 3
    trace = rows(seed, b, e * slot, p)
    trace[0] = torch.where(trace[0] < 0, trace[0], trace[0] % (64 * n_p))
    trace = [x.reshape(b, e, slot) for x in trace]
    rng = np.random.default_rng(seed + 1)

    def col(*v):
        return torch.tensor(v, dtype=torch.int32)

    ptl = torch.from_numpy(rng.integers(0, 40, (b, n_p, p.n_targets))
                           .astype(np.int32))
    scalars = (col(0, 0, 1), col(n_p, n_p, n_p), col(0, 0, 2),
               col(1, 1, 1), col(3, 1, 100), col(*[1 << 30] * 3),
               col(0, 0, 0), col(*[1 << 30] * 3), ptl, col(0, 1, 0),
               col(0, 1, 0), col(0, 3, 0))
    pmap0 = torch.from_numpy(rng.integers(0, 2, (b, n_p)).astype(np.int32))
    return trace, scalars, pmap0


@pytest.mark.parametrize("name,cores", DYN_CASES)
def test_mesi_dyn_segment_chains_reassemble_the_row(name, cores):
    p, bits = geometry(name, cores)
    n_p, e, slot = 12, 4, 120
    trace, scalars, pmap0 = dyn_rows(p, 7 * cores, n_p, e, slot)
    b = trace[0].shape[0]
    kw = dict(params=p, k_max=8, count_bound=100 * slot + 1)
    carry = tiering_dyn.init_dyn_carry(p, pmap0)
    if name == "golden":    # continue a carry: t0 != 1, counts warm
        carry, *_ = tkernels.mesi_dyn_segment_ref(
            carry, *[x[:, :1] for x in trace], *scalars, **kw)
        trace = [x[:, 1:].contiguous() for x in trace]
        e -= 1
        assert int(carry[3][0]) == 1 + slot and int(carry[8][0]) == 1
    whole, w_slots, w_snaps, w_meas = tkernels.mesi_dyn_segment_ref(
        carry, *trace, *scalars, **kw)

    m = 1 << bits
    flat = per_chain([x.reshape(b, e * slot) for x in trace], bits)
    runs, slots, snaps, meas = tkernels.mesi_dyn_segment_ref(
        tuple(repeat(x, m) for x in carry),
        *[x.reshape(m * b, e, slot) for x in flat],
        *[repeat(x, m) for x in scalars], **kw)
    l1p = chain_sets(runs[0], carry[0], bits, set_axis=2)
    l2p = chain_sets(runs[1], carry[1], bits, set_axis=1)
    stats = summed(runs[2], carry[2], bits)
    # counts: each chain's run resets them at a boundary, as the whole
    # row's does; rows whose segment ends no epoch keep the carried counts
    eidx0, per = carry[8], scalars[4]
    ends = (eidx0 % per + e >= per)[:, None]
    counts = torch.where(ends, runs[5].reshape(m, b, n_p).sum(0,
                                                              dtype=torch.int32),
                         summed(runs[5], carry[5], bits))
    assert bool(ends[0]) and not bool(ends[2])
    got = (l1p, l2p, stats, runs[3][:b], runs[4][:b], counts, runs[6][:b],
           runs[7][:b], runs[8][:b])
    names = ("l1p", "l2p", "stats", "t", "page_map", "counts", "mig_rd",
             "mig_wr", "eidx")
    for g, w, what in zip(got, whole, names):
        assert torch.equal(g, w), what
    for k in range(m):      # page maps, migration and clocks per chain
        for i in (3, 4, 6, 7, 8):
            assert torch.equal(runs[i][k * b:(k + 1) * b], whole[i]), names[i]
    assert torch.equal(slots.reshape(m, b, e, 4).sum(0, dtype=torch.int32),
                       w_slots)
    snaps0 = carry[2][:, None, :].expand(b, e, -1)
    assert torch.equal(summed(snaps, snaps0, bits), w_snaps)
    assert torch.equal(meas, repeat(w_meas, m))
    assert int(w_slots[..., 0].sum()) > 0 and int(w_meas[1].sum()) < e
    assert int(whole[5].sum()) > 0
