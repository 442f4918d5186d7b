"""The splits that K4's and K6's CUDA kernels rely on, pinned on the CPU.

K4 (``csrc/paged_attention.cu``) cuts each (sequence, kv head) context into
partitions, computes each partition's online-softmax state (m, l, acc) on
its own block, and combines the non-empty partitions in partition order,
rescaled by their largest m.  K6 (``csrc/cache_sim.cu``) groups the trace by
chain ``a & (m - 1)`` in trace order and walks each chain on one warp with
the access's 1-based trace position as its clock.  Neither kernel runs
here, so a test-local model of each split is held against the plain
versions and the JAX oracles (``repro.kernels.ref``): K4's within 3e-5
(f32 sums in another order), K6's bitwise.  The wrapper's choice of K4's
partitions (``split_plan``) and K6's chain count and pre-pass tile are held
too.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import cache_sim as tcs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa

H100_SMS = 132


# ---------------------------------------------------------------------------
# K4: split-K over the context
# ---------------------------------------------------------------------------
def split_model(q, kp, vp, bt, cl, parts, part_len):
    """K4's arithmetic as the kernel splits it, in f32: per partition the
    max m, the sum l and the unnormalised acc; then the combine of the
    non-empty partitions in order.  Empty contexts give 0."""
    b, h, d = q.shape
    _, page, kh, _ = kp.shape
    groups = h // kh
    out = np.zeros((b, h, d), np.float32)
    scale = np.float32(d ** -0.5)
    for s in range(b):
        ctx = min(max(int(cl[s]), 0), bt.shape[1] * page)
        pos = np.arange(ctx)
        rows = bt[s, pos // page], pos % page
        for k in range(kh):
            keys, vals = kp[rows + (k,)], vp[rows + (k,)]   # (ctx, D)
            for g in range(groups):
                hh = k * groups + g
                state = []
                for p in range(parts):
                    lo, hi = p * part_len, min((p + 1) * part_len, ctx)
                    if lo >= hi:
                        continue            # the block exits at once
                    logit = (keys[lo:hi] @ q[s, hh]) * scale
                    m = np.float32(logit.max())
                    e = np.exp(logit - m).astype(np.float32)
                    state.append((m, e.sum(dtype=np.float32),
                                  e @ vals[lo:hi]))
                if not state:
                    continue
                top = max(m for m, _, _ in state)
                w = [np.exp(np.float32(m - top)) for m, _, _ in state]
                l_sum = sum(wi * l for wi, (_, l, _) in zip(w, state))
                acc = sum(wi * a for wi, (_, _, a) in zip(w, state))
                out[s, hh] = acc / l_sum
    return out


def split_case(seed, part_len, page=16, nblk=12, b=8, h=8, kh=2, d=24):
    """Pools and queries with contexts 0, 1, part_len - 1, part_len,
    part_len + 1, the whole capacity and two random ones; every block
    table entry inside the pool (the JAX oracle gathers them all)."""
    rng = np.random.default_rng(seed)
    cap = nblk * page
    n_pages = b * nblk
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page, kh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page, kh, d)).astype(np.float32)
    bt = rng.permutation(n_pages).reshape(b, nblk).astype(np.int32)
    cl = np.array([0, 1, part_len - 1, part_len, part_len + 1, cap,
                   *rng.integers(1, cap + 1, b - 6)], np.int32)
    return q, kp, vp, bt, np.minimum(cl, cap).astype(np.int32)


@pytest.mark.parametrize("parts", [1, 2, 3, 16])
def test_split_k_model_matches_plain_version_and_jax_oracle(parts):
    page, nblk = 16, 12
    cap = nblk * page                           # 192 positions
    part_len = max(32, -(-cap // (parts * 32)) * 32)
    assert part_len % math.lcm(page, tpa.TILE) == 0
    assert parts * part_len >= cap
    q, kp, vp, bt, cl = split_case(parts, part_len, page, nblk)
    if parts == 16:                             # most partitions empty
        assert -(-cap // part_len) < parts
    got = split_model(q, kp, vp, bt, cl, parts, part_len)
    assert np.all(got[0] == 0) and np.isfinite(got).all()
    plain = tpa.paged_attention_ref(*map(torch.from_numpy,
                                         (q, kp, vp, bt, cl))).numpy()
    oracle = np.asarray(jref.paged_attention(*map(jnp.asarray,
                                                  (q, kp, vp, bt, cl))))
    np.testing.assert_allclose(got, plain, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got, oracle, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("groups", [1, 4, 16])
def test_split_k_model_over_the_wrappers_plan(groups):
    """The plan the wrapper picks at a card's width, on a long block table
    (each of B * K pairs split in several partitions), G query heads."""
    b, kh, page, nblk = 2, 1, 16, 64
    parts, part_len = tpa.split_plan(b, kh, nblk * page, page, H100_SMS)
    assert parts > 1
    q, kp, vp, bt, cl = split_case(groups, part_len, page, nblk, b=8,
                                   h=groups * kh, kh=kh, d=16)
    q, bt, cl = q[:b], bt[:b], cl[3:3 + b]       # contexts L and L + 1
    got = split_model(q, kp, vp, bt, cl, parts, part_len)
    plain = tpa.paged_attention_ref(*map(torch.from_numpy,
                                         (q, kp, vp, bt, cl))).numpy()
    np.testing.assert_allclose(got, plain, rtol=3e-5, atol=3e-5)


def plan_cost(b, kh, cap, page, sms, resident, part_len):
    """(fills the SMs FILL times?, tiles the busiest SM walks, parts) of a
    split into partitions of `part_len`, as split_plan ranks them."""
    parts = -(-cap // part_len)
    waves = -(-b * kh * parts // (sms * resident))
    return (b * kh * parts < tpa.FILL * sms, waves * part_len // tpa.TILE,
            parts)


def test_split_plan():
    # the serve loop's shapes (8 sequences, 8 kv heads, 6 blocks of 16):
    # one partition, no combine
    assert tpa.split_plan(8, 8, 6 * 16, 16, H100_SMS) == (1, 96)
    # the 4096-token decode with three f32 blocks (or four bf16 ones) per
    # SM: one wave of 384 (or 512) blocks
    assert tpa.split_plan(8, 8, 4096, 16, H100_SMS, 3) == (6, 704)
    assert tpa.split_plan(8, 8, 4096, 16, H100_SMS, 4) == (8, 512)
    for b, kh, cap, page, sms, res in [
            (8, 8, 4096, 16, 132, 2), (1, 1, 1, 16, 132, 3),
            (1, 8, 32768, 16, 132, 3), (3, 2, 1000, 48, 132, 1),
            (64, 8, 4096, 16, 132, 4), (2, 4, 0, 16, 132, 2),
            (4, 2, 2048, 64, 16, 6), (32, 8, 4096, 16, 132, 3)]:
        parts, part_len = tpa.split_plan(b, kh, cap, page, sms, res)
        unit = math.lcm(page, tpa.TILE)
        assert part_len % unit == 0 and parts * part_len >= cap >= 0
        # no partition lies wholly past a full context
        assert (parts - 1) * part_len < max(cap, 1)
        if parts == 1:
            continue
        # no other split ranks lower
        shortest = -(-tpa.MIN_PARTITION // unit) * unit
        assert part_len >= shortest
        best = min(plan_cost(b, kh, cap, page, sms, res, n * unit)
                   for n in range(shortest // unit, -(-cap // unit) + 1))
        assert plan_cost(b, kh, cap, page, sms, res, part_len) == best


# ---------------------------------------------------------------------------
# K6: one chain per set (or per few sets), the trace's clock
# ---------------------------------------------------------------------------
def chain_model(addr, n_sets, n_ways, bits):
    """K6 as the kernel splits it: the accesses grouped by chain a & (m - 1)
    in trace order (the bucket pre-pass), each chain walked alone with
    clock = trace position + 1; the victim is the lowest way holding the
    least clock (min-reduce, then the first lane with it)."""
    m = 1 << bits
    tags = np.full((n_sets, n_ways), -1, np.int64)
    use = np.zeros((n_sets, n_ways), np.int64)
    hits = np.zeros(len(addr), np.int32)
    chains = [[] for _ in range(m)]
    for pos, a in enumerate(addr):
        chains[a & (m - 1)].append(pos)
    for chain in reversed(chains):              # any order of chains
        for pos in chain:
            a = int(addr[pos])
            s = a & (n_sets - 1)
            match = np.flatnonzero(tags[s] == a)
            if match.size:
                way = match[0]
            else:
                way = np.flatnonzero(use[s] == use[s].min())[0]
            hits[pos] = match.size > 0
            tags[s, way], use[s, way] = a, pos + 1
    return hits, tags.astype(np.int32), use.astype(np.int32)


def k6_cases():
    rng = np.random.default_rng(17)
    out = []
    for n_sets, n_ways, n, span in [(1, 4, 300, 3), (2, 16, 700, 3),
                                    (16, 1, 400, 4), (64, 32, 2500, 2),
                                    (8, 4, 0, 1)]:
        out.append((f"{n_sets}x{n_ways} N={n}",
                    rng.integers(0, n_sets * n_ways * span, n), n_sets,
                    n_ways))
    # a trace crowded into one set of 16
    out.append(("crowded", 16 * rng.integers(0, 40, 900) + 5, 16, 4))
    return [pytest.param(a.astype(np.int32), s, w, id=name)
            for name, a, s, w in out]


@pytest.mark.parametrize("addr,n_sets,n_ways", k6_cases())
@pytest.mark.parametrize("fewer", [0, 2])
def test_chain_walk_matches_jax_oracle(addr, n_sets, n_ways, fewer):
    """One set per chain (the kernel's m for these sets), and 2**fewer sets
    per chain (the kernel's layout past 2**MAX_CHAIN_BITS sets)."""
    bits = max(tcs.cache_sim_bits(n_sets) - fewer, 0)
    got = chain_model(addr, n_sets, n_ways, bits)
    want = [np.asarray(x) for x in jref.cache_sim(jnp.asarray(addr),
                                                  n_sets, n_ways)]
    plain = tops.cache_sim_ref(torch.from_numpy(addr), n_sets=n_sets,
                               n_ways=n_ways)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p.numpy())


def test_chain_count_and_prepass_tile():
    assert tcs.cache_sim_bits(1) == 0                       # one chain
    assert tcs.cache_sim_bits(2048) == 11                   # Table-I L2
    assert tcs.cache_sim_bits(1 << tcs.MAX_CHAIN_BITS) == tcs.MAX_CHAIN_BITS
    assert tcs.cache_sim_bits(8192) == tcs.MAX_CHAIN_BITS   # 2 sets each
    # K6's tile: per-tile counts no larger than the trace; the MESI rule
    # would leave the 2 M-access Table-I trace 32 tiles
    for bits in range(tcs.MAX_CHAIN_BITS + 1):
        tile = tcs.cache_sim_tile(bits)
        assert tile >= 1024 and tile >= 1 << bits
    n = 2_097_150
    assert -(-n // tcs.cache_sim_tile(11)) == 1024
    assert -(-n // tcs.bucket_tile(11)) == 32
