"""The port's MESI model against the JAX package's, bit for bit.

The same NumPy-seeded traces go through `repro` (the reference scan, and
once the Pallas kernel in interpret mode) and through `repro_torch` on the
CPU, where the MESI op runs its plain PyTorch version.  Counters and all
eight state planes must be equal exactly.  The CUDA kernel itself is held
against the plain version on the card by `tests/test_torch_card.py` and
`chip_smoke.py`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import engine as jengine
from repro.kernels import cache_sim as jkernels
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import cache as tcache
from repro_torch.core import engine as tengine
from repro_torch.kernels import cache_sim as tkernels
from repro_torch.kernels import ops as tops

SMALL = dict(l1_bytes=1024, l1_ways=2, l2_bytes=4096, l2_ways=4)


def params(**kw):
    """The same geometry on both sides."""
    jp = jcache.CacheParams(**kw)
    return jp, convert.cache_params(dataclasses.asdict(jp))


def mixed_batch(seed, n, cores, n_targets):
    """Four rows: thrashing, hit-heavy, a sentinel tail, writes only."""
    rng = np.random.default_rng(seed)
    b = 4
    addr = rng.integers(0, 512, (b, n)).astype(np.int32)      # thrashes
    addr[1] = rng.integers(0, 24, n)                           # mostly hits
    addr[2, n - n // 5:] = jcache.SENTINEL                     # padding
    wr = rng.integers(0, 2, (b, n)).astype(np.int32)
    wr[3] = 1
    core = rng.integers(0, cores, (b, n)).astype(np.int32)
    tier = rng.integers(0, n_targets, (b, n)).astype(np.int32)
    return addr, wr, core, tier


def as_torch(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def assert_same(got, want):
    """`got` (torch stats, CacheState) equals `want` (JAX) bitwise."""
    gs, gst = got
    ws, wst = want
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert gs.dtype == torch.int32
    for f in wst._fields:
        np.testing.assert_array_equal(getattr(gst, f).numpy(),
                                      np.asarray(getattr(wst, f)),
                                      err_msg=f)


@pytest.mark.parametrize("cores,n_targets", [
    (1, 2), (1, 3), (2, 3), (2, 5), (4, 2), (4, 5)])
def test_run_traces_matches_jax_reference(cores, n_targets):
    jp, tp = params(**SMALL, cores=cores, n_targets=n_targets)
    trace = mixed_batch(cores * 10 + n_targets, 300, cores, n_targets)
    want = jengine.run_traces(jp, *trace, backend="reference")
    got = tengine.run_traces(tp, *as_torch(*trace))
    assert_same(got, want)
    stats = got[0].numpy()
    assert stats[:, tcache.L1_HIT].sum() > 0
    if cores > 1:   # the coherence paths really ran
        assert stats[:, tcache.coherence_base(n_targets) + 1].sum() > 0
        assert stats[:, tcache.coherence_base(n_targets) + 2].sum() > 0


def test_mesi_cache_sim_plain_counts_calls():
    jp, tp = params(**SMALL, cores=2)
    trace = mixed_batch(3, 200, 2, 2)
    tops.reset_launches()
    got = tkernels.mesi_cache_sim(*as_torch(*trace), params=tp)
    assert tops.LAUNCHES == dict(dict.fromkeys(tops.LAUNCHES, 0),
                                  mesi_segment_ref=1)
    assert_same(got, jengine.run_traces(jp, *trace))


def test_matches_pallas_kernel_interpret_mode():
    jp, tp = params(l1_bytes=2048, l1_ways=2, l2_bytes=8192, l2_ways=4,
                    cores=2)
    rng = np.random.default_rng(7)
    b, n = 2, 512
    trace = (rng.integers(0, 2048, (b, n)).astype(np.int32),
             rng.integers(0, 2, (b, n)).astype(np.int32),
             rng.integers(0, 2, (b, n)).astype(np.int32),
             rng.integers(0, 2, (b, n)).astype(np.int32))
    want = jops.mesi_cache_sim(*trace, params=jp, chunk=256)
    got = tkernels.mesi_cache_sim(*as_torch(*trace), params=tp)
    assert_same(got, want)


def test_simulate_trace_matches_sequential_oracle():
    jp, tp = params(**SMALL)
    rng = np.random.default_rng(11)
    addr = rng.integers(0, 300, 250).astype(np.int32)
    wr = rng.integers(0, 2, 250).astype(bool)
    tier = rng.integers(0, 2, 250).astype(np.int32)
    jst, js = jcache.simulate_trace(jp, jcache.init_state(jp), addr, wr,
                                    tier=tier)
    tst, ts = tcache.simulate_trace(tp, tcache.init_state(tp),
                                    *as_torch(addr, wr), tier=as_torch(tier)[0])
    assert_same((ts, tst), (js, jst))
    assert tcache.stats_dict(ts) == jcache.stats_dict(np.asarray(js))
    assert tcache.miss_rates(ts) == jcache.miss_rates(np.asarray(js))


@pytest.mark.parametrize("segment", [100, 512])
def test_segmented_equals_resident(segment):
    jp, tp = params(**SMALL, cores=2, n_targets=3)
    trace = mixed_batch(21, 450, 2, 3)
    resident = tengine.run_traces(tp, *as_torch(*trace))
    streamed = tengine.run_traces(tp, *as_torch(*trace), segment=segment)
    assert_same(streamed, (resident[0].numpy(),
                           tcache.CacheState(*(x.numpy() for x in resident[1]))))
    assert_same(streamed, jengine.run_traces(jp, *trace))


def test_continues_a_jax_carry():
    jp, tp = params(**SMALL, cores=2, n_targets=3)
    addr, wr, core, tier = mixed_batch(5, 400, 2, 3)
    h = 170
    carry = jengine.init_batch_carry(jp, addr.shape[0])
    carry = jengine.run_batch_segment(jp, carry, addr[:, :h], wr[:, :h],
                                      core[:, :h], tier[:, :h])
    want = jengine.run_batch_segment(jp, carry, addr[:, h:], wr[:, h:],
                                     core[:, h:], tier[:, h:])
    tcarry = convert.carry_from_numpy(*(np.asarray(x) for x in carry))
    got = tengine.run_batch_segment(tp, tcarry, *as_torch(
        addr[:, h:], wr[:, h:], core[:, h:], tier[:, h:]))
    for g, w in zip(convert.carry_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_pad_trace_matches_jax():
    rng = np.random.default_rng(2)
    addr = rng.integers(0, 99, (2, 37)).astype(np.int32)
    wr = rng.integers(0, 2, (2, 37)).astype(np.int32)
    want = jkernels.pad_trace(16, addr, wr)
    got = tkernels.pad_trace(16, *as_torch(addr, wr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(g.shape == (2, 48) for g in got)


def test_cache_params_bounds_cores():
    with pytest.raises(ValueError, match="cores"):
        tcache.CacheParams(cores=32)
    assert tcache.CacheParams(cores=31).cores == 31
