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


def unequal_rows(seed, n_targets, negative=True):
    """Three traces of unequal length, the shortest with a live negative
    address (only -1 is padding) where `negative`."""
    rng = np.random.default_rng(seed)
    rows = []
    for n in (300, 137, 45):
        rows.append((rng.integers(0, 600, n).astype(np.int32),
                     rng.integers(0, 2, n).astype(np.int32),
                     rng.integers(0, 2, n).astype(np.int32),
                     rng.integers(0, n_targets, n).astype(np.int32)))
    if negative:
        rows[2][0][5] = -7
    return rows


def test_stack_device_traces_pads_to_a_multiple_like_jax():
    rows = unequal_rows(4, 3)
    want = jengine.stack_device_traces(rows, pad_to_multiple=512)
    got = tengine.stack_device_traces([as_torch(*r) for r in rows],
                                      pad_to_multiple=512)
    for f in ("addr", "is_write", "core", "tier"):
        assert tuple(getattr(got, f).shape) == (3, 512)
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(got.n_valid, want.n_valid)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tengine.stack_device_traces([as_torch(*rows[0])], pad_to_multiple=0)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_run_traces_takes_chunk_like_jax(backend):
    """The probe's call (`workloads/pollution.py`): rows stacked with
    `pad_to_multiple` and run with `chunk`, on both packages."""
    jp, tp = params(**SMALL, cores=2, n_targets=3)
    # the Pallas body takes every negative address for padding (a standing
    # split: the references and the port take only -1)
    rows = unequal_rows(9, 3, negative=backend == "reference")
    jb = jengine.stack_device_traces(rows, pad_to_multiple=512)
    tb = tengine.stack_device_traces([as_torch(*r) for r in rows],
                                     pad_to_multiple=512)
    want = jengine.run_traces(jp, jb.addr, jb.is_write, core=jb.core,
                              tier=jb.tier, backend=backend, chunk=64)
    got = tengine.run_traces(tp, tb.addr, tb.is_write, core=tb.core,
                             tier=tb.tier, chunk=64, backend="reference")
    assert tuple(got[0].shape) == tuple(np.asarray(want[0]).shape)
    assert_same(got, want)
    with pytest.raises(ValueError, match="chunk"):
        tengine.run_traces(tp, tb.addr, tb.is_write, chunk=0)


def test_kernel_entry_points_take_chunk_like_jax():
    jp, tp = params(**SMALL, cores=2, n_targets=3)
    trace = mixed_batch(13, 128, 2, 3)
    want = jops.mesi_cache_sim(*trace, params=jp, chunk=64)
    got = tops.mesi_cache_sim(*as_torch(*trace), params=tp, chunk=64)
    assert_same(got, want)
    jcarry = jengine.init_batch_carry(jp, trace[0].shape[0])
    want = jops.mesi_run_segment(jcarry, *trace, params=jp, chunk=64)
    got = tops.mesi_run_segment(
        tcache.init_batch_carry(tp, trace[0].shape[0]), *as_torch(*trace),
        params=tp, chunk=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    addr = np.random.default_rng(3).integers(0, 300, 200).astype(np.int32)
    want = jops.cache_sim(addr, n_sets=16, n_ways=4, chunk=64)
    got = tops.cache_sim(as_torch(addr)[0], n_sets=16, n_ways=4, chunk=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for fn, args in ((tops.mesi_cache_sim, as_torch(*trace)),
                     (tops.cache_sim, as_torch(addr))):
        kw = dict(params=tp) if fn is tops.mesi_cache_sim else \
            dict(n_sets=16, n_ways=4)
        with pytest.raises(ValueError, match="chunk"):
            fn(*args, chunk=0, **kw)
