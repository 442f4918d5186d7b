"""Names, functions and keywords of the JAX package that the port lacked.

F1: every name `repro.core`, `repro.serving` and `repro.kernels` export
resolves in the port, and `repro_torch.kernels.ref` gives the plain
versions the oracles' call forms and results.  F2:
`cache.dram_traffic_fraction` and `engine.build_stream_batch` equal the
reference's.  F3: the keywords the reference's own callers pass
(`pad_to_multiple`, `chunk`, `donate`, `positions`) are taken, with the
reference's effect.
"""
import dataclasses
import importlib
from types import ModuleType

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore_pkg
from repro.core import cache as jcache
from repro.core import engine as jengine
from repro.core import numa as jnuma
from repro.core import tiering_dyn as jdyn
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.core import cache as tcache
from repro_torch.core import engine as tengine
from repro_torch.core import tiering_dyn as tdyn
from repro_torch.models import transformer as ttf

GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)
SMALL = dict(l1_bytes=1024, l1_ways=2, l2_bytes=4096, l2_ways=4)
# the names of the reference's core/__init__.py
CORE_NAMES = (
    "Mesh", "ResilientExecutor", "ShardedExecutor", "auto_mesh",
    "stream_traces", "SweepSpec", "run_sweep", "run_traces", "SamplingSpec",
    "CheckpointPolicy", "Fault", "FaultPlan", "ResilienceError",
    "RetryPolicy", "RunKilled", "RunReport", "RouteMap", "TopologySpec",
    "build_route", "build_route_from_system", "direct", "switched",
    "CXLRAMSim", "SimConfig")


def params(**kw):
    jp = jcache.CacheParams(**kw)
    return jp, convert.cache_params(dataclasses.asdict(jp))


def as_torch(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# ---------------------------------------------------------------------------
# F1: package-level names
# ---------------------------------------------------------------------------
def test_the_reference_exports_these_24_core_names():
    exported = {n for n, v in vars(jcore_pkg).items()
                if not n.startswith("_") and not isinstance(v, ModuleType)}
    assert exported == set(CORE_NAMES) and len(CORE_NAMES) == 24


@pytest.mark.parametrize("name", CORE_NAMES)
def test_core_name_resolves_to_the_ported_twin(name):
    import repro_torch.core as tcore_pkg
    want = getattr(jcore_pkg, name)
    got = getattr(tcore_pkg, name)
    assert got.__name__ == want.__name__
    # defined in the port module of the same name as the reference's
    assert got.__module__ == want.__module__.replace("repro.", "repro_torch.",
                                                     1)


def test_serving_and_kernels_names_resolve():
    from repro.serving import ContinuousBatcher, EngineStats, Request
    import repro_torch.serving as tserving
    for cls in (ContinuousBatcher, EngineStats, Request):
        assert getattr(tserving, cls.__name__).__name__ == cls.__name__
    import repro_torch.kernels as tkernels
    assert tkernels.ops is importlib.import_module("repro_torch.kernels.ops")
    assert tkernels.ref is importlib.import_module("repro_torch.kernels.ref")
    with pytest.raises(AttributeError):
        tkernels.nothing_here


def test_ref_cache_sim_positional_equals_the_oracle():
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(3)
    addr = rng.integers(0, 4096, 700).astype(np.int32)
    addr[::7] = rng.integers(0, 64, addr[::7].shape)
    want = jref.cache_sim(jnp.asarray(addr), 64, 4)
    got = tref.cache_sim(torch.from_numpy(addr), 64, 4)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_ref_stream_triad_equals_the_oracle():
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(4)
    b, c = (rng.standard_normal((64, 48)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jref.stream_triad(jnp.asarray(b), jnp.asarray(c), 2.5))
    got = tref.stream_triad(*as_torch(b, c), 2.5).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("causal,window,scale", [(True, None, None),
                                                 (True, 5, 0.3),
                                                 (False, None, 0.7)])
def test_ref_flash_attention_equals_the_oracle(causal, window, scale):
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, 13, 16)).astype(np.float32)
            for _ in range(2))
    want = jref.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                causal=causal, window=window, scale=scale)
    got = tref.flash_attention(*as_torch(q, k, v), causal=causal,
                               window=window, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("scale", [None, 0.2])
def test_ref_paged_attention_equals_the_oracle(scale):
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 8, 16)).astype(np.float32)
    kp, vp = (rng.standard_normal((10, 4, 2, 16)).astype(np.float32)
              for _ in range(2))
    table = rng.integers(0, 10, (3, 4)).astype(np.int32)
    ctx = np.array([5, 16, 0], np.int32)
    want = jref.paged_attention(*(jnp.asarray(x) for x in
                                  (q, kp, vp, table, ctx)), scale=scale)
    got = tref.paged_attention(*as_torch(q, kp, vp, table, ctx), scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


# ---------------------------------------------------------------------------
# F2: missing public functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_targets", [2, 3])
def test_dram_traffic_fraction_equals_jax(n_targets):
    rng = np.random.default_rng(7 + n_targets)
    width = len(jcache.stat_names(n_targets))
    deltas = rng.integers(0, 50, (6, width))
    deltas[2] = 0                             # a slot with no traffic
    want = jcache.dram_traffic_fraction(deltas, n_targets)
    got = tcache.dram_traffic_fraction(deltas, n_targets)
    assert got.dtype == np.float64
    assert np.array_equal(got, want)


def test_build_stream_batch_equals_jax():
    jpol = (jnuma.ZNuma(0.5), jnuma.WeightedInterleave(2, 1))
    tpol = tuple(convert.policy(type(p).__name__, dataclasses.asdict(p))
                 for p in jpol)
    want = jengine.build_stream_batch(
        jengine.SweepSpec(footprint_factors=(1, 2), policies=jpol),
        jcache.CacheParams(**GEOMETRY), chunk=1)
    tspec = tengine.SweepSpec(footprint_factors=(1, 2), policies=tpol)
    got = tengine.build_stream_batch(tspec, tcache.CacheParams(**GEOMETRY),
                                     chunk=64, device="cpu")
    assert got.n_valid.tolist() == want.n_valid.tolist()
    for f in ("addr", "is_write", "core", "tier"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    # build_sweep_batch without its row map; `chunk` checked and ignored
    batch, _ = tengine.build_sweep_batch(
        tspec, tcache.CacheParams(**GEOMETRY), chunk=7, device="cpu")
    assert torch.equal(batch.addr, got.addr)
    with pytest.raises(ValueError, match="chunk"):
        tengine.build_sweep_batch(tspec, tcache.CacheParams(**GEOMETRY),
                                  chunk=0, device="cpu")


# ---------------------------------------------------------------------------
# F3: keywords the reference's callers pass
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multiple", [1, 8, 64])
def test_stack_traces_pads_to_a_multiple_like_jax(multiple):
    rng = np.random.default_rng(multiple)
    traces = [(rng.integers(0, 99, n), rng.integers(0, 2, n),
               None if n == 7 else rng.integers(0, 2, n),
               rng.integers(0, 2, n)) for n in (7, 12, 3)]
    got = tengine.stack_traces(traces, pad_to_multiple=multiple)
    want = jengine.stack_traces(traces, pad_to_multiple=multiple)
    assert got.length == -(-12 // multiple) * multiple
    for f in ("addr", "is_write", "core", "tier", "n_valid"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tengine.stack_traces(traces, pad_to_multiple=0)


def test_run_batch_segment_takes_donate_and_chunk():
    jp, tp = params(**SMALL, cores=2, n_targets=3)
    rng = np.random.default_rng(9)
    addr = rng.integers(0, 512, (3, 200)).astype(np.int32)
    wr, core, tier = (rng.integers(0, k, (3, 200)).astype(np.int32)
                      for k in (2, 2, 3))
    want = jengine.run_batch_segment(
        jp, jengine.init_batch_carry(jp, 3), addr, wr, core, tier,
        donate=True, chunk=64)
    carry = tcache.init_batch_carry(tp, 3)
    got = tengine.run_batch_segment(tp, carry, *as_torch(addr, wr, core,
                                                         tier),
                                    donate=True, chunk=64)
    for g, w in zip(convert.carry_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the port never writes its input carry, donated or not
    assert not carry[2].any()
    with pytest.raises(ValueError, match="chunk"):
        tengine.run_batch_segment(tp, carry, *as_torch(addr, wr, core, tier),
                                  chunk=0)


def test_run_dynamic_segment_takes_donate():
    jp, tp = params(**SMALL, cores=2, n_targets=3)
    rng = np.random.default_rng(10)
    n_p, n = 12, 128
    addr = rng.integers(0, n_p * 64, (2, n)).astype(np.int32)
    trace = (addr, rng.integers(0, 2, (2, n)).astype(np.int32),
             rng.integers(0, 2, (2, n)).astype(np.int32),
             rng.integers(1, 3, (2, n)).astype(np.int32))
    kw = dict(slot_len=32, k_max=n_p, page_map0=np.zeros((2, n_p), np.int32),
              dyn_flag=np.array([1, 0]), n_pages=np.array([n_p, n_p]),
              budget=np.array([2, 0]), threshold=np.array([1, 1]),
              period=np.array([1, 1]),
              dram_cap=np.array([3, jdyn.UNBOUNDED_PAGES]),
              page_target_lines=rng.integers(0, 40, (2, n_p, 3))
              .astype(np.int32))
    a3, w3, c3, t3, pmap0, scalars, k_max, bound = \
        jdyn.prep_dynamic_inputs(*trace, **kw)
    want = jdyn.run_dynamic_segment(
        jp, k_max, bound, jdyn.init_dyn_carry(jp, pmap0), a3, w3, c3, t3,
        *scalars, donate=True)
    carry0 = tdyn.init_dyn_carry(tp, torch.from_numpy(np.array(pmap0)))
    outs = [tdyn.run_dynamic_segment(
        tp, k_max, bound, carry0,
        *(torch.from_numpy(np.array(x)) for x in (a3, w3, c3, t3)),
        *(torch.from_numpy(np.array(x)) for x in scalars), donate=donate)
        for donate in (True, False)]
    for got in outs:
        for g, w in zip(convert.carry_to_numpy(got[0]), want[0]):
            np.testing.assert_array_equal(g, np.asarray(w))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_step_takes_positions_and_ignores_them():
    cfg = dataclasses.replace(get_smoke("qwen2-vl-2b"), dtype="float32")
    p = ttf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    _, caches = ttf.forward_prefill(p, cfg, toks)
    caches = ttf.pad_cache(caches, cfg, 8)
    twin = ttf.pad_cache(ttf.forward_prefill(p, cfg, toks)[1], cfg, 8)
    a, _ = ttf.decode_step(p, cfg, toks[:, 0], caches, 6)
    b, _ = ttf.decode_step(p, cfg, toks[:, 0], twin, 6,
                           positions=torch.full((3, 2, 1), 99))
    assert torch.equal(a, b)
