"""The port's sharded and streamed sweeps against the JAX package's rows.

Mirrors `tests/test_distribute.py`: any `Mesh` / `stream_chunk` choice is
an execution strategy, so the port's sharded, padded and streamed rows
must equal the JAX package's one-program rows on the same spec, dynamic-
tiering rows included, and `run_traces(segment=)` / `stream_traces` must
equal the JAX package's resident runs entry for entry (stats and final
cache state).  The port runs on the CPU, where each kernel runs its plain
PyTorch version (about 0.7 ms an access step, so the grids here are the
JAX test's at one footprint where sharding multiplies the steps).

Tolerance: none.  Rows are compared as dicts after JSON normalisation
(counters bitwise, floats to the bit); `tests/golden/distribute.json` is
reproduced exactly.
"""
import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import distribute as jdistribute
from repro.core import engine as jengine
from repro.core import numa as jnuma
from repro.core import route as jroute
from repro.core import tiering_dyn as jdyn
from repro.core.machine import CPUModel as JCPU
from repro.core.timing import TimingConfig as JTiming
from repro_torch import convert
from repro_torch.core import cache as tcache
from repro_torch.core import distribute as tdistribute
from repro_torch.core import engine as tengine
from repro_torch.core import numa as tnuma
from repro_torch.core import route as troute
from repro_torch.core import tiering_dyn as tdyn
from repro_torch.core.machine import CPUModel
from repro_torch.core.timing import TimingConfig

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)
SMALL = dict(l1_bytes=4 * 2 * 64, l1_ways=2, l2_bytes=16 * 4 * 64, l2_ways=4)

J = types.SimpleNamespace(engine=jengine, numa=jnuma, route=jroute,
                          CPU=JCPU, DT=jdyn.DynamicTiering,
                          cache=jcache.CacheParams(**GEOMETRY),
                          timing=JTiming())
T = types.SimpleNamespace(engine=tengine, numa=tnuma, route=troute,
                          CPU=CPUModel, DT=tdyn.DynamicTiering,
                          cache=tcache.CacheParams(**GEOMETRY),
                          timing=TimingConfig())


def normalised(rows):
    return json.loads(json.dumps(rows))


def grid_spec(m, **kw):
    """The JAX test's grid (2 policies x 2 topologies) at one footprint:
    4 rows."""
    base = dict(footprint_factors=(1,),
                policies=(m.numa.ZNuma(1.0), m.numa.WeightedInterleave(1, 1)),
                cpus=(m.CPU(kind="o3", mlp=8),),
                topologies=(m.route.direct(1), m.route.direct(2)))
    base.update(kw)
    return m.engine.SweepSpec(**base)


def ragged_spec(m):
    """6 rows: 3 policies x 2 topologies."""
    return grid_spec(m, policies=(m.numa.ZNuma(1.0), m.numa.ZNuma(0.0),
                                  m.numa.WeightedInterleave(1, 1)))


def tiering_spec(m):
    return grid_spec(m, policies=(m.numa.ZNuma(1.0),),
                     topologies=(m.route.direct(2),),
                     tiering=(None, m.DT(epoch_len=512, budget=4,
                                         threshold=2)))


def jax_rows(spec_fn):
    return normalised(jengine.run_sweep(spec_fn(J), J.cache, J.timing))


def port_rows(spec_fn, **kw):
    return normalised(tdistribute.run_sweep(spec_fn(T), T.cache, T.timing,
                                            device="cpu", **kw))


@pytest.fixture(scope="module")
def legacy():
    """The JAX package's one-program rows, one list per spec."""
    return {"grid": jax_rows(grid_spec), "ragged": jax_rows(ragged_spec),
            "tiering": jax_rows(tiering_spec)}


def rand_batch(rng, b, n, addr_hi=256):
    return (rng.integers(0, addr_hi, (b, n)).astype(np.int32),
            rng.integers(0, 2, (b, n)).astype(np.int32),
            rng.integers(0, 2, (b, n)).astype(np.int32))


# ---------------------------------------------------------------------------
# mesh=None / stream_chunk=None: exactly the one-call path
# ---------------------------------------------------------------------------
def test_defaults_are_the_legacy_path(legacy):
    rows = port_rows(grid_spec, mesh=None, stream_chunk=None)
    assert rows == legacy["grid"]
    assert normalised(tengine.run_sweep(grid_spec(T), T.cache, T.timing,
                                        device="cpu")) == rows


# ---------------------------------------------------------------------------
# sharded-vs-single-program bitwise parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", [1, 2, 3, tdistribute.Mesh(n_shards=5)],
                         ids=["1", "2", "3", "Mesh5"])
def test_sharded_rows_bitwise_equal(legacy, mesh):
    assert port_rows(grid_spec, mesh=mesh) == legacy["grid"]


@pytest.mark.parametrize("shards", [4, 5])
def test_ragged_grid_padding_invariance(legacy, shards):
    # 6 rows over 4 shards (2 padding rows) and 5 (4 padding rows, two
    # shards all padding): padding rows never perturb real rows
    assert tdistribute.shard_plan(6, shards)[1] > 6
    assert port_rows(ragged_spec, mesh=shards) == legacy["ragged"]


@pytest.mark.parametrize("mesh,chunk", [(2, None), (3, None), (None, 512),
                                        (2, 1024)])
def test_sharded_tiering_rows_bitwise_equal(legacy, mesh, chunk):
    rows = port_rows(tiering_spec, mesh=mesh, stream_chunk=chunk)
    assert rows == legacy["tiering"]


def test_explicit_backend_shards_and_streams_through_run_traces(legacy):
    """The JAX package's non-reference backends shard through
    `run_traces(segment=)`; the port's one static branch does for both."""
    spec = grid_spec(T, topologies=(), backend="reference")
    want = [r["stats"] for r in jax_rows(lambda m: grid_spec(m,
                                                             topologies=()))]
    for kw in (dict(mesh=2), dict(stream_chunk=256)):
        rows = tdistribute.run_sweep(spec, T.cache, T.timing, device="cpu",
                                     **kw)
        assert [r["stats"] for r in rows] == want, kw


# ---------------------------------------------------------------------------
# streaming-vs-resident bitwise equality
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,segment", [(250, 64), (256, 256), (100, 512)])
def test_run_traces_segmented_bitwise(n, segment):
    jp = jcache.CacheParams(**SMALL)
    tp = convert.cache_params(dataclasses.asdict(jp))
    addr, wr, tier = rand_batch(np.random.default_rng(n + segment), 3, n)
    s0, st0 = jengine.run_traces(jp, addr, wr, None, tier)
    s1, st1 = tengine.run_traces(tp, torch.from_numpy(addr),
                                 torch.from_numpy(wr), None,
                                 torch.from_numpy(tier), segment=segment)
    np.testing.assert_array_equal(np.asarray(s0), s1.numpy())
    for f in st0._fields:
        np.testing.assert_array_equal(np.asarray(getattr(st0, f)),
                                      getattr(st1, f).numpy(), err_msg=f)


def test_stream_traces_source_equals_resident():
    jp = jcache.CacheParams(**SMALL)
    tp = convert.cache_params(dataclasses.asdict(jp))
    addr, wr, tier = rand_batch(np.random.default_rng(11), 2, 333)
    s0, st0 = jengine.run_traces(jp, addr, wr, None, tier)
    src = tdistribute.segment_batch((torch.from_numpy(addr),
                                     torch.from_numpy(wr), None,
                                     torch.from_numpy(tier)), 128)
    s1, st1 = tdistribute.stream_traces(tp, src)
    np.testing.assert_array_equal(np.asarray(s0), s1.numpy())
    for f in st0._fields:
        np.testing.assert_array_equal(np.asarray(getattr(st0, f)),
                                      getattr(st1, f).numpy(), err_msg=f)


def test_stream_traces_generated_source_bounded_memory():
    # a lazily *generated* source of host arrays: E repetitions of a base
    # segment whose concatenation is never materialized
    jp = jcache.CacheParams(**SMALL)
    tp = convert.cache_params(dataclasses.asdict(jp))
    base = rand_batch(np.random.default_rng(12), 2, 128)
    reps = 6

    def source():
        for _ in range(reps):
            yield (base[0], base[1], None, base[2])

    s0, _ = jengine.run_traces(jp, np.tile(base[0], (1, reps)),
                               np.tile(base[1], (1, reps)), None,
                               np.tile(base[2], (1, reps)))
    s1, _ = tdistribute.stream_traces(tp, source(), device="cpu")
    np.testing.assert_array_equal(np.asarray(s0), s1.numpy())
    # the streamed working set is one segment, not the whole trace
    assert tdistribute.trace_working_set_bytes(2, 128) * reps \
        == tdistribute.trace_working_set_bytes(2, 128 * reps) \
        == jdistribute.trace_working_set_bytes(2, 128 * reps)


@pytest.mark.parametrize("chunk", [300, 512, 4096])
def test_stream_chunk_sweep_parity(legacy, chunk):
    assert port_rows(grid_spec, stream_chunk=chunk) == legacy["grid"]


# ---------------------------------------------------------------------------
# plan arithmetic + validation
# ---------------------------------------------------------------------------
def test_shard_plan_arithmetic():
    for b, n in ((8, 2), (5, 2), (5, 4), (1, 1), (9, 3), (9, 4), (4, 3)):
        assert tdistribute.shard_plan(b, n) == jdistribute.shard_plan(b, n)
    assert tdistribute.shard_plan(5, 4) == (2, 8)
    with pytest.raises(ValueError):
        tdistribute.shard_plan(0, 2)


def test_explicit_mesh_devices_placement(legacy):
    cpu = torch.device("cpu")
    mesh = tdistribute.Mesh(n_shards=2, devices=(cpu,))
    assert mesh.resolve_devices() == (cpu,)
    assert port_rows(grid_spec, mesh=mesh) == legacy["grid"]


def test_mesh_validation_and_shard_count():
    with pytest.raises(ValueError):
        tdistribute.Mesh(n_shards=-1)
    with pytest.raises(TypeError):
        tdistribute.run_sweep(grid_spec(T), T.cache, T.timing, mesh="four",
                              device="cpu")
    # never more shards than rows (padding can't outnumber the grid)
    assert tdistribute.Mesh(n_shards=16).shard_count(3) == 3
    # a CPU sweep with no named devices shards on the CPU
    assert tdistribute.Mesh().shard_count(100, "cpu") == 1
    assert tdistribute.Mesh().resolve_devices("cpu") == (torch.device("cpu"),)


def test_streaming_validation():
    with pytest.raises(ValueError):
        tdistribute.ShardedExecutor(stream_chunk=0)
    with pytest.raises(ValueError):
        tdistribute.ResilientExecutor(stream_chunk=0)
    with pytest.raises(ValueError):
        tdistribute.stream_traces(T.cache, iter(()), device="cpu")
    with pytest.raises(ValueError):
        tengine.run_traces(T.cache, torch.zeros((1, 8), dtype=torch.int32),
                           None, segment=0)
    with pytest.raises(ValueError, match="chunk"):
        tengine.run_sweep(grid_spec(T), T.cache, T.timing, chunk=0,
                          device="cpu")


def test_executor_and_resilience_knobs_are_exclusive():
    with pytest.raises(ValueError, match="not both"):
        tengine.run_sweep(grid_spec(T), T.cache, T.timing, device="cpu",
                          executor=tdistribute.ShardedExecutor(mesh=2),
                          resume="ckpt")


def test_golden_distribute_reproduced_exactly():
    spec = T.engine.SweepSpec(
        footprint_factors=(2,),
        policies=(tnuma.WeightedInterleave(1, 1), tnuma.ZNuma(1.0)),
        cpus=(CPUModel(kind="o3", mlp=8),))
    rows = normalised(tdistribute.run_sweep(
        spec, T.cache, T.timing, mesh=tdistribute.Mesh(n_shards=2),
        stream_chunk=512, device="cpu"))
    assert rows == json.loads((GOLDEN / "distribute.json").read_text())


# ---------------------------------------------------------------------------
# state carried across: the JAX package's carry, finished by the port
# ---------------------------------------------------------------------------
def test_stream_carry_from_jax_finishes_in_the_port(tmp_path):
    """The JAX package streams the first 3 of 8 segments, checkpointing
    its carry; the port finishes the stream from that carry, converted
    with `convert.carry_from_numpy` — and, separately, resumes the JAX
    package's checkpoint directory itself.  Both equal the JAX run over
    the whole trace, bitwise."""
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.core import resilience as jres
    jp = jcache.CacheParams(**GEOMETRY)
    rng = np.random.default_rng(31)
    addr = rng.integers(0, 1024, (3, 2048)).astype(np.int32)
    wr = rng.integers(0, 2, (3, 2048)).astype(np.int32)
    core = np.zeros_like(addr)
    tier = rng.integers(0, 2, (3, 2048)).astype(np.int32)
    s0, st0 = jengine.run_traces(jp, addr, wr, None, tier)
    segs = list(jdistribute.segment_batch((addr, wr, None, tier), 256))
    pol = jres.CheckpointPolicy(tmp_path, every_segments=3, blocking=True)
    jdistribute.stream_traces(jp, segs[:3], checkpoint=pol)
    step, tree = JManager(tmp_path / "shard_000").restore(
        None, {"carry": jres.host_tree(jengine.init_batch_carry(jp, 3))})
    assert step == 3
    carry = convert.carry_from_numpy(*tree["carry"])
    rest = [(a, w, c, t) for a, w, c, t in
            tdistribute.segment_batch((addr, wr, core, tier), 256)][3:]
    s1, st1 = tdistribute.stream_traces(T.cache, rest, carry=carry,
                                        device="cpu")
    # the port's own checkpointer fast-forwards the JAX directory's 3
    # segments and finishes the rest
    s2, st2 = tdistribute.stream_traces(
        T.cache, tdistribute.segment_batch(
            tuple(torch.from_numpy(x) for x in (addr, wr, core, tier)), 256),
        checkpoint=tmp_path)
    for s, st in ((s1, st1), (s2, st2)):
        np.testing.assert_array_equal(np.asarray(s0), s.numpy())
        for f in st0._fields:
            np.testing.assert_array_equal(np.asarray(getattr(st0, f)),
                                          getattr(st, f).numpy(), err_msg=f)


def test_dynamic_carry_from_jax_finishes_in_the_port():
    """The 9-tuple epoch carry after the JAX package's first 3 slots of a
    dynamic-tiering batch, finished by the port's
    `tiering_dyn.run_dynamic_segment`, equals the JAX run over every slot."""
    jspec, tspec = tiering_spec(J), tiering_spec(T)
    routes = [jroute.build_route(t, J.timing) for t in jspec.topologies]
    jtb = jengine.build_tiering_batch(jspec, J.cache, routes, 512, 3)
    kw = dict(slot_len=512, k_max=4)
    scal = {k: getattr(jtb, k) for k in (
        "dyn_flag", "page_map0", "n_pages", "budget", "threshold", "period",
        "dram_cap", "page_target_lines", "ssd_tid", "cxl_cap", "s_warm",
        "s_meas", "s_per")}
    b = jtb.batch
    trace = (b.addr, b.is_write, b.core, b.tier)
    jp = jcache.CacheParams(**GEOMETRY, n_targets=3)
    want = jdyn.run_dynamic(jp, *trace, **kw, **scal)
    a3, w3, c3, t3, pmap0, scalars, k_max, bound = \
        jdyn.prep_dynamic_inputs(*trace, **kw, **scal)
    carry = jdyn.init_dyn_carry(jp, pmap0)
    carry, *_ = jdyn.run_dynamic_segment(
        jp, k_max, bound, carry, a3[:, :3], w3[:, :3], c3[:, :3],
        t3[:, :3], *scalars, donate=False)
    tp = convert.cache_params(dataclasses.asdict(jp))
    tcarry = convert.carry_from_numpy(*(np.asarray(x) for x in carry))
    targs = [torch.from_numpy(np.array(x)) for x in (a3, w3, c3, t3)]
    tsc = [torch.from_numpy(np.array(x)) for x in scalars]
    tcarry, slots, snaps, meas = tdyn.run_dynamic_segment(
        tp, k_max, bound, tcarry, *(x[:, 3:] for x in targs), *tsc)
    _, _, stats, _, pmap, _, mig_rd, mig_wr, _ = tcarry
    for got, ref in ((stats, want.stats), (pmap, want.page_map),
                     (mig_rd, want.mig_read), (mig_wr, want.mig_write),
                     (slots, np.asarray(want.slots)[:, 3:]),
                     (snaps, np.asarray(want.snapshots)[:, 3:]),
                     (meas, np.asarray(want.meas)[:, 3:])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert tspec.tiering[1] == convert.dynamic_tiering(
        dataclasses.asdict(jspec.tiering[1]))
