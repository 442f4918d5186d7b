"""The port's fault-tolerant sweeps against the JAX package's rows.

Mirrors `tests/test_resilience.py`: a sweep that is killed, degraded,
retried or requeued gives the JAX package's uninterrupted rows, on the
same spec: kill at every segment boundary then resume (static, dynamic
tiering, sharded), transient retries with backoff and their exhaustion,
OOM halving, host eviction, slow shards, checkpoint hygiene and restore
validation.  The port runs on the CPU (each kernel's plain PyTorch
version), driven by the deterministic `FaultPlan`, whose seeded site
draws must equal the JAX package's bit for bit.

Tolerance: none.  Rows are compared as dicts after JSON normalisation;
`tests/golden/resilience.json` is reproduced exactly.
"""
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import cache as jcache
from repro.core import distribute as jdistribute
from repro.core import engine as jengine
from repro.core import numa as jnuma
from repro.core import resilience as jres
from repro.core import route as jroute
from repro.core import tiering_dyn as jdyn
from repro.core.machine import CPUModel as JCPU
from repro.core.timing import TimingConfig as JTiming
from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager
from repro_torch.core import cache as tcache
from repro_torch.core import distribute, engine, numa, resilience
from repro_torch.core import route as troute
from repro_torch.core import tiering_dyn as tdyn
from repro_torch.core.machine import CPUModel
from repro_torch.core.resilience import (CheckpointPolicy, Fault, FaultPlan,
                                         ResilienceError, RetryPolicy,
                                         RunKilled, RunReport)
from repro_torch.core.timing import TimingConfig
from repro_torch.kernels import cache_sim as tkernels

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)
SEG = 512           # stream_chunk: 2,047-access traces -> 4 segments
CPU = torch.device("cpu")

J = types.SimpleNamespace(engine=jengine, numa=jnuma, route=jroute,
                          CPU=JCPU, DT=jdyn.DynamicTiering,
                          cache=jcache.CacheParams(**GEOMETRY),
                          timing=JTiming())
T = types.SimpleNamespace(engine=engine, numa=numa, route=troute,
                          CPU=CPUModel, DT=tdyn.DynamicTiering,
                          cache=tcache.CacheParams(**GEOMETRY),
                          timing=TimingConfig())


def normalised(rows):
    return json.loads(json.dumps(rows))


def grid_spec(m, **kw):
    """A small static grid (1 footprint x 2 policies x 2 topologies)."""
    base = dict(footprint_factors=(1,),
                policies=(m.numa.ZNuma(1.0), m.numa.WeightedInterleave(1, 1)),
                cpus=(m.CPU(kind="o3", mlp=8),),
                topologies=(m.route.direct(1), m.route.direct(2)))
    base.update(kw)
    return m.engine.SweepSpec(**base)


def dyn_spec(m):
    """Static + dynamic tiering rows in one grid (epoch == SEG, so the
    streamed program also has 4 one-slot segments)."""
    return grid_spec(m, topologies=(m.route.direct(2),),
                     tiering=(None, m.DT(epoch_len=512, budget=4)))


SPECS = {"grid": grid_spec, "dyn": dyn_spec}


@pytest.fixture(scope="module")
def legacy():
    """The JAX package's uninterrupted one-program rows."""
    return {k: normalised(jengine.run_sweep(f(J), J.cache, J.timing))
            for k, f in SPECS.items()}


def policy(tmp_path, **kw):
    kw.setdefault("every_segments", 1)
    kw.setdefault("blocking", True)      # deterministic file counts
    return CheckpointPolicy(tmp_path / "ckpt", **kw)


def run_resilient(spec, *, mesh=None, resume=None, fault_plan=None,
                  retry=None, report=None, stream_chunk=SEG):
    return normalised(distribute.run_sweep(
        spec, T.cache, T.timing, mesh=mesh, stream_chunk=stream_chunk,
        resume=resume, fault_plan=fault_plan, retry=retry, report=report,
        device="cpu"))


def run_with(executor, spec):
    return normalised(engine.run_sweep(spec, T.cache, T.timing,
                                       executor=executor, device="cpu"))


# ---------------------------------------------------------------------------
# The resilient executor is an execution strategy, not a result change
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SPECS))
def test_resilient_executor_uninterrupted_parity(legacy, name):
    rows = run_resilient(SPECS[name](T), report=RunReport())
    assert rows == legacy[name]


# ---------------------------------------------------------------------------
# Kill at EVERY segment boundary -> resume parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,mesh", [
    ("grid", None),                  # static rows, one shard
    ("dyn", None),                   # dynamic-tiering rows
    ("grid", 2),                     # sharded static rows
])
def test_kill_at_every_boundary_resume_parity(legacy, tmp_path, name, mesh):
    spec = SPECS[name](T)
    for boundary in range(4):        # 2,048-access traces / SEG
        pol = policy(tmp_path / f"b{boundary}")
        plan = FaultPlan((Fault("crash", shard=0, segment=boundary),))
        with pytest.raises(RunKilled):
            run_resilient(spec, mesh=mesh, resume=pol, fault_plan=plan)
        report = RunReport()
        rows = run_resilient(spec, mesh=mesh, resume=pol, report=report)
        assert rows == legacy[name], f"boundary={boundary}"
        if boundary > 0:             # something was actually fast-forwarded
            assert report.summary()["fast_forwarded_segments"] >= boundary


def test_resume_of_completed_run_is_pure_fast_forward(legacy, tmp_path):
    spec = grid_spec(T)
    pol = policy(tmp_path)
    assert run_resilient(spec, resume=pol) == legacy["grid"]
    report = RunReport()
    assert run_resilient(spec, resume=pol, report=report) == legacy["grid"]
    # every shard restores at its final segment: no checkpoint rewrites
    assert report.resumes == 1
    assert report.summary()["fast_forwarded_segments"] == 4
    assert report.checkpoints == 0


# ---------------------------------------------------------------------------
# Transient failures: bounded retry + backoff, then clean exhaustion
# ---------------------------------------------------------------------------
def test_transient_failure_retried_with_backoff_keeps_rows(legacy):
    sleeps = []
    report = RunReport()
    ex = distribute.ResilientExecutor(
        stream_chunk=SEG,
        fault_plan=FaultPlan((Fault("transient", shard=0, segment=1,
                                    count=2),)),
        retry=RetryPolicy(max_retries=3, backoff_s=0.5, backoff_factor=2.0),
        report=report, sleeper=sleeps.append)
    assert run_with(ex, dyn_spec(T)) == legacy["dyn"]
    assert report.retries == 2
    assert sleeps == [0.5, 1.0]      # exponential backoff, injectable sleep


def test_transient_retry_exhaustion_raises_cleanly():
    ex = distribute.ResilientExecutor(
        stream_chunk=SEG,
        fault_plan=FaultPlan((Fault("transient", shard=0, segment=0,
                                    count=99),)),
        retry=RetryPolicy(max_retries=2, backoff_s=0.0),
        sleeper=lambda s: None)
    with pytest.raises(ResilienceError, match="retry budget exhausted"):
        run_with(ex, grid_spec(T))


def test_seeded_random_transients_are_deterministic_and_survivable(legacy):
    """p = 0.5 over 4 sites fires somewhere, at the same sites on every
    run and in both packages (the SplitMix64 site hash is bitwise)."""
    reports = []
    for _ in range(2):
        report = RunReport()
        ex = distribute.ResilientExecutor(
            stream_chunk=SEG, fault_plan=FaultPlan(seed=7, p_transient=0.5),
            retry=RetryPolicy(backoff_s=0.0), report=report,
            sleeper=lambda s: None)
        assert run_with(ex, grid_spec(T)) == legacy["grid"]
        reports.append([(e["shard"], e["segment"]) for e in report.events
                        if e["event"] == "retry"])
    assert reports[0] and reports[0] == reports[1]
    jreport = jres.RunReport()
    jex = jdistribute.ResilientExecutor(
        stream_chunk=SEG, fault_plan=jres.FaultPlan(seed=7, p_transient=0.5),
        retry=jres.RetryPolicy(backoff_s=0.0), report=jreport,
        sleeper=lambda s: None)
    jengine.run_sweep(grid_spec(J), J.cache, J.timing, executor=jex)
    assert reports[0] == [(e["shard"], e["segment"]) for e in jreport.events
                          if e["event"] == "retry"]


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF, 1 << 40])
def test_fault_site_draws_match_jax(seed):
    mine = FaultPlan(seed=seed, p_transient=0.5)
    theirs = jres.FaultPlan(seed=seed, p_transient=0.5)
    for shard in (0, 1, 5, 1023):
        for segment in (0, 1, 3, 4095, -1):
            assert mine._site_u(shard, segment) == \
                theirs._site_u(shard, segment)
    for x in (0, 1, 0x9E3779B97F4A7C15, (1 << 64) - 1):
        assert resilience._splitmix64(x) == jres._splitmix64(x)


# ---------------------------------------------------------------------------
# OOM: degrade by halving, rerun from the intact carry, same numbers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SPECS))
def test_oom_degradation_parity(legacy, name):
    report = RunReport()
    # width-triggered: every dispatch wider than 512 accesses OOMs, so
    # the 2048-access resident segment must halve twice (2048 -> 1024
    # -> 512) before calls go through — dynamic rows split on slot
    # boundaries (4 slots -> 2 -> 1), static rows on columns
    ex = distribute.ResilientExecutor(
        stream_chunk=2048,
        fault_plan=FaultPlan((Fault("oom", shard=0, oom_above=512),)),
        report=report)
    assert run_with(ex, SPECS[name](T)) == legacy[name]
    assert report.degradations == 2


def test_oom_at_minimum_width_raises():
    ex = distribute.ResilientExecutor(
        stream_chunk=SEG,
        fault_plan=FaultPlan((Fault("oom", shard=0, oom_above=0),)),
        retry=RetryPolicy(max_halvings=3))
    with pytest.raises(ResilienceError, match="OOM persists"):
        run_with(ex, grid_spec(T))


# ---------------------------------------------------------------------------
# Device loss: evict the host, requeue the shard, same numbers
# ---------------------------------------------------------------------------
def test_device_loss_evicts_and_requeues_with_parity(legacy):
    report = RunReport()
    # two logical hosts on one physical device: shard 1's host dies
    ex = distribute.ResilientExecutor(
        mesh=distribute.Mesh(n_shards=2, devices=(CPU, CPU)),
        stream_chunk=SEG,
        fault_plan=FaultPlan((Fault("device_lost", shard=1, segment=0),)),
        report=report)
    assert run_with(ex, grid_spec(T)) == legacy["grid"]
    evicts = [e for e in report.events if e["event"] == "evict"]
    assert len(evicts) == 1 and evicts[0]["reason"] == "device_lost"


def test_losing_every_device_raises():
    ex = distribute.ResilientExecutor(
        mesh=distribute.Mesh(n_shards=1, devices=(CPU,)),
        stream_chunk=SEG,
        fault_plan=FaultPlan((Fault("device_lost", shard=0, segment=0,
                                    count=99),)))
    with pytest.raises(ResilienceError, match="no surviving devices"):
        run_with(ex, grid_spec(T))


# ---------------------------------------------------------------------------
# Slow-shard injection: logged, never result-bearing
# ---------------------------------------------------------------------------
def test_slow_shard_is_logged_not_fatal(legacy):
    report = RunReport()
    stalls = []
    ex = distribute.ResilientExecutor(
        stream_chunk=SEG,
        fault_plan=FaultPlan((Fault("slow", shard=0, segment=1,
                                    delay_s=7.5),)),
        report=report, sleeper=stalls.append)
    assert run_with(ex, grid_spec(T)) == legacy["grid"]
    assert stalls == [7.5]
    assert report.count("slow") == 1


# ---------------------------------------------------------------------------
# stream_traces: checkpointed streaming fast-forwards on rerun
# ---------------------------------------------------------------------------
def test_stream_traces_checkpoint_resume_parity(tmp_path):
    rng = np.random.default_rng(23)
    b, n = 3, 4096
    addr = rng.integers(0, 256, (b, n)).astype(np.int32)
    w = rng.integers(0, 2, (b, n)).astype(np.int32)
    ref_stats, _ = jengine.run_traces(J.cache, addr, w)
    pol = policy(tmp_path, every_segments=2)

    def src():
        return distribute.segment_batch(
            (torch.from_numpy(addr), torch.from_numpy(w), None, None), 512)

    r1 = RunReport()
    s1, _ = distribute.stream_traces(T.cache, src(), checkpoint=pol,
                                     report=r1)
    assert np.array_equal(s1.numpy(), np.asarray(ref_stats))
    assert r1.checkpoints == 4       # 8 segments / every 2
    r2 = RunReport()
    s2, _ = distribute.stream_traces(T.cache, src(), checkpoint=pol,
                                     report=r2)
    assert np.array_equal(s2.numpy(), np.asarray(ref_stats))
    assert r2.summary()["fast_forwarded_segments"] == 8
    assert r2.checkpoints == 0       # nothing re-ran, nothing re-saved


# ---------------------------------------------------------------------------
# Checkpoint hygiene: GC under keep, stale tmp sweep, real validation
# ---------------------------------------------------------------------------
def test_checkpoint_gc_respects_keep(tmp_path):
    pol = policy(tmp_path, keep=2)
    run_resilient(grid_spec(T), resume=pol)
    shard_dirs = sorted(pol.directory.glob("shard_*"))
    assert shard_dirs, "no per-shard checkpoints written"
    for sd in shard_dirs:
        steps = sorted(p.name for p in sd.glob("step_*"))
        assert len(steps) <= 2, f"{sd}: {steps}"
        assert steps[-1] == "step_000004"    # the final carry survives GC


def test_manager_sweeps_stale_tmp_dirs(tmp_path):
    stale = tmp_path / "tmp_step_000007"
    stale.mkdir(parents=True)
    (stale / "leaf_00000.npy").write_bytes(b"garbage")
    CheckpointManager(tmp_path)
    assert not stale.exists()


def test_manager_restore_validates_treedef_and_shape(tmp_path):
    m = CheckpointManager(tmp_path)
    m.save(3, {"a": np.arange(4)})
    with pytest.raises(CheckpointError, match="treedef mismatch"):
        m.restore(3, {"b": {"nested": np.arange(4)}})
    with pytest.raises(CheckpointError, match="stored shape"):
        m.restore(3, {"a": np.arange(5)})
    step, tree = m.restore(3, {"a": np.zeros(4, np.int64)})
    assert step == 3 and tree["a"].tolist() == [0, 1, 2, 3]
    # a tensor `like` brings the leaf back as a tensor of its dtype
    step, tree = m.restore(None, {"a": torch.zeros(4, dtype=torch.int32)})
    assert tree["a"].dtype == torch.int32
    assert tree["a"].tolist() == [0, 1, 2, 3]


def test_checkpoint_directories_interchange_with_jax(tmp_path):
    """The on-disk layout and structure string are the JAX package's: a
    carry written by either manager restores in the other."""
    carry = tuple(np.arange(6, dtype=np.int32).reshape(2, 3) + i
                  for i in range(4))
    JManager(tmp_path / "j").save(2, {"carry": carry})
    step, tree = CheckpointManager(tmp_path / "j").restore(
        None, {"carry": tuple(torch.zeros((2, 3), dtype=torch.int32)
                              for _ in range(4))})
    assert step == 2
    assert all(np.array_equal(t.numpy(), c) for t, c in zip(tree["carry"],
                                                            carry))
    CheckpointManager(tmp_path / "t").save(
        5, {"carry": tuple(torch.from_numpy(c) for c in carry)})
    step, tree = JManager(tmp_path / "t").restore(None, {"carry": carry})
    assert step == 5
    assert all(np.array_equal(np.asarray(t), c)
               for t, c in zip(tree["carry"], carry))


def test_resume_refuses_a_different_execution_plan(tmp_path):
    pol = policy(tmp_path)
    run_resilient(grid_spec(T), resume=pol)
    with pytest.raises(ResilienceError, match="different execution plan"):
        run_resilient(grid_spec(T), resume=pol, stream_chunk=1024)


# ---------------------------------------------------------------------------
# FaultPlan / RunReport / classify_failure unit behavior
# ---------------------------------------------------------------------------
def test_fault_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor", shard=0)
    with pytest.raises(ValueError, match="count"):
        Fault("crash", shard=0, count=0)
    with pytest.raises(ValueError, match="p_transient"):
        FaultPlan(p_transient=1.5)
    with pytest.raises(ValueError, match="every_segments"):
        CheckpointPolicy("x", every_segments=0)
    with pytest.raises(TypeError):
        resilience.as_checkpoint_policy(3)


def test_fault_count_is_per_site_and_bounded():
    plan = FaultPlan((Fault("transient", shard=0, segment=1, count=2),))
    for _ in range(2):
        with pytest.raises(resilience.TransientDeviceError):
            plan.check(0, 1)
    plan.check(0, 1)                 # exhausted: third attempt passes
    plan.check(1, 1)                 # other shards never fire
    plan.check(0, 0)


def test_report_summary_counts():
    r = RunReport()
    r.add("retry", shard=0, segment=1, attempt=1, backoff_s=0.1)
    r.add("checkpoint", shard=0, segments_done=2, elapsed_s=0.25,
          blocking=True)
    r.add("resume", shard=0, fast_forward_segments=3, elapsed_s=0.1)
    s = r.summary()
    assert s["retries"] == 1
    assert s["checkpoints"] == 1
    assert s["fast_forwarded_segments"] == 3
    assert s["checkpoint_s_max"] == 0.25
    assert s == _jax_summary(r.events)


def _jax_summary(events):
    r = jres.RunReport()
    r.events = list(events)
    return r.summary()


def test_classify_failure_split():
    """Injected types map as in the JAX package; a CUDA OOM is 'oom'; every
    other real error is fatal (a CUDA fault is sticky, never retried)."""
    assert resilience.classify_failure(resilience.SimulatedOOM()) == "oom"
    assert resilience.classify_failure(
        torch.cuda.OutOfMemoryError("CUDA out of memory")) == "oom"
    assert resilience.classify_failure(
        resilience.DeviceLostError(1)) == "device_lost"
    assert resilience.classify_failure(
        resilience.TransientDeviceError()) == "transient"
    for exc in (RuntimeError("CUDA error: an illegal memory access"),
                ValueError("bad shape"), MemoryError("host")):
        assert resilience.classify_failure(exc) == "fatal"


# ---------------------------------------------------------------------------
# The carry a failed or retried call starts from stays intact
# ---------------------------------------------------------------------------
def test_segment_calls_leave_their_input_carry_unchanged():
    rng = np.random.default_rng(5)
    p = T.cache
    addr = torch.from_numpy(rng.integers(0, 512, (2, 256)).astype(np.int32))
    zero = torch.zeros_like(addr)
    carry = engine.init_batch_carry(p, 2, device="cpu")
    before = [x.clone() for x in carry]
    out = tkernels.mesi_segment(carry, addr, zero, zero, zero, params=p)
    assert all(torch.equal(a, b) for a, b in zip(before, carry))
    assert int(out[2].sum()) > 0
    pmap0 = torch.ones((2, 8), dtype=torch.int32)
    dcarry = tdyn.init_dyn_carry(p, pmap0)
    before = [x.clone() for x in dcarry]
    one = torch.ones(2, dtype=torch.int32)
    ptl = torch.zeros((2, 8, 2), dtype=torch.int32)
    ptl[:, :, 1] = 64
    tdyn.run_dynamic_segment(p, 4, 257, dcarry, addr.reshape(2, 2, 128),
                             zero.reshape(2, 2, 128), zero.reshape(2, 2, 128),
                             torch.ones((2, 2, 128), dtype=torch.int32),
                             one, one * 8, one * 4, one, one, one * 8,
                             0 * one, one * 8, ptl)
    assert all(torch.equal(a, b) for a, b in zip(before, dcarry))


def test_golden_resilience_reproduced_exactly(tmp_path):
    spec = engine.SweepSpec(
        footprint_factors=(2,),
        policies=(numa.WeightedInterleave(1, 1), numa.ZNuma(1.0)),
        cpus=(CPUModel(kind="o3", mlp=8),))
    pol = CheckpointPolicy(tmp_path, every_segments=1, blocking=True)
    plan = FaultPlan((Fault("crash", shard=0, segment=2),))
    with pytest.raises(RunKilled):
        run_resilient(spec, resume=pol, fault_plan=plan)
    rows = run_resilient(spec, resume=pol)
    assert rows == json.loads((GOLDEN / "resilience.json").read_text())
