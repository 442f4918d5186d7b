"""The port's §IV sweep, end to end on the CPU, against the JAX package.

`tests/golden/engine.json` reproduced exactly by `repro_torch`, and the
facade's `stream_suite` / `sweep` rows equal to the JAX rows after JSON
normalisation (integer counters bitwise, floats to the last ulp).
"""
import dataclasses
import json
import pathlib

from repro.core import cache as jcache
from repro.core import machine as jmachine
from repro.core import numa as jnuma
from repro.core import simulator as jsim
from repro.core import timing as jtiming
from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.core import numa as tnuma
from repro_torch.core import simulator as tsim
from repro_torch.core.cache import CacheParams
from repro_torch.core.machine import CPUModel
from repro_torch.core.timing import LatencyDistribution, TimingConfig
from repro_torch.kernels import ops

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "engine.json"
GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)


def normalised(rows):
    return json.loads(json.dumps(rows))


def sims():
    """The JAX facade and the port's, on the golden geometry, onlined."""
    jcfg = jsim.SimConfig(cache=jcache.CacheParams(**GEOMETRY))
    j = jsim.CXLRAMSim(jcfg)
    t = tsim.CXLRAMSim(convert.sim_config(dataclasses.asdict(jcfg)),
                       device="cpu")
    assert t.online("znuma") == j.online("znuma")
    return j, t


def test_engine_golden_row_exact():
    spec = tengine.SweepSpec(
        footprint_factors=(2,), policies=(tnuma.WeightedInterleave(1, 1),),
        cpus=(CPUModel(kind="o3", mlp=8),))
    ops.reset_launches()
    rows = tengine.run_sweep(spec, CacheParams(**GEOMETRY), TimingConfig(),
                             device="cpu")
    assert ops.LAUNCHES == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                 mesi_segment_ref=1)
    assert normalised(rows) == [json.loads(GOLDEN.read_text())]


def test_stream_suite_rows_equal_jax():
    j, t = sims()
    want = j.stream_suite((1, 2))
    got = t.stream_suite((1, 2))
    assert normalised(got) == normalised(want)
    assert [r["footprint_x_l2"] for r in got] == [1, 2]


def test_sweep_rows_equal_jax():
    j, t = sims()
    jpol = [jnuma.ZNuma(0.0), jnuma.WeightedInterleave(1, 1),
            jnuma.ZNuma(1.0)]
    tpol = [convert.policy(type(p).__name__, dataclasses.asdict(p))
            for p in jpol]
    jcpus = [jmachine.CPUModel(kind="inorder"), jmachine.CPUModel(kind="o3")]
    tcpus = [convert.cpu_model(dataclasses.asdict(c)) for c in jcpus]
    want = j.sweep((2,), policies=jpol, cpus=jcpus)
    got = t.sweep((2,), policies=tpol, cpus=tcpus)
    assert len(got) == 6
    assert normalised(got) == normalised(want)
    by_policy = {r["policy"]: r["stats"] for r in got}
    assert by_policy["znuma(cxl=0%)"]["mem_read_cxl"] == 0
    assert by_policy["znuma(cxl=100%)"]["mem_read_dram"] == 0


def test_distributions_axis_rows_equal_jax():
    j, t = sims()
    want = j.sweep((1,), distributions=(
        None, jtiming.LatencyDistribution(n_samples=128, seed=2)),
        tiering=(None, None))
    got = t.sweep((1,), distributions=(
        None, LatencyDistribution(n_samples=128, seed=2)),
        tiering=(None, None))
    assert len(got) == 4
    assert normalised(got) == normalised(want)
    assert "lat_cxl_p99_ns" in got[2] and got[0]["tiering"] == "static"


def test_run_stream_matches_jax():
    j, t = sims()
    want = j.run_stream("copy", 8 * 1024, jnuma.WeightedInterleave(2, 1),
                        cpu=jmachine.CPUModel(kind="inorder"))
    got = t.run_stream("copy", 8 * 1024, tnuma.WeightedInterleave(2, 1),
                       cpu=CPUModel(kind="inorder"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.stats["l1_hit"] + got.stats["l1_miss"] == 682


def test_sweep_batch_equals_jax():
    """The stacked sweep batch: rows padded to the longest row, bitwise."""
    import numpy as np
    from repro.core import engine as jengine
    jpol = (jnuma.ZNuma(0.5), jnuma.WeightedInterleave(2, 1))
    tpol = tuple(convert.policy(type(p).__name__, dataclasses.asdict(p))
                 for p in jpol)
    want, want_rows = jengine.build_sweep_batch(
        jengine.SweepSpec(footprint_factors=(1, 2), policies=jpol),
        jcache.CacheParams(**GEOMETRY), chunk=1)
    got, got_rows = tengine.build_sweep_batch(
        tengine.SweepSpec(footprint_factors=(1, 2), policies=tpol),
        CacheParams(**GEOMETRY), device="cpu")
    assert got_rows == want_rows
    assert got.n_valid.tolist() == want.n_valid.tolist()
    assert got.length == int(got.n_valid.max())
    for f in ("addr", "is_write", "core", "tier"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f

    rng = np.random.default_rng(5)
    traces = [(rng.integers(0, 99, n), rng.integers(0, 2, n),
               None if n == 7 else rng.integers(0, 2, n),
               rng.integers(0, 2, n)) for n in (7, 12, 3)]
    host, jhost = tengine.stack_traces(traces), jengine.stack_traces(traces)
    for f in ("addr", "is_write", "core", "tier", "n_valid"):
        assert np.array_equal(getattr(host, f), getattr(jhost, f)), f
