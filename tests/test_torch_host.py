"""The port's host layer against the JAX package's, exactly.

STREAM traces and page-policy tiers bitwise; the Picard timing fixed point
(`time_batch`, NumPy float64 on both sides) field for field with `==`; the
topology, firmware and CXL-CLI flow; and the conversions of
`repro_torch.convert`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import hdm as jhdm
from repro.core import machine as jmachine
from repro.core import numa as jnuma
from repro.core import simulator as jsim
from repro.core import stream as jstream
from repro.core import timing as jtiming
from repro.core import topology as jtopo
from repro_torch import convert
from repro_torch.core import hdm as thdm
from repro_torch.core import machine as tmachine
from repro_torch.core import numa as tnuma
from repro_torch.core import simulator as tsim
from repro_torch.core import stream as tstream
from repro_torch.core import timing as ttiming
from repro_torch.core import topology as ttopo
from repro_torch.workloads import Stream


@pytest.mark.parametrize("kernel", jstream.KERNELS)
def test_stream_trace_matches_jax(kernel):
    for fp in (3 * 1024, 40 * 1024):
        jl = jstream.layout_for_footprint(fp)
        tl = tstream.layout_for_footprint(fp)
        assert dataclasses.asdict(jl) == dataclasses.asdict(tl)
        assert (jl.n_pages, jl.array_lines) == (tl.n_pages, tl.array_lines)
        ja, jw = jstream.stream_trace(kernel, jl)
        ta, tw = tstream.stream_trace(kernel, tl, "cpu")
        assert ta.dtype == torch.int32 and tw.dtype == torch.bool
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert tstream.stream_bytes(kernel, tl) == \
            jstream.stream_bytes(kernel, jl)
        dev = Stream(kernel).device_trace(fp, "cpu")
        host = Stream(kernel).host_trace(fp)
        np.testing.assert_array_equal(dev.addr.numpy(), host.addr)
        np.testing.assert_array_equal(dev.is_write.numpy().astype(np.int32),
                                      host.is_write)


POLICIES = [("ZNuma", {"cxl_fraction": 0.3}), ("ZNuma", {"cxl_fraction": 1.0}),
            ("FlatMode", {"dram_pages": 5}),
            ("WeightedInterleave", {"dram_weight": 2, "cxl_weight": 3}),
            ("ExplicitPageMap", {"page_tiers": (0, 1, 1, 0, 1, 0, 0, 1, 1,
                                                1, 0, 0)})]


@pytest.mark.parametrize("kind,fields", POLICIES)
def test_tier_of_lines_matches_jax(kind, fields):
    jpol = getattr(jnuma, kind)(**fields)
    tpol = convert.policy(kind, dataclasses.asdict(jpol))
    assert tpol == getattr(tnuma, kind)(**fields)
    n_pages = 12
    lines = np.arange(-3, n_pages * tnuma.LINES_PER_PAGE + 70, 7,
                      dtype=np.int32)
    want = jnuma.tier_of_lines(jpol, lines, n_pages)
    got = tnuma.tier_of_lines(tpol, torch.from_numpy(lines), n_pages)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpol.tiers(n_pages).numpy(),
                                  np.asarray(jpol.tiers(n_pages)))
    assert tnuma.describe(tpol) == jnuma.describe(jpol)


def test_hdm_decode_matches_jax():
    jp = jhdm.InterleaveProgram(base=1 << 32, size=6 << 28, ways=3,
                                granularity=1024, targets=(4, 5, 6))
    tp = thdm.InterleaveProgram(**dataclasses.asdict(jp))
    for hpa in range(1 << 32, (1 << 32) + 20_000, 333):
        assert tp.decode(hpa) == jp.decode(hpa)
        assert tp.encode(*tp.decode(hpa)) == hpa
    pages = np.arange(50, dtype=np.int32)
    np.testing.assert_array_equal(
        thdm.weighted_page_policy(torch.from_numpy(pages), 3, 2).numpy(),
        np.asarray(jhdm.weighted_page_policy(pages, 3, 2)))


def _counters(rng, b, n_t):
    """Random counter rows plus the guard cases of `time_batch`."""
    ns = 8 + 2 * n_t
    s = rng.integers(0, 5000, (b, ns)).astype(np.int64)
    s[:, 1] = s[:, 2] + s[:, 3]            # l1 misses feed the L2
    s[0] = 0                               # zero accesses
    s[1, 4 + 1] = 0                        # no CXL reads ...
    s[1, 4 + n_t + 1] = 0                  # ... nor writes: idle CXL latency
    s[2, 4:4 + 2 * n_t] = 0                # no memory traffic at all
    return s


TIMINGS = {
    "default": {},
    "mshr": dict(dram=jtiming.DramTiming(mshr=4),
                 cxl=jtiming.CXLTiming(mshr=8, lanes=4)),
}


@pytest.mark.parametrize("timing", sorted(TIMINGS))
@pytest.mark.parametrize("dist", [None, (64, 3)])
def test_time_batch_matches_jax(timing, dist):
    rng = np.random.default_rng(4)
    stats = _counters(rng, 8, 2)
    jt = jtiming.TimingConfig(**TIMINGS[timing])
    tt = convert.timing_config(dataclasses.asdict(jt))
    jcpus = [jmachine.CPUModel(kind=k, mlp=m) for k, m in
             [("inorder", 8), ("o3", 8), ("o3", 4), ("inorder", 1)] * 2]
    tcpus = [convert.cpu_model(dataclasses.asdict(c)) for c in jcpus]
    jd = td = None
    if dist is not None:
        jd = jtiming.LatencyDistribution(n_samples=dist[0], seed=dist[1])
        td = ttiming.LatencyDistribution(n_samples=dist[0], seed=dist[1])
    want = jmachine.time_batch(jt, jcpus, stats, dist=jd)
    got = tmachine.time_batch(tt, tcpus, stats, dist=td)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]
    assert [r.row() for r in got] == [r.row() for r in want]
    assert got[0].time_ns == 0.0


def test_time_batch_mig_lines_matches_jax():
    rng = np.random.default_rng(8)
    stats = _counters(rng, 4, 2)
    mig = rng.integers(0, 300, (4, 2, 2))
    cpus = [jmachine.CPUModel()] * 4
    want = jmachine.time_batch(jtiming.TimingConfig(), cpus, stats,
                               mig_lines=mig)
    got = tmachine.time_batch(
        ttiming.TimingConfig(), [tmachine.CPUModel()] * 4, stats,
        mig_lines=mig)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


def test_cli_flow_matches_jax():
    jcfg = jsim.SimConfig(expander_gib=(16, 8), n_cores=2)
    tcfg = convert.sim_config(dataclasses.asdict(jcfg))
    j = jsim.CXLRAMSim(jcfg)
    t = tsim.CXLRAMSim(tcfg, device="cpu")
    assert t.memdevs() == j.memdevs()
    assert t.numastat() == j.numastat()
    assert t.online("znuma") == j.online("znuma")
    assert t.numastat() == j.numastat()
    assert t.latency_breakdown() == j.latency_breakdown()
    jf = jtopo.build_default_system(8, (4, 4, 16), 6)
    tf = ttopo.build_default_system(8, (4, 4, 16), 6)
    assert tf[2].list_regions() == jf[2].list_regions()
    assert tf[2].online_memory("region1", mode="flat").kind == \
        jf[2].online_memory("region1", mode="flat").kind
    assert tf[2].numastat() == jf[2].numastat()
    assert tf[1].resolve(5 << 30)[2:] == jf[1].resolve(5 << 30)[2:]


def test_conversions_round_trip():
    jcfg = jsim.SimConfig(
        dram_gib=32, expander_gib=(8, 8), n_cores=8,
        cache=jcache.CacheParams(cores=4, n_targets=3),
        timing=jtiming.TimingConfig(cxl=jtiming.CXLTiming(lanes=16,
                                                          mshr=16)),
        cpu=jmachine.CPUModel(kind="inorder", freq_ghz=2.5))
    d = dataclasses.asdict(jcfg)
    assert dataclasses.asdict(convert.sim_config(d)) == d
    q = jtiming.QueueModel(idle_ns=90.0, service_ns=18.0, rho_max=0.9)
    tq = convert.queue_model(dataclasses.asdict(q))
    np.testing.assert_array_equal(tq.latency_ns(np.linspace(0, 1, 9)),
                                  q.latency_ns(np.linspace(0, 1, 9)))
    for kind, fields in POLICIES:
        jpol = getattr(jnuma, kind)(**fields)
        tpol = convert.policy(kind, dataclasses.asdict(jpol))
        assert dataclasses.asdict(tpol) == dataclasses.asdict(jpol)
    rng = np.random.default_rng(3)
    carry = (rng.integers(-1, 9, (2, 2, 4, 2, 3)),
             rng.integers(-1, 9, (2, 8, 4, 5)), rng.integers(0, 9, (2, 12)),
             rng.integers(1, 9, (2,)))
    back = convert.carry_to_numpy(convert.carry_from_numpy(*carry))
    for b, c in zip(back, carry):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(b, c)
    with pytest.raises(ValueError, match="unknown policy"):
        convert.policy("Nope", {})
