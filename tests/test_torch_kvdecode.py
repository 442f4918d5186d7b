"""The port's KV-decode workload against the JAX package's, exactly.

Tolerance: none.  The recorded page log and the line traces are integers
and must equal ``repro.workloads.KVDecode``'s element for element, with
and without the cold-page offload to the CXL-SSD tier; sweep rows must
equal the JAX rows (counters bitwise, floats to the ulp), through a
topology (so ``RouteMap.targets_of_tiered_lines`` routes the tier
intent) and through dynamic tiering (whose first-touch page map the
intent seeds), as the tiering sweep of the benchmarks runs it.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import workloads as jworkloads
from repro.core import cache as jcache
from repro.core import engine as jengine
from repro.core import numa as jnuma
from repro.core import route as jroute
from repro.core import tiering_dyn as jdyn
from repro.core import timing as jtiming
from repro.core.machine import CPUModel as JCPU
from repro.memory import offload as joffload
from repro_torch import convert
from repro_torch import workloads as tworkloads
from repro_torch.core import engine as tengine
from repro_torch.core import numa as tnuma
from repro_torch.core.cache import CacheParams
from repro_torch.core.machine import CPUModel
from repro_torch.core.timing import TimingConfig
from repro_torch.memory import offload as toffload
from repro_torch.workloads import kv_decode as tkv

GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)
L2 = GEOMETRY["l2_bytes"]


def _pair(**kw):
    return jworkloads.KVDecode(**kw), tworkloads.KVDecode(**kw)


@pytest.mark.parametrize("kw,k", [
    (dict(), 1), (dict(), 4),
    (dict(ssd_cold_offload=2), 4),
    (dict(arch="h2o-danube-3-4b", seed=5, page_size=4, n_requests=4,
          max_running=3, hbm_fraction=0.5), 2),
])
def test_kv_decode_traces_equal_jax(kw, k):
    jw, tw = _pair(**kw)
    want = jw.host_trace(k * L2)
    got = tw.host_trace(k * L2)
    dev = tw.device_trace(k * L2, "cpu")
    assert got.n_pages == want.n_pages == dev.n_pages
    for f in ("addr", "is_write", "tier"):
        w = np.asarray(getattr(want, f))
        assert getattr(got, f).dtype == np.int32
        assert np.array_equal(getattr(got, f), w), f
        assert getattr(dev, f).dtype == torch.int32
        assert np.array_equal(getattr(dev, f).numpy(), w), f
    if kw.get("ssd_cold_offload"):
        assert 2 in set(np.asarray(want.tier).tolist())
    # the page log itself, step for step
    for a, b in zip(jworkloads.kv_decode._kv_scenario(jw, k * L2)[0],
                    tkv._kv_scenario(tw, k * L2)[0]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_kv_offload_tiers_equal_jax():
    rng = np.random.default_rng(0)
    for budget in (-1, 0, 3, 50):
        snap = rng.integers(0, 2, 40).astype(np.int8)
        last = rng.integers(0, 6, 40).astype(np.int64)   # ties on purpose
        want = joffload.kv_offload_tiers(snap, last, cxl_page_budget=budget)
        got = toffload.kv_offload_tiers(snap, last, cxl_page_budget=budget)
        assert got.dtype == np.int32 and np.array_equal(got, want)


def _rows(jspec, tspec):
    want = jengine.run_sweep(jspec, jcache.CacheParams(**GEOMETRY),
                             jtiming.TimingConfig())
    got = tengine.run_sweep(tspec, CacheParams(**GEOMETRY), TimingConfig(),
                            device="cpu")
    return json.loads(json.dumps(got)), json.loads(json.dumps(want))


def test_kv_decode_sweep_rows_equal_jax_through_a_topology():
    kws = (dict(), dict(ssd_cold_offload=2))
    jspec = jengine.SweepSpec(
        footprint_factors=(1,), policies=(jnuma.ZNuma(1.0),),
        cpus=(JCPU(kind="o3", mlp=8),),
        workloads=tuple(jworkloads.KVDecode(**kw) for kw in kws),
        topologies=(jroute.direct(1, ssd_gib=16),))
    tspec = tengine.SweepSpec(
        footprint_factors=(1,), policies=(tnuma.ZNuma(1.0),),
        cpus=(CPUModel(kind="o3", mlp=8),),
        workloads=tuple(tworkloads.KVDecode(**kw) for kw in kws),
        topologies=tuple(convert.topology_spec(dataclasses.asdict(t))
                         for t in jspec.topologies))
    got, want = _rows(jspec, tspec)
    assert got == want and len(got) == 2
    assert got[1]["bw_ssd_gbps"] > 0 == got[0]["bw_ssd_gbps"]


def test_kv_decode_sweep_rows_equal_jax_with_dynamic_tiering():
    jspec = jengine.SweepSpec(
        footprint_factors=(1,), policies=(jnuma.ZNuma(1.0),),
        cpus=(JCPU(kind="o3", mlp=8),),
        workloads=(jworkloads.KVDecode(),),
        tiering=(None, jdyn.DynamicTiering(256, 2, 1)))
    tspec = tengine.SweepSpec(
        footprint_factors=(1,), policies=(tnuma.ZNuma(1.0),),
        cpus=(CPUModel(kind="o3", mlp=8),),
        workloads=(tworkloads.KVDecode(),),
        tiering=(None, convert.dynamic_tiering(
            dataclasses.asdict(jspec.tiering[1]))))
    got, want = _rows(jspec, tspec)
    assert got == want and len(got) == 2
    assert got[1]["migrated_pages"] > 0


def test_kv_decode_by_name():
    assert tworkloads.get("kv_decode", seed=4) == tworkloads.KVDecode(seed=4)
    assert convert.workload("KVDecode", {"seed": 4}) == \
        tworkloads.KVDecode(seed=4)
    assert "kv_decode" in tworkloads.WORKLOADS
