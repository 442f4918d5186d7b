"""The port's cache-pollution probe and MoEStream against the JAX package's.

`MoEStream`'s device and host traces must equal the JAX package's bit for
bit (its torch form reduces the hash modulo the expert count in int64),
its sweep rows must equal the JAX rows, and `pollution_probe` must return
the JAX package's dict key for key.  `chip_smoke.py` holds the Table-I
probe dicts as constants (it cannot import JAX on the card's machine);
the last test checks them against the JAX package.

Tolerance: none.  Traces and counters are integers; rows and probe dicts
(floats included) are compared exactly after JSON normalisation.
"""
import dataclasses
import json
import pathlib
import runpy

import numpy as np
import pytest
import torch

from repro import workloads as jworkloads
from repro.core import cache as jcache
from repro.core import engine as jengine
from repro.core import numa as jnuma
from repro.core import route as jroute
from repro.core.machine import CPUModel as JCPU
from repro.core.timing import TimingConfig as JTiming
from repro_torch import convert
from repro_torch import workloads as tworkloads
from repro_torch.core import engine as tengine
from repro_torch.core import numa as tnuma
from repro_torch.core import route as troute
from repro_torch.core.cache import CacheParams
from repro_torch.core.machine import CPUModel
from repro_torch.core.timing import TimingConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)
FP = 32 * 1024      # tests/test_workloads.py's footprint


def normalised(x):
    return json.loads(json.dumps(x))


# ---------------------------------------------------------------------------
# MoEStream: traces bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fp", [FP, 16 * 1024, 8 * 16 * 1024])
@pytest.mark.parametrize("seed", [3, 8, 0xFFFFFFFF])
def test_moe_stream_traces_equal_jax(fp, seed):
    j, t = jworkloads.MoEStream(seed=seed), tworkloads.MoEStream(seed=seed)
    jd, jh = j.device_trace(fp), j.host_trace(fp)
    td, th = t.device_trace(fp, "cpu"), t.host_trace(fp)
    assert td.n_pages == th.n_pages == jd.n_pages == jh.n_pages
    assert td.addr.dtype == torch.int32
    np.testing.assert_array_equal(td.addr.numpy(), np.asarray(jd.addr))
    np.testing.assert_array_equal(th.addr, jh.addr)
    np.testing.assert_array_equal(td.is_write.numpy(),
                                  np.asarray(jd.is_write, np.int32))
    np.testing.assert_array_equal(th.is_write, jh.is_write)
    assert td.tier is None and th.tier is None


def test_moe_stream_geometry_and_registry():
    wl = convert.workload("MoEStream", dataclasses.asdict(
        jworkloads.MoEStream(seed=5, sweeps=3)))
    assert wl == tworkloads.MoEStream(seed=5, sweeps=3)
    assert tworkloads.get("moe_stream") == tworkloads.MoEStream()
    assert tworkloads.REGISTRY["moe_stream"] is tworkloads.MoEStream
    # qwen3-moe-235b-a22b: 128 experts, top-8; 2 sweeps = 32 tokens
    assert tworkloads.MoEStream()._geometry(FP) == \
        jworkloads.MoEStream()._geometry(FP) == (128, 8, 4, 32)
    with pytest.raises(ValueError, match="no MoE geometry"):
        tworkloads.MoEStream(arch="h2o-danube-3-4b").host_trace(FP)


# ---------------------------------------------------------------------------
# MoEStream: sweep rows
# ---------------------------------------------------------------------------
def test_moe_stream_sweep_rows_equal_jax():
    jspec = jengine.SweepSpec(
        footprint_factors=(1, 2), policies=(jnuma.ZNuma(1.0),),
        cpus=(JCPU(kind="o3", mlp=8),),
        workloads=(jworkloads.MoEStream(seed=8),),
        topologies=(jroute.direct(1), jroute.direct(2)))
    tspec = tengine.SweepSpec(
        footprint_factors=(1, 2), policies=(tnuma.ZNuma(1.0),),
        cpus=(CPUModel(kind="o3", mlp=8),),
        workloads=(tworkloads.MoEStream(seed=8),),
        topologies=(troute.direct(1), troute.direct(2)))
    want = normalised(jengine.run_sweep(
        jspec, jcache.CacheParams(**GEOMETRY), JTiming()))
    got = normalised(tengine.run_sweep(tspec, CacheParams(**GEOMETRY),
                                       TimingConfig(), device="cpu"))
    assert got == want
    assert {r["workload"] for r in got} == {"moe_stream"}


# ---------------------------------------------------------------------------
# pollution_probe: the JAX package's dict, key for key
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("knobs", [{}, dict(probe_fraction=0.125,
                                            pollutor_factor=1)],
                         ids=["defaults", "0.125-1"])
def test_pollution_probe_equals_jax(knobs):
    want = jworkloads.pollution_probe(jcache.CacheParams(**GEOMETRY),
                                      **knobs)
    got = tworkloads.pollution_probe(CacheParams(**GEOMETRY), device="cpu",
                                     **knobs)
    assert list(got) == list(want)
    assert normalised(got) == normalised(want)
    assert got["pollution_delta"] == (got["probe_miss_rate_polluted"]
                                      - got["probe_miss_rate_clean"])


def test_pollution_probe_backends_and_validation():
    p = CacheParams(**GEOMETRY)
    knobs = dict(probe_fraction=0.125, pollutor_factor=1, seed=4)
    assert tworkloads.pollution_probe(p, device="cpu", **knobs) == \
        tworkloads.pollution_probe(p, device="cpu", backend="reference",
                                   chunk=64, **knobs) == \
        normalised(jworkloads.pollution_probe(jcache.CacheParams(**GEOMETRY),
                                              **knobs))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tworkloads.pollution_probe(p, device="cpu", backend="cuda", **knobs)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tworkloads.pollution_probe(p, device="cpu", chunk=0, **knobs)


def test_chip_smoke_probe_constants_equal_jax():
    """The dicts `chip_smoke.py` must reproduce on the card are the JAX
    package's (its default reference backend, on the CPU)."""
    consts = runpy.run_path(str(ROOT / "chip_smoke.py"),
                            run_name="chip_smoke_constants")
    knobs, table = consts["POLLUTION_KNOBS"], consts["POLLUTION"]
    assert set(knobs) == set(table) == {"table1", "table1 (0.25, 1)",
                                         "golden (0.125, 1)"}
    for label, want in table.items():
        cache = (jcache.CacheParams(**GEOMETRY) if label.startswith("golden")
                 else jcache.CacheParams())
        got = jworkloads.pollution_probe(cache, **knobs[label])
        assert normalised(got) == want, label
