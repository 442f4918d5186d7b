"""The port's workload generators against the JAX package's, exactly.

Tolerance: none.  Hashes, traces, page maps and counters are integers and
must be equal element for element; the golden `workloads.json` row
(floats included) must be reproduced exactly.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro import workloads as jworkloads
from repro.core import hdm as jhdm
from repro.core import numa as jnuma
from repro_torch import workloads as tworkloads
from repro_torch.core import engine as tengine
from repro_torch.core import hdm as thdm
from repro_torch.core import numa as tnuma
from repro_torch.core.cache import CacheParams
from repro_torch.core.machine import CPUModel
from repro_torch.core.timing import TimingConfig

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)
EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint64)


@pytest.mark.parametrize("seed", [0, 1, 5, 0x9E3779B9 ^ 5, 0xFFFFFFFF,
                                  1 << 40])
def test_mix32_matches_jax(seed):
    ctr = np.concatenate([EDGES, np.random.default_rng(seed & 0xFFFF)
                          .integers(0, 1 << 32, 512, dtype=np.uint64)])
    want = np.asarray(jworkloads.mix32(ctr.astype(np.uint32), seed, np))
    on_torch = tworkloads.mix32(torch.from_numpy(ctr.astype(np.int64)), seed)
    assert on_torch.dtype == torch.int64
    assert np.array_equal(on_torch.numpy(), want.astype(np.int64))
    assert np.array_equal(tworkloads.mix32(ctr.astype(np.uint32), seed), want)
    for x in (0, 0xFFFFFFFF, 123456789):
        assert tworkloads.mix32_int(x) == jworkloads.base.mix32_int(x)


@pytest.mark.parametrize("n", [2, 3, 4, 12, 1000, 4096, 262_144, 999_983])
def test_full_period_affine_matches_jax(n):
    for seed in (0, 7):
        got = tworkloads.full_period_affine(n, seed)
        assert got == jworkloads.full_period_affine(n, seed)
    if n <= 4096:   # one lap visits every residue once
        a, c, p0 = got
        seen, pos = set(), p0
        for _ in range(n):
            seen.add(pos)
            pos = (pos * a + c) % n
        assert len(seen) == n and pos == p0


GENERATORS = {
    "pointer_chase": lambda m: m.PointerChase(seed=3, hops_per_line=3),
    "gups": lambda m: m.Gups(seed=2, updates_per_line=3),
    "hot_cold": lambda m: m.HotCold(hot_page_frac=0.25),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("footprint", [16 * 1024, 1000 * 64, 128 * 1024])
def test_generator_traces_match_jax_and_host(name, footprint):
    jw = GENERATORS[name](jworkloads)
    tw = GENERATORS[name](tworkloads)
    assert tw == tworkloads.get(name, **dataclasses.asdict(tw))
    want = jw.device_trace(footprint)
    dev = tw.device_trace(footprint, "cpu")
    host = tw.host_trace(footprint)
    assert dev.n_pages == host.n_pages == want.n_pages
    assert dev.addr.dtype == dev.is_write.dtype == torch.int32
    for field in ("addr", "is_write"):
        w = np.asarray(getattr(want, field))
        assert np.array_equal(getattr(dev, field).numpy(), w), field
        assert np.array_equal(getattr(host, field), w), field
    assert tw.serial_deps == jw.serial_deps and tw.name == jw.name


def test_first_touch_page_map_matches_jax():
    rng = np.random.default_rng(4)
    line = rng.integers(0, 40 * 64, 3000).astype(np.int32)
    line[2990:] = -1
    tier = rng.integers(0, 4, 3000).astype(np.int32)
    want = jnuma.first_touch_page_map(tier, line, 48, xp=np)
    got = tnuma.first_touch_page_map(torch.from_numpy(tier),
                                     torch.from_numpy(line), 48)
    assert np.array_equal(got.numpy(), want)
    assert (got[40:] == 1).all()       # untouched pages default to CXL


@pytest.mark.parametrize("ways,gran", [(1, 256), (2, 256), (3, 1024),
                                       (4, 4096), (6, 256), (12, 512)])
def test_hdm_line_decode_matches_jax(ways, gran):
    kw = dict(base=0, size=ways * gran * 64, ways=ways, granularity=gran,
              targets=tuple(range(1, ways + 1)))
    jp, tp = jhdm.InterleaveProgram(**kw), thdm.InterleaveProgram(**kw)
    lines = np.arange(ways * gran, dtype=np.int32)
    jway, jdpa = jp.decode_lines(lines)
    tway, tdpa = tp.decode_lines(torch.from_numpy(lines))
    assert np.array_equal(tway.numpy(), np.asarray(jway))
    assert np.array_equal(tdpa.numpy(), np.asarray(jdpa))
    assert np.array_equal(tp.encode_lines(tway, tdpa).numpy(), lines)
    assert np.array_equal(thdm.traffic_split(tp, torch.from_numpy(lines))
                          .numpy(), np.asarray(jhdm.traffic_split(jp, lines)))


def test_workloads_golden_row_exact():
    spec = tengine.SweepSpec(footprint_factors=(2,),
                             policies=(tnuma.ZNuma(1.0),),
                             cpus=(CPUModel(kind="o3", mlp=8),),
                             workloads=(tworkloads.Gups(),))
    rows = tengine.run_sweep(spec, CacheParams(**GEOMETRY), TimingConfig(),
                             device="cpu")
    want = json.loads((GOLDEN / "workloads.json").read_text())
    assert json.loads(json.dumps(rows)) == [want]


def test_pointer_chase_collapses_mlp():
    cpu = CPUModel(kind="o3", mlp=8)
    assert tworkloads.PointerChase().cpu_for(cpu).effective_mlp == 1
    assert tworkloads.Gups().cpu_for(cpu) == cpu
