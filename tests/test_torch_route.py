"""The port's routing layer and topology axis against the JAX package's.

Tolerance: none.  Target ids, line tables and counters are integers and
must be equal element for element; rows (floats included) must equal the
JAX rows after JSON normalisation, and `tests/golden/topology.json` must be
reproduced exactly.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import engine as jengine
from repro.core import numa as jnuma
from repro.core import route as jroute
from repro.core import simulator as jsim
from repro.core import stream as jstream
from repro.core import timing as jtiming
from repro.core.machine import CPUModel as JCPU
from repro_torch import convert
from repro_torch.core import engine as tengine
from repro_torch.core import numa as tnuma
from repro_torch.core import route as troute
from repro_torch.core import simulator as tsim
from repro_torch.core import stream as tstream
from repro_torch.core.cache import CacheParams
from repro_torch.core.machine import CPUModel
from repro_torch.core.timing import TimingConfig

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)
TOPOLOGIES = {
    "direct1": lambda m: m.direct(1),
    "direct2": lambda m: m.direct(2),
    "switch4": lambda m: m.switched(4),
    "direct1+ssd": lambda m: m.direct(1, ssd_gib=16),
}


def normalised(rows):
    return json.loads(json.dumps(rows))


def routes(name):
    jspec = TOPOLOGIES[name](jroute)
    tspec = TOPOLOGIES[name](troute)
    assert convert.topology_spec(dataclasses.asdict(jspec)) == tspec
    return (jroute.build_route(jspec, jtiming.TimingConfig()),
            troute.build_route(tspec, TimingConfig()))


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_route_map_matches_jax(name):
    jr, tr = routes(name)
    assert (tr.name, tr.n_targets, tr.ssd_tid) == (jr.name, jr.n_targets,
                                                   jr.ssd_tid)
    for jt, tt in zip(jr.targets, tr.targets):
        assert (tt.tid, tt.name, tt.kind, tt.group, tt.group_payload_gbps,
                tt.device_payload_gbps) == (
            jt.tid, jt.name, jt.kind, jt.group, jt.group_payload_gbps,
            jt.device_payload_gbps)
        assert dataclasses.asdict(tt.timing) == dataclasses.asdict(jt.timing)
    assert [dataclasses.asdict(p) for p in tr.programs] == \
        [dataclasses.asdict(p) for p in jr.programs]
    rng = np.random.default_rng(len(name))
    lines = rng.integers(0, 64 * 512, 4000).astype(np.int32)
    tier = rng.integers(0, 3, 4000).astype(np.int32)
    pages = rng.integers(0, 3, 512).astype(np.int32)
    tl, tt = torch.from_numpy(lines), torch.from_numpy(tier)
    checks = [
        (tr.cxl_targets_of_lines(tl), jr.cxl_targets_of_lines(lines)),
        (tr.targets_of_tiered_lines(tt, tl),
         jr.targets_of_tiered_lines(tier, lines)),
        (tr.targets_of_dynamic_lines(torch.from_numpy(pages), tl),
         jr.targets_of_dynamic_lines(pages, lines)),
        (tr.page_target_lines(40, width=6), jr.page_target_lines(40, width=6)),
    ]
    for jpol in (jnuma.ZNuma(0.5), jnuma.WeightedInterleave(2, 1)):
        tpol = convert.policy(type(jpol).__name__, dataclasses.asdict(jpol))
        checks.append((tr.target_of_lines(tpol, tl, 512),
                       jr.target_of_lines(jpol, lines, 512)))
    for got, want in checks:
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_topology_golden_row_exact():
    spec = tengine.SweepSpec(footprint_factors=(2,),
                             policies=(tnuma.ZNuma(1.0),),
                             cpus=(CPUModel(kind="o3", mlp=8),),
                             topologies=(troute.direct(2),))
    rows = tengine.run_sweep(spec, CacheParams(**GEOMETRY), TimingConfig(),
                             device="cpu")
    want = json.loads((GOLDEN / "topology.json").read_text())
    assert normalised(rows) == [want]


def test_topology_sweep_rows_equal_jax():
    jspec = jengine.SweepSpec(
        footprint_factors=(1,),
        policies=(jnuma.ZNuma(0.5), jnuma.WeightedInterleave(1, 1)),
        cpus=(JCPU(kind="inorder"), JCPU(kind="o3")),
        topologies=(jroute.direct(1), jroute.direct(2), jroute.switched(4),
                    jroute.direct(1, ssd_gib=16)))
    tspec = tengine.SweepSpec(
        footprint_factors=(1,),
        policies=(tnuma.ZNuma(0.5), tnuma.WeightedInterleave(1, 1)),
        cpus=(CPUModel(kind="inorder"), CPUModel(kind="o3")),
        topologies=tuple(convert.topology_spec(dataclasses.asdict(t))
                         for t in jspec.topologies))
    want = jengine.run_sweep(jspec, jcache.CacheParams(**GEOMETRY),
                             jtiming.TimingConfig())
    got = tengine.run_sweep(tspec, CacheParams(**GEOMETRY), TimingConfig(),
                            device="cpu")
    assert normalised(got) == normalised(want)
    assert [r["topology"] for r in got[::4]] == ["direct1", "direct2",
                                                  "switch4", "direct1+ssd"]


def test_facade_route_and_run_trace_match_jax():
    jcfg = jsim.SimConfig(cache=jcache.CacheParams(**GEOMETRY),
                          expander_gib=(16, 16))
    j = jsim.CXLRAMSim(jcfg)
    t = tsim.CXLRAMSim(convert.sim_config(dataclasses.asdict(jcfg)),
                       device="cpu")
    jr, tr = j.route(), t.route()
    assert [x.name for x in tr.targets] == [x.name for x in jr.targets]
    assert [dataclasses.asdict(p) for p in tr.programs] == \
        [dataclasses.asdict(p) for p in jr.programs]
    lay = jstream.layout_for_footprint(GEOMETRY["l2_bytes"])
    ja, jw = jstream.stream_trace("triad", lay)
    ta, tw = tstream.stream_trace(
        "triad", tstream.layout_for_footprint(GEOMETRY["l2_bytes"]), "cpu")
    want = j.machine.run_trace(ja, jw, jnuma.ZNuma(1.0), lay.n_pages,
                               route=jr)
    got = t.machine.run_trace(ta, tw, tnuma.ZNuma(1.0), lay.n_pages,
                              route=tr)
    assert normalised(got.row()) == normalised(want.row())
    assert got.stats == want.stats


def test_stream_suite_sequential_equals_jax():
    jcfg = jsim.SimConfig(cache=jcache.CacheParams(**GEOMETRY))
    j = jsim.CXLRAMSim(jcfg)
    t = tsim.CXLRAMSim(convert.sim_config(dataclasses.asdict(jcfg)),
                       device="cpu")
    want = j.stream_suite_sequential((1,))
    got = t.stream_suite_sequential((1,))
    assert normalised(got) == normalised(want)
    batched = t.stream_suite((1,))
    assert got[0]["stats"] == batched[0]["stats"]
