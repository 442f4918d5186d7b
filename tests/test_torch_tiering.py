"""The port's epoch-structured dynamic tiering against the JAX package's.

The same NumPy-seeded batches go through ``repro.core.tiering_dyn.
run_dynamic(backend="reference")`` and through the port on the CPU, where
the epoch segment runs its plain PyTorch version (the plain version of the
``mesi_dyn_segment`` CUDA kernel, which `tests/test_torch_card.py` and
`chip_smoke.py` hold against it on the card).

Tolerance: none.  Stats, page maps, migration totals, per-slot counters,
snapshots and measurement flags are integers and must be equal element for
element; rows (floats included) equal after JSON normalisation, and
`tests/golden/fidelity.json` reproduced exactly.
"""
import dataclasses
import json
import pathlib

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
from repro_torch import convert
from repro_torch.core import cache as tcache
from repro_torch.core import engine as tengine
from repro_torch.core import numa as tnuma
from repro_torch.core import route as troute
from repro_torch.core import tiering_dyn as tdyn
from repro_torch.core.machine import CPUModel
from repro_torch.core.timing import LatencyDistribution, TimingConfig
from repro_torch.kernels import cache_sim as tkernels
from repro_torch.kernels import ops as tops

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)
SMALL = dict(l1_bytes=1024, l1_ways=2, l2_bytes=4096, l2_ways=4)
UNBOUNDED = jdyn.UNBOUNDED_PAGES


def normalised(rows):
    return json.loads(json.dumps(rows))


def params(**kw):
    jp = jcache.CacheParams(**kw)
    return jp, convert.cache_params(dataclasses.asdict(jp))


def dyn_batch(seed, n_p, n=256, cores=2, n_targets=3):
    """Four rows: a two-tier row under DRAM pressure, a sampled row whose
    budget exceeds the page count, a three-tier row spilling to the SSD,
    and a static ride-along row with a sentinel tail."""
    rng = np.random.default_rng(seed)
    b = 4
    addr = rng.integers(0, n_p * 64, (b, n))
    hot = rng.integers(0, 64 * min(n_p, 4), (b, n))
    addr = np.where(rng.random((b, n)) < 0.6, hot, addr).astype(np.int32)
    addr[3, n - 40:] = jcache.SENTINEL
    trace = (addr, rng.integers(0, 2, (b, n)).astype(np.int32),
             rng.integers(0, cores, (b, n)).astype(np.int32),
             rng.integers(1, n_targets, (b, n)).astype(np.int32))
    pmap0 = rng.integers(0, 2, (b, n_p)).astype(np.int32)
    pmap0[2, :2] = 2
    kw = dict(slot_len=32, k_max=n_p + 3, page_map0=pmap0,
              dyn_flag=np.array([1, 1, 1, 0]),
              n_pages=np.array([n_p, n_p - 1, n_p, n_p]),
              budget=np.array([2, n_p + 3, 3, 0]),
              threshold=np.array([1, 2, 1, 1]),
              period=np.array([1, 2, 1, 1]),
              dram_cap=np.array([3, 2, UNBOUNDED, UNBOUNDED]),
              page_target_lines=rng.integers(0, 40, (b, n_p, n_targets))
              .astype(np.int32),
              ssd_tid=np.array([0, 0, n_targets - 1, 0]),
              cxl_cap=np.array([UNBOUNDED, UNBOUNDED, 2, UNBOUNDED]),
              s_warm=np.array([0, 1, 0, 0]), s_meas=np.array([0, 1, 0, 0]),
              s_per=np.array([0, 3, 0, 0]))
    return trace, kw


def as_torch(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def assert_outputs_equal(got, want):
    for field in want._fields:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field)
        assert g.dtype == torch.int32, field
        assert np.array_equal(g.numpy(), w), field


@pytest.mark.parametrize("cores,n_targets,n_p", [(1, 2, 6), (2, 3, 40),
                                                 (4, 3, 9)])
def test_run_dynamic_matches_jax(cores, n_targets, n_p):
    jp, tp = params(**SMALL, cores=cores, n_targets=n_targets)
    trace, kw = dyn_batch(cores + n_p, n_p, cores=cores, n_targets=n_targets)
    want = jdyn.run_dynamic(jp, *trace, backend="reference", **kw)
    tops.reset_launches()
    got = tdyn.run_dynamic(tp, *as_torch(*trace), **kw)
    assert tops.LAUNCHES["mesi_dyn_segment_ref"] == 1
    assert tops.LAUNCHES["mesi_dyn_segment"] == 0
    assert_outputs_equal(got, want)
    slots = got.slots.numpy()
    assert slots[:3, :, 2:].sum() > 0          # the dynamic rows migrate
    assert slots[3, :, 2:].sum() == 0          # the static row never does
    assert got.meas[1].tolist()[:6] == [0, 1, 0, 0, 1, 0]


def test_segments_and_a_jax_carry_continue_the_resident_run():
    jp, tp = params(**SMALL, cores=2, n_targets=3)
    trace, kw = dyn_batch(11, 12)
    resident = tdyn.run_dynamic(tp, *as_torch(*trace), **kw)
    assert_outputs_equal(tdyn.run_dynamic(tp, *as_torch(*trace),
                                          segment_slots=3, **kw), resident)
    # the first 4 slots in JAX, the rest in the port from the JAX carry
    a3, w3, c3, t3, pmap0, scalars, k_max, bound = \
        jdyn.prep_dynamic_inputs(*trace, **kw)
    jcarry, *_ = jdyn.run_dynamic_segment(
        jp, k_max, bound, jdyn.init_dyn_carry(jp, pmap0), a3[:, :4],
        w3[:, :4], c3[:, :4], t3[:, :4], *scalars)
    carry = convert.carry_from_numpy(*(np.asarray(x) for x in jcarry))
    tsc = [torch.from_numpy(np.array(x)) for x in scalars]
    carry, slots, snaps, meas = tdyn.run_dynamic_segment(
        tp, k_max, bound, carry,
        *(torch.from_numpy(np.array(x)[:, 4:]) for x in (a3, w3, c3, t3)),
        *tsc)
    assert torch.equal(carry[2], resident.stats)
    assert torch.equal(carry[4], resident.page_map)
    assert torch.equal(carry[6], resident.mig_read)
    assert torch.equal(carry[7], resident.mig_write)
    assert torch.equal(slots, resident.slots[:, 4:])
    assert torch.equal(snaps, resident.snapshots[:, 4:])
    assert torch.equal(meas, resident.meas[:, 4:])
    assert carry[8].tolist() == [a3.shape[1]] * 4


def test_static_ride_along_row_equals_the_static_kernel_path():
    _, tp = params(**SMALL, cores=2, n_targets=3)
    trace, kw = dyn_batch(5, 8)
    out = tdyn.run_dynamic(tp, *as_torch(*trace), **kw)
    stats, _ = tengine.run_traces(tp, *as_torch(*(x[3:] for x in trace)))
    assert torch.equal(out.stats[3:], stats)


def test_plain_version_rejects_the_cuda_backend_on_cpu_tensors():
    _, tp = params(**SMALL)
    trace, kw = dyn_batch(1, 6, n_targets=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdyn.run_dynamic(tp, *as_torch(*trace), backend="cuda", **kw)


@pytest.mark.parametrize("case", ["two_tier", "dram_cap", "three_tier",
                                  "static"])
def test_host_simulate_matches_jax(case):
    rng = np.random.default_rng(3)
    n_p, n = 24, 2048
    addr = np.where(rng.random(n) < 0.7, rng.integers(0, 64 * 6, n),
                    rng.integers(0, 64 * n_p, n)).astype(np.int32)
    addr[-100:] = jcache.SENTINEL
    cxl_t = rng.integers(1, 3, n).astype(np.int32)
    pmap0 = np.ones(n_p, np.int32)
    pmap0[::5] = 0
    ptl = rng.integers(0, 64, (n_p, 4)).astype(np.int32)
    tiering = {"two_tier": dict(epoch_len=128, budget=3, threshold=2),
               "dram_cap": dict(epoch_len=64, budget=4, threshold=1,
                                dram_capacity_pages=5),
               "three_tier": dict(epoch_len=128, budget=4, threshold=1,
                                  cxl_capacity_pages=6),
               "static": None}[case]
    jt = None if tiering is None else jdyn.DynamicTiering(**tiering)
    tt = None if tiering is None else convert.dynamic_tiering(tiering)
    ssd = 3 if case == "three_tier" else 0
    want = jdyn.host_simulate(jt, addr, cxl_t, pmap0, n_p - 2, ptl, 64,
                              ssd_tid=ssd)
    got = tdyn.host_simulate(tt, addr, cxl_t, pmap0, n_p - 2, ptl, 64,
                             ssd_tid=ssd)
    for field in ("target", "page_map", "mig_read", "mig_write", "slots"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
    assert got.migrated_pages == want.migrated_pages
    period = 1 if tiering is None else tiering["epoch_len"] // 64
    assert tdyn.epoch_fractions(got.slots, period) == \
        jdyn.epoch_fractions(want.slots, period)


def test_hot_keys_labels_and_slot_length_match_jax():
    count = np.array([0, 3, 3, 7, 100], np.int32)
    page = np.array([4, 0, 2, 1, 3], np.int32)
    want = np.asarray(jdyn.encode_hot_key(count, page, 5, np))
    assert np.array_equal(tdyn.encode_hot_key(count, page, 5), want)
    key = tdyn.encode_hot_key(torch.from_numpy(count),
                              torch.from_numpy(page), 5)
    assert np.array_equal(key.numpy(), want)
    back = tdyn.decode_hot_key(key, 5)
    assert torch.equal(back[0], torch.from_numpy(count))
    assert torch.equal(back[1], torch.from_numpy(page))
    cfg = dict(epoch_len=2048, budget=16, threshold=8,
               dram_capacity_pages=3, cxl_capacity_pages=1024)
    assert tdyn.describe(convert.dynamic_tiering(cfg)) == \
        jdyn.describe(jdyn.DynamicTiering(**cfg))
    assert tdyn.describe(None) == "static"
    tiers = [tdyn.DynamicTiering(epoch_len=e) for e in (768, 512)] + [None]
    assert tdyn.slot_length(tiers) == 256
    with pytest.raises(ValueError, match="threshold"):
        tdyn.DynamicTiering(threshold=0)


def test_epoch_key_overflow_raises_like_jax():
    kw = dict(slot_len=1 << 16, k_max=4, dyn_flag=[1], n_pages=[1 << 15],
              budget=[1], threshold=[1], period=[1], dram_cap=[1],
              page_map0=np.ones((1, 1 << 15), np.int32),
              page_target_lines=np.zeros((1, 1 << 15, 2), np.int32))
    addr = np.zeros((1, 1 << 16), np.int32)
    with pytest.raises(ValueError, match="overflow int32"):
        jdyn.prep_dynamic_inputs(addr, None, None, None, **kw)
    with pytest.raises(ValueError, match="overflow int32"):
        tdyn.prep_dynamic_inputs(torch.from_numpy(addr), None, None, None,
                                 **kw)


def test_fidelity_golden_rows_exact():
    spec = tengine.SweepSpec(
        footprint_factors=(8,), policies=(tnuma.ZNuma(1.0),),
        cpus=(CPUModel(kind="o3", mlp=8),),
        workloads=(convert.workload("HotCold", {"hot_page_frac": 0.25}),),
        topologies=(troute.direct(1, ssd_gib=16),),
        tiering=(tdyn.DynamicTiering(epoch_len=2048, budget=16, threshold=8,
                                     cxl_capacity_pages=8),),
        distributions=(None, LatencyDistribution(n_samples=128, seed=0)))
    tops.reset_launches()
    rows = tengine.run_sweep(spec, tcache.CacheParams(**GEOMETRY),
                             TimingConfig(), device="cpu")
    assert tops.LAUNCHES["mesi_dyn_segment_ref"] == 1
    want = json.loads((GOLDEN / "fidelity.json").read_text())
    assert normalised(rows) == want


def test_tiering_sweep_rows_equal_jax():
    jtier = (None, jdyn.DynamicTiering(epoch_len=256, budget=4, threshold=1),
             jdyn.DynamicTiering(epoch_len=512, budget=2, threshold=2,
                                 dram_capacity_pages=1))
    jspec = jengine.SweepSpec(
        footprint_factors=(1,), policies=(jnuma.ZNuma(1.0),),
        cpus=(JCPU(kind="o3", mlp=8),),
        workloads=(jworkloads.HotCold(hot_page_frac=0.25),
                   jworkloads.PointerChase(hops_per_line=2)),
        topologies=(jroute.direct(2),), tiering=jtier)
    tspec = tengine.SweepSpec(
        footprint_factors=(1,), policies=(tnuma.ZNuma(1.0),),
        cpus=(CPUModel(kind="o3", mlp=8),),
        workloads=tuple(convert.workload(type(w).__name__,
                                         dataclasses.asdict(w))
                        for w in jspec.workloads),
        topologies=(troute.direct(2),),
        tiering=tuple(None if t is None else
                      convert.dynamic_tiering(dataclasses.asdict(t))
                      for t in jtier))
    want = jengine.run_sweep(jspec, jcache.CacheParams(**GEOMETRY),
                             jtiming.TimingConfig())
    got = tengine.run_sweep(tspec, tcache.CacheParams(**GEOMETRY),
                            TimingConfig(), device="cpu")
    assert normalised(got) == normalised(want)
    assert {r["tiering"] for r in got} == {tdyn.describe(t)
                                            for t in tspec.tiering}
    assert sum(r.get("migrated_pages", 0) for r in got) > 0
