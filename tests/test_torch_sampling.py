"""The port's SMARTS sampling layer against the JAX package's.

Tolerance: none.  Window flags, window sums and point estimates are
integers and must be equal; quantiles, intervals and rows are host float64
arithmetic in the same order as the JAX package's, so they must be equal
to the last ulp; `tests/golden/sampling.json` must be reproduced exactly.
"""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest

from repro import workloads as jworkloads
from repro.core import cache as jcache
from repro.core import engine as jengine
from repro.core import numa as jnuma
from repro.core import sampling as jsampling
from repro.core import tiering_dyn as jdyn
from repro.core import timing as jtiming
from repro.core.machine import CPUModel as JCPU
from repro_torch import convert
from repro_torch import workloads as tworkloads
from repro_torch.core import cache as tcache
from repro_torch.core import engine as tengine
from repro_torch.core import numa as tnuma
from repro_torch.core import sampling as tsampling
from repro_torch.core.machine import CPUModel
from repro_torch.core.timing import TimingConfig

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
GEOMETRY = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)


def normalised(rows):
    return json.loads(json.dumps(rows))


@pytest.mark.parametrize("confidence", [0.5, 0.9, 0.95, 0.99, 0.999])
def test_quantiles_match_jax(confidence):
    assert tsampling.z_score(confidence) == jsampling.z_score(confidence)
    for df in (0, 1, 2, 3, 7, 30, 1000):
        assert tsampling.t_score(confidence, df) == \
            jsampling.t_score(confidence, df)


@pytest.mark.parametrize("spec", [(0, 1, 1), (1, 1, 4), (2, 3, 8), (1, 1, 8)])
def test_window_arithmetic_matches_jax(spec):
    jspec = jsampling.SamplingSpec(*spec)
    tspec = convert.sampling_spec(dataclasses.asdict(jspec))
    assert tspec.label == jspec.label
    assert tsampling.describe(tspec) == jsampling.describe(jspec)
    for slot in (512, 256, 128):
        scal = tsampling.scan_scalars(tspec, slot)
        assert scal == jsampling.scan_scalars(jspec, slot)
        flags = tsampling.measure_flags(50, *scal)
        assert np.array_equal(flags, jsampling.measure_flags(50, *scal))
        assert tsampling.window_spans(flags) == jsampling.window_spans(flags)
    assert tsampling.ci_column_names(3) == jsampling.ci_column_names(3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    e, ns = 64, tcache.nstats(3)
    flags = jsampling.measure_flags(e, 1, 2, 5)
    deltas = rng.integers(0, 200, (e, ns)) * flags[:, None]
    acc = rng.integers(100, 512, e)
    acc[-7:] = 0                       # trailing padding slots
    want = jsampling.estimate(deltas, acc, flags, confidence=0.9)
    got = tsampling.estimate(deltas, acc, flags, confidence=0.9)
    for field in ("stats", "ci", "window_sums", "window_acc"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
    assert (got.n_windows, got.total_acc, got.measured_acc,
            got.sampled_frac) == (want.n_windows, want.total_acc,
                                  want.measured_acc, want.sampled_frac)
    assert got.l2_miss_rate_ci() == want.l2_miss_rate_ci()
    spec = tsampling.SamplingSpec(1, 2, 5, confidence=0.9)
    host = tsampling.host_estimate(spec, deltas, acc, slot_len=512)
    assert np.array_equal(host.stats, want.stats)
    one = tsampling.estimate(deltas[:3], acc[:3], flags[:3])
    assert one.n_windows == 1 and math.isinf(one.ci[0])


def test_snapshot_deltas_match_jax():
    snaps = np.cumsum(np.random.default_rng(1).integers(0, 9, (20, 12)),
                      axis=0)
    assert np.array_equal(tcache.snapshot_deltas(snaps),
                          jcache.snapshot_deltas(snaps))
    with pytest.raises(ValueError, match="snapshots"):
        tcache.snapshot_deltas(snaps[0])


def test_sampling_golden_rows_exact():
    spec = tengine.SweepSpec(
        footprint_factors=(8,), policies=(tnuma.ZNuma(1.0),),
        cpus=(CPUModel(kind="o3", mlp=8),), workloads=(tworkloads.Gups(),),
        sampling=(None, tsampling.SamplingSpec(warm_slots=1, measure_slots=1,
                                               period_slots=4)))
    rows = tengine.run_sweep(spec, tcache.CacheParams(**GEOMETRY),
                             TimingConfig(), device="cpu")
    want = json.loads((GOLDEN / "sampling.json").read_text())
    assert normalised(rows) == want


def test_sampled_and_tiered_sweep_rows_equal_jax():
    """Sampling and tiering together: the sweep scans at the gcd of the
    sampling slot and the epochs, so the sampled rows' windows nest in
    the epoch slots."""
    jspec = jengine.SweepSpec(
        footprint_factors=(1,), policies=(jnuma.ZNuma(0.5),),
        cpus=(JCPU(kind="inorder"), JCPU(kind="o3")),
        workloads=(jworkloads.Gups(updates_per_line=4),),
        tiering=(None, jdyn.DynamicTiering(epoch_len=256, budget=2)),
        sampling=(None, jsampling.SamplingSpec(0, 1, 2)))
    tspec = tengine.SweepSpec(
        footprint_factors=(1,), policies=(tnuma.ZNuma(0.5),),
        cpus=(CPUModel(kind="inorder"), CPUModel(kind="o3")),
        workloads=(tworkloads.Gups(updates_per_line=4),),
        tiering=(None, convert.dynamic_tiering(
            dataclasses.asdict(jspec.tiering[1]))),
        sampling=(None, convert.sampling_spec(
            dataclasses.asdict(jspec.sampling[1]))))
    want = jengine.run_sweep(jspec, jcache.CacheParams(**GEOMETRY),
                             jtiming.TimingConfig())
    got = tengine.run_sweep(tspec, tcache.CacheParams(**GEOMETRY),
                            TimingConfig(), device="cpu")
    assert normalised(got) == normalised(want)
    sampled = [r for r in got if r["sampling"] != "exact"]
    assert sampled and all("l1_hit_ci95" in r for r in sampled)
