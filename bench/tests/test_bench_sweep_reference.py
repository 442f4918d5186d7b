"""The sweep reference against the port's rows at the golden geometry."""
import numpy as np
import pytest
import torch

from bench_cells import GOLDEN, small_sweep_cell, small_tiering_cell
from harness.core import BENCH, Cell, load_module

REF = load_module(BENCH / "reference" / "mesi_sweep.py", "test_ref_")
SWEEP = load_module(BENCH / "generators" / "sweep.py", "test_generator_")


@pytest.fixture(scope="module")
def run():
    cell = small_sweep_cell()
    r = SWEEP.Run(cell, 2**31 + 11, torch.device("cpu"))
    r.window(0.0)
    return r


def test_rows_equal_the_reference_bitwise(run):
    checks = run.check(run.cell.traffic["limits"])
    assert checks.items["counter_mismatch"]["value"] == 0
    assert checks.items["timing_rel_err"]["value"] == 0.0
    assert checks.all_ok


def test_control_fails_the_timing_limit(run):
    limits = run.cell.traffic["limits"]
    ctrl = SWEEP.control_readings(run, limits)
    assert ctrl["counter_mismatch"] == 0
    assert ctrl["timing_rel_err"] > 10 * limits["timing_rel_err"]


def test_seeded_placement_changes_placement_not_work():
    cell = small_sweep_cell()
    grids = [SWEEP.resolve_grid(cell.traffic, s) for s in range(40)]
    assert len({str(g["placements"]) for g in grids}) > 4
    # never a placement the grid already has: the program would share
    # its row and simulate less
    for g in grids + [SWEEP.resolve_grid(cell.traffic, 7100000003)]:
        pl = [str(p) for p in g["placements"]]
        assert len(set(pl)) == len(pl)
    n = {SWEEP.accesses_per_sweep(g, cell.config) for g in grids}
    assert len(n) == 1


def test_access_count_is_the_ports_trace_length():
    from repro_torch.workloads.base import Stream
    cell = small_sweep_cell()
    grid = SWEEP.resolve_grid(cell.traffic, 1)
    want = sum(Stream("triad").host_trace(k * GOLDEN["l2_bytes"]).addr.size
               for k in grid["footprint_x_l2"]) * len(grid["placements"])
    assert SWEEP.accesses_per_sweep(grid, cell.config) == want


def test_trace_rebuild_equals_the_ports():
    from repro_torch.core import numa, stream
    t = small_sweep_cell().config["trace"]
    for fp in (3 * 8 * 10, 65536, 2 * 1024 * 1024 + 5):
        addr, w, pages = REF.stream_trace("triad", fp, t)
        lay = stream.layout_for_footprint(fp)
        pa, pw = stream.stream_trace("triad", lay)
        assert np.array_equal(addr, pa.numpy()) and pages == lay.n_pages
        assert np.array_equal(w, pw.numpy())
        for pl, pol in (({"kind": "znuma", "cxl_fraction": 0.3},
                         numa.ZNuma(0.3)),
                        ({"kind": "interleave", "dram_weight": 3,
                          "cxl_weight": 2}, numa.WeightedInterleave(3, 2))):
            assert np.array_equal(REF.placement_tiers(pl, pages),
                                  pol.tiers(pages).numpy())


def test_a_wrong_counter_is_caught(run):
    run.rows[0][3]["stats"]["l2_miss"] += 1
    try:
        checks = run.check(run.cell.traffic["limits"])
        assert checks.items["counter_mismatch"]["value"] == 1
        assert not checks.all_ok
    finally:
        run.rows[0][3]["stats"]["l2_miss"] -= 1


def test_calibration_reads_both_sides():
    import calibrate
    cell = small_sweep_cell()
    prog, ctrl = calibrate.readings(cell, 9, 0.0, True, torch.device("cpu"))
    assert prog == {"counter_mismatch": 0, "timing_rel_err": 0.0}
    assert ctrl["timing_rel_err"] > 1e-9


def test_a_nan_in_a_timed_column_is_caught(run):
    saved = run.rows[-1][0]["time_ns"]
    run.rows[-1][0]["time_ns"] = float("nan")
    try:
        checks = run.check(run.cell.traffic["limits"])
        assert checks.items["timing_rel_err"]["value"] == float("inf")
        assert not checks.all_ok and run.failed == 1
    finally:
        run.rows[-1][0]["time_ns"] = saved


# ---- the dynamic-tiering grid ---------------------------------------------
DYN = load_module(BENCH / "reference" / "dyn_sweep.py", "test_dyn_")
TRACE = {"elem_bytes": 8, "line_bytes": 64, "page_bytes": 4096}


@pytest.fixture(scope="module")
def tiering_run():
    cell = small_tiering_cell()
    r = SWEEP.Run(cell, 2**31 + 13, torch.device("cpu"))
    r.window(0.0)
    return r


def test_tiering_rows_equal_the_reference_bitwise(tiering_run):
    rows = tiering_run.rows[0]
    assert any(r.get("migrated_pages") for r in rows)
    checks = tiering_run.check(tiering_run.cell.traffic["limits"])
    assert checks.items["counter_mismatch"]["value"] == 0
    assert checks.items["timing_rel_err"]["value"] == 0.0


def test_tiering_control_fails_the_timing_limit(tiering_run):
    limits = tiering_run.cell.traffic["limits"]
    ctrl = SWEEP.control_readings(tiering_run, limits)
    assert ctrl["counter_mismatch"] == 0
    assert ctrl["timing_rel_err"] > 10 * limits["timing_rel_err"]


def test_tiering_seed_changes_addresses_not_work():
    cell = small_tiering_cell()
    grids = [SWEEP.resolve_grid(cell.traffic, s) for s in (1, 2**31 + 5)]
    assert grids[0]["workloads"] != grids[1]["workloads"]
    n = {SWEEP.accesses_per_sweep(g, cell.config) for g in grids}
    assert len(n) == 1


@pytest.mark.parametrize("footprint", [64 * 1024, 16 << 20])
def test_workload_traces_equal_the_ports(footprint):
    from repro_torch.workloads import Gups, HotCold, KVDecode
    for seed in (5, 2**31 - 7):
        a = DYN.hot_cold({"seed": seed, "hot_page_frac": 0.25,
                          "hot_access_frac": 0.9, "accesses_per_line": 4},
                         footprint, TRACE)
        b = HotCold(seed=seed, hot_page_frac=0.25).host_trace(footprint)
        assert np.array_equal(a[0], b.addr) and a[2] == b.n_pages
        assert np.array_equal(a[1], b.is_write.astype(bool))
        a = DYN.gups({"seed": seed, "updates_per_line": 2}, footprint, TRACE)
        b = Gups(seed=seed).host_trace(footprint)
        assert np.array_equal(a[0], b.addr) and a[2] == b.n_pages
        assert np.array_equal(a[1], b.is_write.astype(bool))
    kv = next(w for w in Cell("table1-cxl.tiering-grid").traffic["workloads"]
              if w["kind"] == "kv_decode")
    for extra in ({}, {"max_pool_pages": 8, "n_requests": 3},
                  {"seed": 11, "n_requests": 9, "max_running": 3}):
        params = dict(kv["params"], **extra)
        a = DYN.kv_decode(dict(params, kv_geometry=kv["kv_geometry"]),
                          footprint, TRACE)
        b = KVDecode(**params).host_trace(footprint)
        assert np.array_equal(a[0], b.addr) and a[2] == b.n_pages
        assert np.array_equal(a[1], b.is_write.astype(bool))
        assert np.array_equal(a[3], b.tier)


def test_kv_geometry_is_the_ports():
    from repro_torch.configs import get_smoke
    kv = next(w for w in Cell("table1-cxl.tiering-grid").traffic["workloads"]
              if w["kind"] == "kv_decode")
    cfg = get_smoke(kv["params"]["arch"])
    assert kv["kv_geometry"] == {"n_kv_heads": cfg.n_kv_heads,
                                 "head_dim": cfg.head_dim}


@pytest.mark.parametrize("epoch,budget,threshold,cap", [
    (2048, 16, 8, None), (4096, 8, 8, None), (2048, 16, 8, 100)])
def test_epoch_replay_equals_the_ports(epoch, budget, threshold, cap):
    from repro_torch.core import tiering_dyn as td
    addr, _, n_pages, _ = DYN.hot_cold(
        {"seed": 99, "hot_page_frac": 0.25, "hot_access_frac": 0.9,
         "accesses_per_line": 4}, 16 << 20, TRACE)
    pmap0 = np.ones(n_pages, np.int64)
    if cap:
        pmap0[:50] = 0
    slot = 2048
    tg, mig, slots = DYN.replay(
        {"epoch_len": epoch, "budget": budget, "threshold": threshold,
         "dram_capacity_pages": cap}, addr, pmap0, n_pages, slot,
        -(-len(addr) // slot), 64)
    ptl = np.zeros((n_pages, 2), np.int64)
    ptl[:, 1] = 64
    h = td.host_simulate(td.DynamicTiering(epoch, budget, threshold,
                                           dram_capacity_pages=cap),
                         addr, np.ones(len(addr), np.int64), pmap0, n_pages,
                         ptl, slot)
    assert slots[:, 2:].sum() > 0
    assert np.array_equal(tg, h.target) and np.array_equal(slots, h.slots)
    assert np.array_equal(mig[0], h.mig_read)
    assert np.array_equal(mig[1], h.mig_write)
