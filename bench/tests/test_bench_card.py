"""On the card: the reference's CUDA-graph steps against its eager steps,
and one short run of each cell.  Skips without a card."""
import json

import numpy as np
import pytest
import torch

import run as bench_run
from bench_cells import GOLDEN, small_sweep_cell
from harness.core import BENCH, Cell, load_module

REF = load_module(BENCH / "reference" / "mesi_sweep.py", "test_ref_")


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_graph_steps_equal_eager_steps():
    need_card()
    cfg = small_sweep_cell().config
    cache = dict(cfg["cache"], **GOLDEN)
    traces = []
    for k, frac in ((1, 0.0), (2, 1.0), (3, 0.5)):
        addr, w, pages = REF.stream_trace("triad", k * GOLDEN["l2_bytes"],
                                          cfg["trace"])
        tiers = REF.placement_tiers({"kind": "znuma", "cxl_fraction": frac},
                                    pages)
        traces.append((addr, w, tiers[np.minimum(addr // 64, pages - 1)]))
    eager = REF.simulate(traces, cache, device="cpu")
    for steps in (1, 7, 64):
        assert np.array_equal(REF.simulate(traces, cache, device="cuda",
                                           graph_steps=steps), eager)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["table1-cxl.static-grid",
                                  "h2o-danube-3-4b.serve-spill",
                                  "table1-cxl.tiering-grid"])
def test_a_short_run_of_each_cell_is_correct(name):
    need_card()
    line, err, rc = bench_run.run_cell(Cell(name), 12345, 1.0, False,
                                       torch.device("cuda", 0))
    out = json.loads(line)
    assert rc == 0 and out["correct"], err
