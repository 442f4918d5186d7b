"""The harness finds a cell's files by name, and a new cell, mix or metric
needs nothing but new files and entries."""
import json
import shutil

import torch

import run as bench_run
from bench_cells import small_sweep_cell
from harness.core import BENCH, Cell, percentile, read_json


def test_cells_resolve_to_their_files():
    bm = read_json(BENCH.parent / "BENCHMARK.json")
    for w in bm["workloads"]:
        cell = Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert (BENCH / "generators" / f"{cell.traffic['generator']}.py").exists()
        assert (BENCH / "reference"
                / f"{cell.config['reference']}.py").exists()
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer, "every cell reports a per-layer metric"
        for m in cell.per_layer:
            assert hasattr(cell.metric_reader(m["name"]), "read")


def test_every_metric_and_config_has_its_file():
    bm = read_json(BENCH.parent / "BENCHMARK.json")
    for m in bm["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for c in bm["configs"]:
        assert (BENCH.parent / c["file"]).exists()
        assert c["file"].startswith("bench/configs/")


def test_a_throwaway_mix_and_metric_need_only_new_files(tmp_path):
    """Copy the benchmark, add a traffic file, a metric file and the
    entries naming them, and run the new cell: no file that was there is
    edited."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    bm = read_json(BENCH.parent / "BENCHMARK.json")
    traffic = read_json(BENCH / "traffic" / "static_grid.json")
    traffic.update(footprint_x_l2=[1], placements=traffic["placements"][:2])
    (tmp_path / "bench" / "traffic" / "one_footprint.json").write_text(
        json.dumps(traffic))
    (tmp_path / "bench" / "metrics" / "sweeps_traced.py").write_text(
        "def read(ctx):\n    return ctx['counters']['traced_sweeps']\n")
    bm["workloads"].append({"name": "table1-cxl.one-footprint",
                            "config": "table1-cxl",
                            "traffic": "one_footprint", "chips": 1,
                            "why": "throwaway"})
    bm["per_layer"].append({"name": "sweeps_traced", "unit": "sweeps",
                            "better": "higher", "source": "program_counter",
                            "layer": "test", "moves": "sweep_p95_ms",
                            "workloads": ["table1-cxl.one-footprint"]})
    cell = small_sweep_cell(Cell("table1-cxl.one-footprint", bm,
                                 tmp_path / "bench"))
    cell.traffic["footprint_x_l2"] = [1]
    line, _, rc = bench_run.run_cell(cell, 3, 0.0, True,
                                     torch.device("cpu"))
    out = json.loads(line)
    assert rc == 0 and out["correct"]
    assert out["metrics"]["sweeps_traced"]["value"] == 1
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_percentile():
    xs = [float(x) for x in range(1, 101)]
    assert percentile(xs, 95) == 95.05
    assert percentile([3.0], 95) == 3.0
