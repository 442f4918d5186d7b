"""Small versions of the cells that a CPU test run can hold."""
import copy

from harness.core import Cell

GOLDEN = dict(l1_bytes=8 * 1024, l1_ways=2, l2_bytes=16 * 1024, l2_ways=8)
SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=160, vocab_size=512, window=64)


def small_sweep_cell(cell: Cell = None) -> Cell:
    """The static grid at the golden geometry, footprints 1 and 2 x L2."""
    cell = cell or Cell("table1-cxl.static-grid")
    cell.config = copy.deepcopy(cell.config)
    cell.config["cache"].update(GOLDEN)
    cell.traffic = dict(cell.traffic, footprint_x_l2=[1, 2],
                        profile_units=1)
    return cell


def small_serve_cell(cell: Cell = None) -> Cell:
    """The serving cell on danube's smoke widths, 3 requests of 24 + 6."""
    cell = cell or Cell("h2o-danube-3-4b.serve-spill")
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(SMOKE)
    cell.traffic = dict(cell.traffic, requests=3, prefill=24, decode=6,
                        page_size=4, hbm_pages=5, warmup_decode=2,
                        check_requests=4, profile_from=1, profile_units=2)
    return cell


def small_tiering_cell(cell: Cell = None) -> Cell:
    """The tiering grid at the golden geometry, footprint 2 x L2, epochs of
    256 and 512 accesses, a KV pool of 8 pages."""
    cell = cell or Cell("table1-cxl.tiering-grid")
    cell.config = copy.deepcopy(cell.config)
    cell.config["cache"].update(GOLDEN)
    tr = copy.deepcopy(cell.traffic)
    tr.update(footprint_x_l2=[2], profile_units=1,
              tiering=[None, {"epoch_len": 256, "budget": 4, "threshold": 2},
                       {"epoch_len": 512, "budget": 2, "threshold": 2}])
    kv = next(w for w in tr["workloads"] if w["kind"] == "kv_decode")
    kv["params"].update(max_pool_pages=8, n_requests=3)
    cell.traffic = tr
    return cell
