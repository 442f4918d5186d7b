"""Readings that the limits of a cell's comparison are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 [--control]

For each seed: the cell's set-up and a short window at its own load (one
batch or one sweep at least), then the numbers its run compares — the
program's outputs against the plain reference — and, with ``--control``,
the same numbers for the control: the reference put in the program's place
in the next lower precision (float32 timing for the sweeps, float8 operands
for the served model).  One JSON line per seed and side; the benchmark's
own runs never run this.
"""
import argparse
import gc
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def readings(cell, seed: int, seconds: float, control: bool, device):
    """(program readings, control readings or None) of one seed."""
    import torch

    run = cell.generator().Run(cell, seed, device)
    run.window(seconds)
    run.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = cell.traffic["limits"]
    if cell.traffic["generator"] == "sweep":
        prog = {n: it["value"] for n, it in run.check(limits).items.items()}
        ctrl = (cell.generator().control_readings(run, limits)
                if control else None)
    else:
        prog = run.readings()
        ctrl = run.readings("fp8", program=False) if control else None
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return prog, ctrl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from harness.core import Cell
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        prog, ctrl = readings(cell, seed, args.seconds, args.control, device)
        print(json.dumps({"seed": seed, "side": "program", **prog}),
              flush=True)
        if ctrl is not None:
            print(json.dumps({"seed": seed, "side": "control", **ctrl}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
