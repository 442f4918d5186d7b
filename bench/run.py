"""Run one cell of the benchmark once, on the CUDA card, and print its line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (kernels built or loaded, weights and inputs made from the seed on
the card, the cell's own shapes warmed up), then a window of ``--seconds``
of closed-loop traffic; with ``--trace 1`` a short traced stretch follows.
Then the program's outputs are held against the plain reference.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, ``breakdown`` when traced, ``checks``
last); the last lines of standard error are the compared numbers beside
their limits.  Exits 2 without a card, and 3 when a JAX module was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# every cache the program or PyTorch keeps lives at a fixed path here
CACHE = BENCH / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def pin_host() -> None:
    """Load from this one process on two fixed cores with one intra-op
    thread (before torch is imported): the cells' time is mostly host
    dispatch, which a thread moved between cores, or contending with a
    pool of workers, spreads from run to run."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[2:4] if len(cores) >= 4 else cores[:2])
    os.environ["OMP_NUM_THREADS"] = "1"


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "not read"
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = None):
    """Drive one run of `cell` on `device`; returns (result line or None,
    standard error lines, exit code)."""
    import torch

    from harness.core import forbidden_modules, read_json, result_line

    t0 = T0 if t0 is None else t0
    err = []
    run = cell.generator().Run(cell, seed, device)
    setup_s = time.perf_counter() - t0
    e2e = run.window(seconds)
    e2e["setup_s"] = setup_s
    prof = run.traced(cell.traffic["profile_units"]) if trace else None
    peak = 0
    if device.type == "cuda":      # the process's peak, set-up included
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    counters = run.counters()
    run.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = run.check(cell.traffic["limits"])
    err.append(f"reference and comparison: "
               f"{time.perf_counter() - t_check:.1f} s")

    metrics = {}
    if trace:
        ctx = {"summary": prof.summary, "counters": counters,
               "config": cell.config, "traffic": cell.traffic,
               "peaks": read_json(BENCH / "harness" / "peaks.json")}
        for m in cell.per_layer:
            v = cell.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.entry["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        dev["busy_s"] = prof.summary.busy_us * 1e-6
        dev["window_s"] = prof.summary.window_us * 1e-6
        breakdown = prof.summary.breakdown()
    bad = forbidden_modules()
    if bad:
        err.append(f"loaded JAX or the JAX package: {', '.join(bad)}")
        return None, err, 3
    extra = {"build_s": run.build_s, "seed": seed, "window": run.notes,
             "card": power_limit() if device.type == "cuda" else "cpu"}
    line = result_line(checks.all_ok, run.attempted, run.failed, metrics,
                       dev, checks, breakdown, extra)
    return line, err + checks.lines(), 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_host()
    try:
        import torch

        torch.set_num_threads(1)
        from harness.core import Cell
        cell = Cell(args.workload)
        import repro_torch  # noqa: F401  (the program must be beside us)
    except (ImportError, FileNotFoundError, KeyError) as e:
        print(f"cannot set up {args.workload}: {e!r}", file=sys.stderr)
        return 2
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    line, err, rc = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0))
    for e in err:
        print(e, file=sys.stderr)
    sys.stderr.flush()
    if line is not None:
        print(line)
    return rc


if __name__ == "__main__":
    sys.exit(main())
