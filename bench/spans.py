"""Host, device and idle time of the program's spans in a cell's traced
stretch, one seed after another.

    python3 bench/spans.py --workload <cell> --seeds 11,12,13 [--seconds 25]

For each seed: the cell's set-up; an untraced window of ``--seconds`` at
the cell's own load; then the stretch a ``--trace 1`` run traces (the
traffic's ``profile_units`` sweeps or decode steps), where the program's
``repro_torch.*`` spans lie on the profiler's timeline beside the device
operations (``harness/spans.py``).  One JSON line per seed:

- ``untraced_ms`` / ``traced_ms``: a sweep's or a decode step's time in
  the untraced window (the median sweep; the mean decode step) and in the
  traced stretch (its wall over its units): what tracing costs when on;
- ``per_unit``: the span metrics of ``harness.spans.PER_UNIT`` (ms per
  traced unit);
- ``no_span_idle``: the share of the device's idle time in the stretch
  whose next launch lies outside every span;
- ``span_gaps``: idle gaps that ``harness.trace`` put down to a
  ``repro_torch.`` span instead of a host operation (none expected);
- ``spans``: per stage, calls and host, self, device and idle seconds.

The run pins itself as ``run.py`` does; the benchmark's own runs never run
this.
"""
import argparse
import gc
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def traced_events(run, units: int):
    """`run.traced(units)` with the trace's events kept: the profile
    reduces them and deletes its file when it stops."""
    from harness import trace

    kept = []
    reduce = trace.reduce_trace

    def keep(events):
        kept.append(events)
        return reduce(events)

    trace.reduce_trace = keep
    try:
        prof = run.traced(units)
    finally:
        trace.reduce_trace = reduce
    return prof, kept[0]


def one_seed(cell, seed: int, seconds: float, device) -> dict:
    import torch

    from harness import spans as hs

    run = cell.generator().Run(cell, seed, device)
    e2e = run.window(seconds)
    serve = cell.traffic["generator"] == "serve"
    untraced = e2e["decode_step_ms"] if serve else run.notes["p50_ms"]
    prof, events = traced_events(run, cell.traffic["profile_units"])
    counters = run.counters()
    run.release()
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    s = prof.summary
    spans = hs.reduce_spans(events)
    units = counters["traced_steps" if serve else "traced_sweeps"]
    per_unit = {}
    for metric, (_, _, counter) in hs.PER_UNIT.items():
        if counter in counters:
            per_unit[metric] = hs.per_unit_ms(spans, metric, counters)
    return {"workload": cell.name, "seed": seed, "units": units,
            "untraced_ms": untraced, "traced_ms": s.window_us / units / 1e3,
            "window_s": s.window_us * 1e-6, "busy_s": s.busy_us * 1e-6,
            "per_unit": per_unit,
            "no_span_idle": hs.idle_share(spans, hs.NO_SPAN),
            "span_gaps": sorted({n for n, _ in s.gaps
                                 if n.startswith(hs.PREFIX)}),
            "e2e": e2e, "spans": hs.in_seconds(spans)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import run as bench_run

    bench_run.pin_host()
    import torch

    torch.set_num_threads(1)
    from harness.core import Cell
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    card = (bench_run.power_limit() if device.type == "cuda" else "cpu")
    cell = Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = one_seed(cell, seed, args.seconds, device)
        print(json.dumps(dict(line, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
