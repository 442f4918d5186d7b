"""The program's spans read from a trace: ``harness.spans.reduce_spans``
on hand-made events, the harness's own reduction unchanged by them, the
span metrics, and ``spans.py`` on the CPU."""
import pytest
import torch

import spans as spans_tool
from bench_cells import small_serve_cell, small_sweep_cell
from harness import spans as hs
from harness.trace import reduce_trace


def X(name, ts, dur, cat="user_annotation", **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def launch(ts, corr):
    return X("cudaLaunchKernel", ts, 1, "cuda_runtime", correlation=corr)


def kernel(ts, dur, corr):
    return X("k%d" % corr, ts, dur, "kernel", correlation=corr)


def sweep_events():
    """A window [100, 200] inside a sweep [90, 210]: the build [100, 130]
    with the traces [105, 120] in it, the fixed point [150, 170], a span
    before the window; five device operations, each launched inside an
    aten op, and a tail."""
    return [
        X(hs.PREFIX + "kv.gather_args", 30, 20),
        X("bench.window", 100, 100),
        X(hs.PREFIX + "sweep", 90, 120),
        X(hs.PREFIX + "engine.build", 100, 30),
        X(hs.PREFIX + "engine.traces", 105, 15),
        X(hs.PREFIX + "machine.time_batch", 150, 20),
        X("aten::arange", 106, 2, "cpu_op"), launch(107, 1),
        kernel(110, 5, 1),
        X("aten::copy_", 124, 2, "cpu_op"), launch(125, 2),
        kernel(140, 20, 2),
        X("aten::mul", 159, 2, "cpu_op"), launch(160, 3),
        kernel(165, 10, 3),
        X("aten::add", 94, 2, "cpu_op"), launch(95, 4),
        kernel(185, 5, 4),
        X("aten::fill_", 79, 2, "cpu_op"), launch(80, 5),
        kernel(192, 3, 5),
    ]


def test_reduce_spans_by_hand():
    s = hs.reduce_spans(sweep_events())
    assert set(s) == {"sweep", "engine.build", "engine.traces",
                      "machine.time_batch", hs.NO_SPAN, hs.TAIL}
    want = {  # calls, host, self, device, idle
        "sweep": (1, 100, 100 - 30 - 20, 5, 10),
        "engine.build": (1, 30, 15, 20, 25),
        "engine.traces": (1, 15, 15, 5, 10),
        "machine.time_batch": (1, 20, 20, 10, 5),
        hs.NO_SPAN: (0, 0, 0, 3, 2),
        hs.TAIL: (0, 0, 0, 0, 5),
    }
    for name, vals in want.items():
        assert tuple(s[name][f] for f in hs.FIELDS) == vals, name
    assert hs.idle_share(s, hs.NO_SPAN) == 2 / 57


def test_spans_before_the_profiler_and_open_at_its_stop():
    """Decode steps traced from inside one: the step around the first
    model call began before the profiler and is missing; the next step
    was still open when the profiler stopped, after the window."""
    events = [
        X("bench.window", 0, 50),
        X(hs.PREFIX + "serve.model#0", 0, 12),
        X(hs.PREFIX + "serve.sample#0", 12, 3),
        X(hs.PREFIX + "serve.model#1", 15, 5),
        X(hs.PREFIX + "serve.sample#1", 20, 5),
        X(hs.PREFIX + "serve.step", 30, 30),
        X(hs.PREFIX + "kv.gather_args", 31, 14),
        X("aten::mm", 1, 2, "cpu_op"), launch(2, 1), kernel(4, 6, 1),
        X("aten::mm", 16, 2, "cpu_op"), launch(17, 2), kernel(18, 1, 2),
        X("aten::copy_", 44, 1, "cpu_op"), launch(44, 3), kernel(47, 1, 3),
    ]
    s = hs.reduce_spans(events)
    assert s["serve.model"]["calls"] == 2
    assert s["serve.model"]["host_us"] == s["serve.model"]["self_us"] == 17
    assert s["serve.sample"]["host_us"] == 8
    assert s["serve.step"]["host_us"] == 20          # clipped at 50
    assert s["serve.step"]["self_us"] == 20 - 14
    assert s["serve.model"]["device_us"] == 7
    assert s["serve.model"]["idle_us"] == 4 + 8
    assert s["kv.gather_args"]["idle_us"] == 47 - 19
    assert s[hs.TAIL]["idle_us"] == 2
    assert hs.NO_SPAN not in s


def test_harness_reads_the_same_with_the_spans_in():
    events = sweep_events()
    bare = [e for e in events if not e["name"].startswith(hs.PREFIX)]
    a, b = reduce_trace(events), reduce_trace(bare)
    assert (a.window_us, a.busy_us) == (b.window_us, b.busy_us)
    assert a.ops == b.ops and a.gaps == b.gaps
    assert a.breakdown() == b.breakdown()


def test_per_unit_metrics_by_hand():
    s = hs.reduce_spans(sweep_events())
    sweeps = {"traced_sweeps": 4}
    assert hs.per_unit_ms(s, "trace_build_ms.sweep", sweeps) == 30 / 4e3
    assert hs.per_unit_ms(s, "fixed_point_ms.sweep", sweeps) == 20 / 4e3
    assert hs.per_unit_ms(s, "kv_gather_ms.serve", sweeps) is None
    assert hs.per_unit_ms(s, "fixed_point_ms.sweep",
                          {"traced_sweeps": 0}) is None
    steps = {"traced_steps": 2}
    serve = hs.reduce_spans([
        X("bench.window", 0, 100),
        X(hs.PREFIX + "serve.step", 0, 100),
        X(hs.PREFIX + "kv.gather_args", 1, 9),
        X(hs.PREFIX + "serve.model#0", 20, 30),
        X(hs.PREFIX + "kv.append_tokens", 40, 4),
        X(hs.PREFIX + "serve.model#1", 60, 30)])
    assert hs.per_unit_ms(serve, "kv_gather_ms.serve", steps) == 9 / 2e3
    assert hs.per_unit_ms(serve, "decode_dispatch_ms.serve", steps) == \
        (30 - 4 + 30) / 2e3
    assert hs.per_unit_ms(serve, "trace_build_ms.sweep", steps) is None
    assert hs.per_unit_ms({}, "decode_dispatch_ms.serve", steps) is None
    assert list(hs.in_seconds(serve))[0] == "serve.step"
    assert hs.in_seconds(serve)["serve.model"]["self_s"] == \
        pytest.approx(56e-6)


def test_spans_tool_on_small_cells():
    """`spans.py`'s reading of a small sweep and a small serve on the CPU
    (no device operations: the stretch is one idle tail)."""
    cpu = torch.device("cpu")
    sweep = spans_tool.one_seed(small_sweep_cell(), 3, 0.0, cpu)
    assert {"sweep", "engine.build", "engine.traces", "engine.simulate",
            "machine.time_batch", "engine.rows"} <= set(sweep["spans"])
    assert sweep["units"] == 1 and sweep["spans"]["sweep"]["calls"] == 1
    assert set(sweep["per_unit"]) == {"trace_build_ms.sweep",
                                      "fixed_point_ms.sweep"}
    assert all(v > 0 for v in sweep["per_unit"].values())
    serve = spans_tool.one_seed(small_serve_cell(), 3, 0.0, cpu)
    spans = serve["spans"]
    assert spans["kv.gather_args"]["calls"] == serve["units"] == 2
    assert spans["serve.model"]["calls"] == 2 * 3
    assert "serve.prefill" not in spans
    assert set(serve["per_unit"]) == {"kv_gather_ms.serve",
                                      "decode_dispatch_ms.serve"}
    assert all(v > 0 for v in serve["per_unit"].values())
    assert serve["span_gaps"] == [] and serve["no_span_idle"] == 0.0
