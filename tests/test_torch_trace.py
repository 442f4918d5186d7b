"""The port's spans (``repro_torch.runtime.trace``) on the CPU.

* With the profiler off a span opens no ``record_function``.
* Under ``torch.profiler.profile`` a small static sweep (K1's plain
  version), a small tiering sweep (K3's) and ``serve.run`` on the smoke
  config each emit their stages' spans, nested as the stages call each
  other, ``machine.time_batch`` once per call of the engine and the
  per-request spans once per request and step; with the graphed serve
  below, the runs together emit exactly :data:`SPANS`.
* The sweep rows (bitwise), the served tokens, K4's outputs and
  ``KVStats`` are the same with the profiler on and off, also when the
  profiler starts and stops inside decode steps.
* ``serve.capture`` opens once per sequence, inside its second decode
  step, where the serve runs its steps through
  :class:`~repro_torch.models.transformer.StepGraph`.  A CUDA graph needs
  the card (``tests/test_torch_card.py`` captures real ones); here a
  stand-in graph makes the serve take that path on the CPU: its capture
  runs the step once on the static inputs (which changes nothing: the
  step rewrites the slot it wrote with the same values) and its replay
  runs the step again into the captured logits.  That serve gives the
  eager serve's outputs bitwise.
"""
import collections
import contextlib
import dataclasses
import json
import types

import pytest
import torch

from repro_torch import workloads as tworkloads
from repro_torch.configs import get_smoke
from repro_torch.core import engine as tengine
from repro_torch.core import numa as tnuma
from repro_torch.core.cache import CacheParams
from repro_torch.core.machine import CPUModel
from repro_torch.core.simulator import CXLRAMSim, SimConfig
from repro_torch.core.tiering_dyn import DynamicTiering
from repro_torch.core.timing import LatencyDistribution
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.runtime import trace

SMALL = CacheParams(l1_bytes=1024, l1_ways=2, l2_bytes=4096, l2_ways=4)
SERVE = dict(requests=2, prefill=8, decode=3, page_size=4, hbm_pages=3)
CPUS = (CPUModel(kind="inorder", mlp=1), CPUModel(kind="o3", mlp=8))


def _static():
    sim = CXLRAMSim(SimConfig(cache=SMALL), device="cpu")
    sim.online()
    return sim.sweep((1, 2), policies=(tnuma.ZNuma(0.0), tnuma.ZNuma(1.0),
                                       tnuma.WeightedInterleave(1, 1)),
                     cpus=CPUS,
                     distributions=(None,
                                    LatencyDistribution(n_samples=16)))


def _tiering():
    sim = CXLRAMSim(SimConfig(cache=SMALL), device="cpu")
    sim.online()
    return sim.sweep((1,), cpus=CPUS[1:],
                     workloads=(tworkloads.HotCold(hot_page_frac=0.25),
                                tworkloads.Gups()),
                     tiering=(None, DynamicTiering(64, 2, 1),
                              DynamicTiering(128, 1, 1)))


def _serve():
    out = tserve.run(get_smoke("h2o-danube-3-4b"), device="cpu", **SERVE)
    return {"tokens": out["tokens"], "kv_stats": out["kv_stats"],
            "attn_out": out["attn_out"], "decode_graph": out["decode_graph"]}


@contextlib.contextmanager
def cpu_graphs():
    """The serve's graph path on the CPU, with a stand-in for the CUDA
    graph (the module docstring says what it does)."""
    graphable, capture = ttf.graphable, ttf.StepGraph.capture

    def stand_in(self):
        self.logits = self._run()
        self.graph = types.SimpleNamespace(
            replay=lambda: self.logits.copy_(self._run()))

    ttf.graphable = lambda cfg, device: graphable(cfg, "cuda")
    ttf.StepGraph.capture = stand_in
    try:
        yield
    finally:
        ttf.graphable, ttf.StepGraph.capture = graphable, capture


def _serve_graphed():
    with cpu_graphs():
        return _serve()


def held_moe_smoke():
    """deepseek's smoke config with DeepSeek-V3's gate (sigmoid scores, a
    score bias, the best 2 of 4 groups) over 8 experts, of which each MoE
    layer holds 4, from expert 2."""
    cfg = get_smoke("deepseek-v3-671b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, scoring="sigmoid", n_group=4, topk_group=2,
        routed_scale=2.5, score_bias=True, held=(2, 4)))


def _serve_moe():
    out = tserve.run(held_moe_smoke(), device="cpu", **SERVE)
    return {"tokens": out["tokens"], "kv_stats": out["kv_stats"],
            "attn_out": out["attn_out"]}


def _serve_hybrid():
    """mimo-v2-flash-309b's smoke config: a full layer, then window layers
    (window 8, two 4-token pages a ring) with sinks, over held-share MoE
    FFNs; the pool holds both kinds."""
    cfg = get_smoke("mimo-v2-flash-309b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           held=(2, 4)))
    out = tserve.run(cfg, device="cpu", **SERVE)
    return {"tokens": out["tokens"], "kv_stats": out["kv_stats"],
            "attn_out": out["kind_attn_out"], "kv_kinds": out["kv_kinds"]}


def _serve_kda():
    """kimi-linear-48b-a3b's smoke config: KDA layers 0, 1 and 3 beside an
    MLA layer, over held-share MoE FFNs; the pool holds the latent
    pages."""
    cfg = get_smoke("kimi-linear-48b-a3b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           held=(2, 4)))
    out = tserve.run(cfg, device="cpu", **SERVE)
    return {"tokens": out["tokens"], "kv_stats": out["kv_stats"],
            "attn_out": out["attn_out"], "kv_kinds": out["kv_kinds"]}


RUNS = {"static": _static, "tiering": _tiering, "serve": _serve,
        "serve_graphed": _serve_graphed, "serve_moe": _serve_moe,
        "serve_hybrid": _serve_hybrid, "serve_kda": _serve_kda}
STAGES = {
    "static": {"sweep", "engine.build", "engine.traces", "engine.simulate",
               "machine.time_batch", "engine.rows"},
    "serve": {"serve.prefill", "serve.step", "kv.gather_args",
              "serve.pool_cast", "serve.model", "serve.sample",
              "kv.append_tokens"},
}
STAGES["tiering"] = STAGES["static"]
STAGES["serve_graphed"] = STAGES["serve"] | {"serve.capture"}
STAGES["serve_moe"] = STAGES["serve"] | {"moe.route", "moe.experts"}
STAGES["serve_hybrid"] = STAGES["serve_moe"] | {"serve.window_pool"}
STAGES["serve_kda"] = STAGES["serve_moe"] | {"kda.scan", "kda.step"}


def _spans(events):
    """(name, id or None, parent name or None) of every ``repro_torch.``
    span, the parent being the innermost span around it on its thread."""
    xs = sorted((float(e["ts"]), -float(e["dur"]), e["tid"], e["name"])
                for e in events if e.get("ph") == "X"
                and e.get("cat") == "user_annotation"
                and e["name"].startswith(trace.PREFIX))
    out, open_ = [], collections.defaultdict(list)
    for ts, neg, tid, full in xs:
        stack = open_[tid]
        while stack and stack[-1][0] <= ts:
            stack.pop()
        name, _, sid = full[len(trace.PREFIX):].partition("#")
        out.append((name, int(sid) if sid else None,
                    stack[-1][1] if stack else None))
        stack.append((ts - neg, name))
    return out


def _profiled(fn, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        result = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return result, _spans(json.loads(path.read_text())["traceEvents"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each run twice, profiler off then on; with the engine's calls of
    ``time_batch`` counted in the profiled one."""
    out = {}
    for kind, fn in RUNS.items():
        calls = [0]
        saved = tengine.time_batch

        def counted(*args, **kwargs):
            calls[0] += 1
            return saved(*args, **kwargs)

        off = fn()
        tengine.time_batch = counted
        try:
            on, spans = _profiled(fn, tmp_path_factory.mktemp(kind))
        finally:
            tengine.time_batch = saved
        out[kind] = {"off": off, "on": on, "spans": spans,
                     "time_batch_calls": calls[0]}
    return out


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return json.dumps(a) == json.dumps(b)


def test_span_off_opens_no_record_function(monkeypatch):
    assert not torch.autograd._profiler_enabled()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for name in trace.SPANS:
        with trace.span(name, 3) as handle:
            assert handle is None
    assert trace.span("sweep") is trace.span("serve.model", 0)
    out = tserve.run(get_smoke("h2o-danube-3-4b"), device="cpu",
                     requests=1, prefill=4, decode=1, page_size=4,
                     hbm_pages=1)
    assert len(out["tokens"][0]) == 1


def test_span_names_carry_the_prefix_and_the_request(tmp_path):
    def fn():
        with trace.span("serve.model", 7):
            with trace.span("serve.sample", 7):
                pass
        with trace.span("sweep"):
            pass

    _, spans = _profiled(fn, tmp_path)
    assert spans == [("serve.model", 7, None),
                     ("serve.sample", 7, "serve.model"),
                     ("sweep", None, None)]


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_spans_nest_as_the_stages_call_each_other(runs, kind):
    spans = runs[kind]["spans"]
    assert {n for n, _, _ in spans} == STAGES[kind]
    parents = collections.defaultdict(set)
    count = collections.Counter()
    for name, sid, parent in spans:
        parents[name].add(parent)
        count[name, sid] += 1
    if kind.startswith("serve"):
        n, d = SERVE["requests"], SERVE["decode"]
        # the hybrid pool's two kinds: the window kind's in its own span
        kinds = 2 if kind == "serve_hybrid" else 1
        assert parents["serve.prefill"] == {None}
        assert parents["serve.step"] == {None}
        assert count["serve.step", None] == d
        for name in ("serve.model", "serve.sample"):
            assert parents[name] == {"serve.step"}, name
        for name in ("kv.gather_args", "serve.pool_cast"):
            assert parents[name] == ({"serve.step", "serve.window_pool"}
                                     if kinds == 2 else {"serve.step"}), name
            assert count[name, None] == kinds * d
        if kinds == 2:
            assert parents["serve.window_pool"] == {"serve.step"}
            assert count["serve.window_pool", None] == d
        for sid in range(n):
            assert count["serve.prefill", sid] == 1
            assert count["serve.model", sid] == d
            assert count["serve.sample", sid] == d
        # the prefill's layer-0 stash, then one row per sequence and step
        assert parents["kv.append_tokens"] == {"serve.prefill",
                                               "serve.step"}
        assert count["kv.append_tokens", None] == kinds * (n + n * d)
        if kind == "serve_graphed":
            # captured in each sequence's second step, before its model
            assert parents["serve.capture"] == {"serve.step"}
            for sid in range(n):
                assert count["serve.capture", sid] == 1
        if kind in ("serve_moe", "serve_hybrid", "serve_kda"):
            # each of the 2 (hybrid, kda: 3) MoE layers in every prefill
            # and decode_step
            layers = 2 if kind == "serve_moe" else 3
            for name in ("moe.route", "moe.experts"):
                assert parents[name] == {"serve.prefill", "serve.model"}
                assert count[name, None] == layers * (n + n * d)
        if kind == "serve_kda":
            # the 3 KDA layers' chunk loops in every prefill (one chunk of
            # 8), their steps in every decode_step
            assert parents["kda.scan"] == {"serve.prefill"}
            assert count["kda.scan", None] == 3 * n
            assert parents["kda.step"] == {"serve.model"}
            assert count["kda.step", None] == 3 * n * d
        return
    assert parents["sweep"] == {None} and count["sweep", None] == 1
    assert parents["engine.traces"] == {"engine.build"}
    for name in ("engine.build", "engine.simulate", "machine.time_batch",
                 "engine.rows"):
        assert parents[name] == {"sweep"}, name
    assert count["engine.build", None] == 1
    assert count["engine.simulate", None] == 1
    assert count["engine.rows", None] == 1
    assert count["machine.time_batch", None] == \
        runs[kind]["time_batch_calls"] >= 2


def test_the_three_runs_emit_exactly_SPANS(runs):
    emitted = {n for r in runs.values() for n, _, _ in r["spans"]}
    assert emitted == set(trace.SPANS)
    assert len(trace.SPANS) == len(set(trace.SPANS))


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_outputs_equal_with_the_profiler_on_and_off(runs, kind):
    off, on = runs[kind]["off"], runs[kind]["on"]
    if kind.startswith("serve"):
        assert on["tokens"] == off["tokens"]
        assert on["kv_stats"] == off["kv_stats"]
        assert _same(on["attn_out"], off["attn_out"])
        assert on.get("moe") == off.get("moe")
    else:
        assert json.dumps(on) == json.dumps(off)
        assert len(on) == {"static": 24, "tiering": 6}[kind]


def test_graphed_serve_gives_the_eager_serve_s_outputs(runs):
    """The serve through StepGraphs (the stand-in graph) against the
    eager serve: tokens, KVStats and K4's outputs bitwise; per batch one
    capture and one eager step per sequence, the rest replayed."""
    eager, graphed = runs["serve"]["off"], runs["serve_graphed"]["off"]
    n, d = SERVE["requests"], SERVE["decode"]
    assert eager["decode_graph"] == {"captured": 0, "replayed": 0,
                                     "eager": n * d}
    assert graphed["decode_graph"] == {"captured": n,
                                       "replayed": n * (d - 1), "eager": n}
    assert graphed["tokens"] == eager["tokens"]
    assert graphed["kv_stats"] == eager["kv_stats"]
    assert _same(graphed["attn_out"], eager["attn_out"])


def test_graphed_decode_steps_return_fresh_logits():
    """Each `decode_step` call through a StepGraph returns its own tensor,
    equal to the eager call's (a caller keeping every step's logits does
    not keep one buffer many times over)."""
    cfg = get_smoke("h2o-danube-3-4b")
    kept = {"eager": [], "graphed": []}
    saved = ttf.decode_step

    def record(into):
        def step(*args, **kwargs):
            logits, caches = saved(*args, **kwargs)
            into.append(logits)
            return logits, caches
        return step

    try:
        ttf.decode_step = record(kept["eager"])
        tserve.run(cfg, device="cpu", **SERVE)
        ttf.decode_step = record(kept["graphed"])
        with cpu_graphs():
            tserve.run(cfg, device="cpu", **SERVE)
    finally:
        ttf.decode_step = saved
    got, want = kept["graphed"], kept["eager"]
    assert len(got) == len(want) == SERVE["requests"] * SERVE["decode"]
    assert len({x.data_ptr() for x in got}) == len(got)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_profiler_started_and_stopped_inside_decode_steps(tmp_path):
    """The profiler on from the second step's K4 launch to the third's,
    as a harness tracing a few decode steps runs it: the spans opened
    before it started are missing, the one open when it stopped ends
    there, and the serve's outputs do not change."""
    cfg = get_smoke("h2o-danube-3-4b")
    want = tserve.run(cfg, device="cpu", **SERVE)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    saved = tops.paged_attention
    n = [0]

    def k4(*args):
        if n[0] == 1:
            prof.start()
        if n[0] == 2:
            prof.stop()
        n[0] += 1
        return saved(*args)

    tops.paged_attention = k4
    try:
        got = tserve.run(cfg, device="cpu", **SERVE)
    finally:
        tops.paged_attention = saved
    assert not torch.autograd._profiler_enabled()
    assert got["tokens"] == want["tokens"]
    assert got["kv_stats"] == want["kv_stats"]
    assert _same(got["attn_out"], want["attn_out"])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = _spans(json.loads(path.read_text())["traceEvents"])
    count = collections.Counter((n_, s) for n_, s, _ in spans)
    r = SERVE["requests"]
    assert count == collections.Counter(
        {("serve.step", None): 1, ("kv.gather_args", None): 1,
         ("serve.pool_cast", None): 1, ("kv.append_tokens", None): r,
         **{("serve.model", s): 1 for s in range(r)},
         **{("serve.sample", s): 1 for s in range(r)}})
    # the second step's own spans have no recorded parent
    assert {p for n_, _, p in spans if n_ == "serve.model"} == {None}

