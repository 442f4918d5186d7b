"""The port's analyzer (``repro_torch.analysis``) against the JAX package's.

Mirrors ``tests/test_analysis.py`` case by case: per-rule snippets (the
rules that carry over unchanged give the JAX lint's exact findings, and
the torch forms of RL101/RL201/RL202 have their own positive and negative
snippets under every new scope kind), both linters over both source
trees, suppressions, the baseline (read across packages) and the CLI, the
graph audit's detection cases in torch, the twin and stat-layout
contracts, and the clean runs.  The registered entry points are traced
once, on the CPU, in a module-scoped fixture.
"""
import functools
import json
import pathlib
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import findings as jfindings
from repro.analysis.visitor import lint_paths as jax_lint_paths
from repro_torch.analysis import contracts, graph_audit
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.findings import (
    Finding,
    load_baseline,
    parse_suppressions,
    save_baseline,
    split_new,
)
from repro_torch.analysis.visitor import lint_paths

ROOT = pathlib.Path(__file__).resolve().parent.parent
UNCHANGED_RULES = {"RL101", "RL102", "RL301", "RL302"}


@pytest.fixture(scope="module")
def graphs():
    return contracts.trace_entry_points("cpu")


def lint_snippet(tmp_path, code, name="snippet.py"):
    f = tmp_path / name
    f.write_text(textwrap.dedent(code))
    kept, suppressed = lint_paths([f], root=tmp_path)
    return kept, suppressed


def codes(findings):
    return [f.code for f in findings]


def rows(findings):
    return [(f.code, f.line, f.col, f.symbol, f.message) for f in findings]


def both_linters(paths, root):
    """(port kept, port suppressed), (JAX kept, JAX suppressed)."""
    return lint_paths(paths, root=root), jax_lint_paths(paths, root=root)


# ---------------------------------------------------------------------------
# AST lint rules: the unchanged rules' snippets, through both linters
# ---------------------------------------------------------------------------
UNCHANGED_SNIPPETS = {
    "rl101_positive": ("""
        import numpy as np
        import random

        x = np.random.rand(4)
        g = np.random.default_rng()
        r = random.random()
        u = random.Random()
        """, ["RL101"] * 4),
    "rl101_seeded_negative": ("""
        import numpy as np
        import random

        g = np.random.default_rng(17)
        y = g.integers(0, 10, 4)
        r = random.Random(3).random()
        """, []),
    "rl101_aliases": ("""
        import numpy.random as npr

        z = npr.randint(0, 4)
        """, ["RL101"]),
    "rl301": ("""
        def f(xs=[], d={}, s=None):
            return xs, d, s

        def g(xs=None, d=()):
            return xs, d
        """, ["RL301", "RL301"]),
    "rl302": ("""
        def f(n):
            assert n > 0, "n must be positive"
            return n
        """, ["RL302"]),
    "rl302_negative": ("""
        def f(n):
            if n <= 0:
                raise ValueError("n must be positive")
            return n
        """, []),
}


@pytest.mark.parametrize("case", sorted(UNCHANGED_SNIPPETS))
def test_unchanged_rules_match_the_jax_lint(tmp_path, case):
    code, want = UNCHANGED_SNIPPETS[case]
    f = tmp_path / "snippet.py"
    f.write_text(textwrap.dedent(code))
    (kept, _), (jkept, _) = both_linters([f], tmp_path)
    assert codes(kept) == want
    assert rows(kept) == rows(jkept)


def test_rl102_wall_clock_scoped_to_sim_paths(tmp_path):
    code = """
    import time
    import datetime

    t0 = time.time()
    d = datetime.datetime.now()
    """
    for d, want in (("core", ["RL102", "RL102"]), ("launch", [])):
        (tmp_path / d).mkdir()
        (tmp_path / d / "mod.py").write_text(textwrap.dedent(code))
        (kept, _), (jkept, _) = both_linters([tmp_path / d / "mod.py"],
                                             tmp_path)
        assert codes(kept) == want  # wall clock is fine outside sim paths
        assert rows(kept) == rows(jkept)


def test_rl102_tz_aware_now_negative(tmp_path):
    core = tmp_path / "core"
    core.mkdir()
    (core / "mod.py").write_text(
        "import datetime\n"
        "d = datetime.datetime.now(datetime.timezone.utc)\n"
    )
    (kept, _), (jkept, _) = both_linters([core / "mod.py"], tmp_path)
    assert kept == [] and jkept == []


# ---------------------------------------------------------------------------
# RL101 in torch's idiom: the global generator
# ---------------------------------------------------------------------------
def test_rl101_torch_global_rng_positive(tmp_path):
    kept, _ = lint_snippet(
        tmp_path,
        """
        import torch
        from torch import randint

        a = torch.rand(4)
        b = torch.randn(2, 2)
        c = randint(0, 4, (3,))
        d = torch.randperm(5)
        e = torch.randn_like(a)
        f = torch.normal(a, 1.0)
        g = torch.bernoulli(a)
        h = torch.multinomial(a, 2)
        a.uniform_()
        b.normal_(0.0, 1.0)
        torch.nn.init.uniform_(a)
        torch.manual_seed(0)
        torch.cuda.manual_seed_all(0)
        torch.seed()
        """,
    )
    assert codes(kept) == ["RL101"] * 14
    assert "global generator" in kept[0].message
    assert "reseeds" in kept[-1].message


def test_rl101_torch_explicit_generator_negative(tmp_path):
    kept, _ = lint_snippet(
        tmp_path,
        """
        import torch

        gen = torch.Generator().manual_seed(0)
        a = torch.rand(4, generator=gen)
        b = torch.randint(0, 4, (3,), generator=gen)
        a.uniform_(generator=gen)
        torch.nn.init.normal_(a, 0.0, 1.0, generator=gen)
        c = torch.zeros(3)
        """,
    )
    assert kept == []


# ---------------------------------------------------------------------------
# RL201 / RL202 under each of the port's tracer scopes
# ---------------------------------------------------------------------------
SCOPES = {
    "compile_decorator": "@torch.compile\ndef f(x):\n{body}",
    "compile_call_decorator": "@torch.compile(fullgraph=True)\n"
                              "def f(x):\n{body}",
    "compile_call": "def f(x):\n{body}\ng = torch.compile(f)",
    "func_vmap": "def f(x):\n{body}\ng = torch.func.vmap(f)",
    "vmap_partial": "def f(x, k):\n{body}\n"
                    "g = torch.vmap(functools.partial(f, k=2))",
    "graphed_callables": "def f(x):\n{body}\n"
                         "g = torch.cuda.make_graphed_callables(f, (x0,))",
    "cuda_graph_with": "def run(x, g):\n"
                       "    with torch.cuda.graph(g):\n{body_in_with}",
}
HOST_SYNC_BODY = """\
    y = torch.sum(x)
    a = y.item()
    b = float(y)
    c = np.asarray(y)
    d = y.tolist()
    e = y.cpu()
    n = int(x.shape[0]) + int(x.numel()) + len(x)
    return a + b + c.sum() + n
"""
BRANCH_BODY = """\
    s = torch.sum(x)
    k = torch.cuda.device_count()
    if s > 0:
        x = x + 1
    while s < 3:
        s = s + 1
    if k > 1:
        x = x * k
    if s is None:
        x = x * 2
    if x.shape[0] > 2:
        x = x * 3
    if isinstance(s, bool):
        return x
    return x + s
"""


def scoped(scope, body):
    head = "import functools\nimport numpy as np\nimport torch\n\n"
    inner = textwrap.indent(body, "    ")
    return head + SCOPES[scope].format(body=body, body_in_with=inner)


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_rl201_host_sync_in_each_scope(tmp_path, scope):
    kept, _ = lint_snippet(tmp_path, scoped(scope, HOST_SYNC_BODY))
    assert codes(kept) == ["RL201"] * 5
    assert ".item()" in kept[0].message and "float()" in kept[1].message


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_rl202_tensor_branch_in_each_scope(tmp_path, scope):
    kept, _ = lint_snippet(tmp_path, scoped(scope, BRANCH_BODY))
    assert codes(kept) == ["RL202", "RL202"]
    assert "torch.where" in kept[0].message


def test_rl201_rl202_negative_outside_scopes(tmp_path):
    kept, _ = lint_snippet(
        tmp_path,
        "import numpy as np\nimport torch\n\n"
        "def host(x):\n" + HOST_SYNC_BODY + "\n"
        "def loop(x):\n" + BRANCH_BODY + "\n"
        "with torch.no_grad():\n"
        "    y = torch.sum(torch.ones(3))\n"
        "    if y > 0:\n"
        "        z = y.item()\n",
    )
    assert kept == []


def test_jax_scopes_are_not_port_scopes(tmp_path):
    """The JAX lint's RL201 snippets are no tracer scope here, and the
    port's torch scopes are none for the JAX lint."""
    jax_code = """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def f(x):
            y = jnp.sum(x)
            if y > 0:
                return y.item()
            return float(y)
        """
    kept, _ = lint_snippet(tmp_path, jax_code)
    assert kept == []
    f = tmp_path / "torch_scope.py"
    f.write_text(scoped("compile_decorator", HOST_SYNC_BODY))
    jkept, _ = jax_lint_paths([f], root=tmp_path)
    assert jkept == []


# ---------------------------------------------------------------------------
# Both linters on both trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_both_linters_agree_on_both_trees(tree):
    (kept, sup), (jkept, jsup) = both_linters([ROOT / "src" / tree], ROOT)

    def unchanged(fs):
        return sorted((f.path,) + r for f, r in zip(fs, rows(fs))
                      if f.code in UNCHANGED_RULES)

    assert unchanged(kept) == unchanged(jkept)
    assert unchanged(sup) == unchanged(jsup)


# ---------------------------------------------------------------------------
# Escape hatches: inline suppressions + the committed baseline
# ---------------------------------------------------------------------------
def test_inline_suppression_same_and_previous_line(tmp_path):
    kept, suppressed = lint_snippet(
        tmp_path,
        """
        def f(n):
            assert n > 0  # repro-lint: disable=RL302
            # repro-lint: disable=RL302
            assert n < 10
            assert n != 5
        """,
    )
    assert codes(kept) == ["RL302"]  # only the unsuppressed one
    assert codes(suppressed) == ["RL302", "RL302"]


def test_suppression_is_code_specific(tmp_path):
    kept, suppressed = lint_snippet(
        tmp_path,
        """
        import torch

        def f(n):
            assert n > 0  # repro-lint: disable=RL101
            return torch.rand(3)  # repro-lint: disable=RL101
        """,
    )
    assert codes(kept) == ["RL302"]  # wrong code: not silenced
    assert codes(suppressed) == ["RL101"]


def test_parse_suppressions_multiple_codes():
    sup = parse_suppressions("x = 1  # repro-lint: disable=RL101, RL302\n")
    assert sup[1] == frozenset({"RL101", "RL302"})


def _finding(message="m", path="p.py", symbol="f"):
    return Finding(
        code="RL302",
        name="bare-assert",
        severity="warning",
        path=path,
        line=3,
        col=4,
        message=message,
        symbol=symbol,
    )


def test_baseline_roundtrip_and_multiset_semantics(tmp_path):
    f = _finding()
    path = tmp_path / "baseline.json"
    save_baseline(path, [f])
    baseline = load_baseline(path)
    assert baseline == [f.baseline_key]

    # one baseline entry absorbs exactly one identical finding
    new, matched = split_new([f, f], baseline)
    assert len(matched) == 1 and len(new) == 1

    # line numbers are not part of the identity
    moved = Finding(**{**f.to_dict(), "line": 99})
    new, matched = split_new([moved], baseline)
    assert new == [] and matched == [moved]


def test_baseline_interchanges_with_the_jax_package(tmp_path):
    f = _finding()
    jf = jfindings.Finding(**f.to_dict())
    jfindings.save_baseline(tmp_path / "jax.json", [jf])
    save_baseline(tmp_path / "port.json", [f])
    assert (tmp_path / "jax.json").read_text() == \
        (tmp_path / "port.json").read_text()
    assert load_baseline(tmp_path / "jax.json") == [f.baseline_key]
    assert jfindings.load_baseline(tmp_path / "port.json") == \
        [jf.baseline_key]
    # the JAX package's committed baseline reads here too
    assert load_baseline(ROOT / "tools" / "repro_lint_baseline.json") == \
        jfindings.load_baseline(ROOT / "tools" / "repro_lint_baseline.json")


def test_missing_baseline_is_empty(tmp_path):
    assert load_baseline(tmp_path / "nope.json") == []


# ---------------------------------------------------------------------------
# CLI: exit codes, formats, injected violation, the audit's device
# ---------------------------------------------------------------------------
def test_cli_fails_on_injected_violation(tmp_path, capsys):
    bad = tmp_path / "core"
    bad.mkdir()
    (bad / "sim.py").write_text(
        "import torch\nx = torch.rand(3)\n"
    )
    rc = cli_main([str(bad), "--no-audit", "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "RL101" in out
    assert out.strip().splitlines()[-1] == (
        "repro-lint: files=1 RL101=1 total=1 new=1 baselined=0 "
        "suppressed=0 audit=skipped")


def test_cli_baseline_makes_known_findings_pass(tmp_path, capsys):
    bad = tmp_path / "mod.py"
    bad.write_text("def f(n):\n    assert n\n")
    baseline = tmp_path / "baseline.json"
    rc = cli_main(
        [str(bad), "--no-audit", "--write-baseline", str(baseline)]
    )
    assert rc == 0 and baseline.exists()
    capsys.readouterr()

    rc = cli_main([str(bad), "--no-audit", "--baseline", str(baseline)])
    assert rc == 0  # baselined finding does not fail

    # a *second* occurrence of the same pattern is still new
    bad.write_text("def f(n):\n    assert n\n    assert n\n")
    rc = cli_main([str(bad), "--no-audit", "--baseline", str(baseline)])
    assert rc == 1


def test_cli_json_format(tmp_path, capsys):
    bad = tmp_path / "mod.py"
    bad.write_text("def f(n):\n    assert n\n")
    rc = cli_main([str(bad), "--no-audit", "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload["exit"] == 1
    assert payload["counts"] == {"RL302": 1}
    assert payload["findings"][0]["code"] == "RL302"
    assert payload["audit"] == "skipped"


def test_cli_audits_on_the_cpu(monkeypatch, capsys, graphs):
    monkeypatch.setattr(contracts, "run_audit",
                        functools.partial(contracts.run_audit, graphs=graphs))
    rc = cli_main([str(ROOT / "src" / "repro_torch"), "--root", str(ROOT),
                   "--device", "cpu", "--baseline",
                   str(ROOT / "tools" / "repro_torch_lint_baseline.json")])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    assert last.startswith("repro-lint: files=") and last.endswith(
        "total=0 new=0 baselined=0 suppressed=0 audit=ok")


def test_cli_audit_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    (tmp_path / "mod.py").write_text("x = 1\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main([str(tmp_path / "mod.py")])
    assert cli_main([str(tmp_path / "mod.py"), "--no-audit"]) == 0


# ---------------------------------------------------------------------------
# graph audit
# ---------------------------------------------------------------------------
def _ints():
    return torch.arange(4, dtype=torch.int32)


def test_audit_detects_float_in_int_pipeline():
    def leaky(x):
        return (x.to(torch.float32) * 1.5).to(torch.int32)

    graph = graph_audit.trace_entry(leaky, _ints())
    findings = graph_audit.audit_graph("leaky", graph)
    assert "RA401" in codes(findings)
    assert findings[0].path == "<graph:leaky>"


def test_audit_ignores_dead_float_code():
    def payload(x):
        _unused = x.to(torch.float32) * 2.0  # never feeds the output
        return x + 1

    graph = graph_audit.trace_entry(payload, _ints())
    assert graph_audit.audit_graph("payload", graph) == []


def test_audit_ignores_dead_in_place_float_writes():
    """KVDecode's shape: zero K/V written into a float pool in place,
    which no output reads."""
    def payload(x):
        pool = torch.zeros(8, 4)
        pool[x.long()] = torch.zeros(4, 4)
        pool.add_(1.0)
        return x * 2

    graph = graph_audit.trace_entry(payload, _ints())
    assert graph_audit.audit_graph("payload", graph) == []


def test_audit_catches_in_place_float_write_to_a_live_tensor():
    def leaky(x):
        out = torch.zeros(4, dtype=torch.int32)
        acc = torch.zeros(4)
        acc.add_(x.to(torch.float32) * 0.5)   # in place, read below
        out.add_(acc.to(torch.int32))
        return out + x

    graph = graph_audit.trace_entry(leaky, _ints())
    findings = graph_audit.audit_graph("leaky", graph)
    assert "RA401" in codes(findings)
    assert any("`add`" in f.message for f in findings)


def test_audit_allow_floats_gates_ra401():
    def timing(x):
        return x.to(torch.float32) / 3.0

    graph = graph_audit.trace_entry(timing, _ints())
    assert graph_audit.audit_graph("t", graph, allow_floats=True) == []
    assert set(codes(graph_audit.audit_graph("t", graph))) == {"RA401"}


@pytest.mark.parametrize("op", ["rand", "uniform_", "randint", "item"])
def test_audit_flags_forbidden_operations(op):
    def noisy(x):
        if op == "rand":
            noise = (torch.rand(4) * 4).to(torch.int32)
        elif op == "uniform_":
            noise = torch.empty(4).uniform_().to(torch.int32)
        elif op == "randint":
            noise = torch.randint(0, 4, (4,), dtype=torch.int32)
        else:
            noise = x * int((x + 1).max().item())
        return x + noise

    graph = graph_audit.trace_entry(noisy, _ints())
    findings = graph_audit.audit_graph("noisy", graph)
    assert "RA402" in codes(findings)
    want = {"rand": "rand", "uniform_": "uniform", "randint": "randint",
            "item": "_local_scalar_dense"}[op]
    assert any(f"`{want}`" in f.message for f in findings
               if f.code == "RA402")


def test_audit_host_read_allowlist_is_by_entry_and_keeps_rng():
    def wrapper(x):
        if int(x.min()) < 0:            # a launch's argument check
            raise ValueError("negative")
        return x + (torch.rand(4) * 0).to(torch.int32)

    graph = graph_audit.trace_entry(wrapper, _ints(), functional=False)
    name = "run_dynamic[cuda]"
    assert name in graph_audit.HOST_READ_ALLOWLIST
    allowed = graph_audit.audit_graph(name, graph)
    assert [f.message for f in allowed if "_local_scalar_dense" in
            f.message] == []
    assert "RA402" in codes(allowed)    # rand
    assert any("_local_scalar_dense" in f.message
               for f in graph_audit.audit_graph("run_dynamic", graph))


def test_audit_walks_unrolled_loops():
    def run(xs):
        c = torch.zeros((), dtype=torch.int32)
        for i in range(xs.shape[0]):
            c = c + (xs[i].to(torch.float32) * 2.0).to(torch.int32)
        return c

    graph = graph_audit.trace_entry(run, _ints())
    assert "RA401" in codes(graph_audit.audit_graph("run", graph))


# ---------------------------------------------------------------------------
# Contracts: workload twins + stat layout
# ---------------------------------------------------------------------------
def test_workload_twin_contract_holds():
    assert contracts.check_workload_twins("cpu") == []


def test_twin_contract_detects_divergence(monkeypatch):
    from repro_torch import workloads
    from repro_torch.workloads.base import WorkloadTrace

    class Broken:
        def device_trace(self, footprint_bytes, device=None):
            return WorkloadTrace(
                addr=np.arange(8, dtype=np.int32),
                is_write=np.zeros(8, np.int32),
                n_pages=1,
            )

        def host_trace(self, footprint_bytes):
            return WorkloadTrace(
                addr=np.arange(1, 9, dtype=np.int32),  # shifted: diverges
                is_write=np.zeros(8, np.int32),
                n_pages=1,
            )

    monkeypatch.setattr(workloads, "REGISTRY", {"broken": Broken})
    monkeypatch.setattr(workloads, "get", lambda name, **kw: Broken())
    findings = contracts.check_workload_twins("cpu")
    assert codes(findings) == ["RA403"]
    assert "broken" in findings[0].message


def test_twin_contract_detects_missing_host_twin(monkeypatch):
    from repro_torch import workloads

    class NoTwin:
        def device_trace(self, footprint_bytes, device=None):  # pragma: no cover
            raise NotImplementedError

    monkeypatch.setattr(workloads, "REGISTRY", {"notwin": NoTwin})
    monkeypatch.setattr(workloads, "get", lambda name, **kw: NoTwin())
    findings = contracts.check_workload_twins("cpu")
    assert codes(findings) == ["RA403"]
    assert "host_trace" in findings[0].message


def test_stat_layout_gate_holds():
    assert contracts.check_stat_layout("cpu") == []


@pytest.mark.parametrize("t", contracts.LAYOUT_TARGETS)
def test_tiny_trace_stats_equal_the_jax_package(t):
    from repro.core import cache as jcache
    from repro_torch.core import cache as tcache

    addr, is_write, core, tier = contracts._tiny_trace("cpu", n_targets=t)
    p = contracts._tiny_params(t)
    _, got = tcache.simulate_trace(p, tcache.init_state(p), addr, is_write,
                                   core, tier)
    jp = jcache.CacheParams(l1_bytes=2048, l1_ways=2, l2_bytes=8192,
                            l2_ways=4, cores=2, n_targets=t)
    _, want = jcache.simulate_trace(
        jp, jcache.init_state(jp),
        *(jnp.asarray(x.numpy()) for x in (addr, is_write, core, tier)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert tcache.stat_names(t) == jcache.stat_names(t)


@pytest.mark.parametrize("t", contracts.LAYOUT_TARGETS)
def test_triangulation_trace_moves_every_counter(t):
    """RA404's triangulation trace leaves no counter at 0, static and
    dynamic, two-tier and three-tier, so a block written at the wrong
    offset shows; its static stats equal the JAX package's bitwise."""
    from repro.core import cache as jcache
    from repro_torch.core import cache as tcache
    from repro_torch.core import tiering_dyn

    p = contracts._tiny_params(t)
    trace = contracts._triangulation_trace("cpu", t)
    _, got = tcache.simulate_trace(p, tcache.init_state(p), *trace)
    assert (got > 0).all(), dict(zip(tcache.stat_names(t), got.tolist()))
    jp = jcache.CacheParams(l1_bytes=2048, l1_ways=2, l2_bytes=8192,
                            l2_ways=4, cores=2, n_targets=t)
    _, want = jcache.simulate_trace(
        jp, jcache.init_state(jp), *(jnp.asarray(x.numpy()) for x in trace))
    assert np.array_equal(got.numpy(), np.asarray(want))
    dyn = tuple(x[None] for x in
                contracts._triangulation_trace("cpu", t, dyn=True))
    maps = []
    for ssd in (False, True):
        out = tiering_dyn.run_dynamic(
            p, *dyn, slot_len=4, k_max=1, backend="reference",
            **contracts._triangulation_dyn_scalars(t, ssd))
        assert (out.stats > 0).all(), (ssd, out.stats.tolist())
        maps.append(out.page_map[0].tolist())
    assert maps[0] != maps[1] and 2 in maps[1]  # pages reached the SSD


def _misplaced(stats, t, block):
    """`stats` as a kernel would write them whose C copy of the layout put
    the mem-write block (or the coherence block) one slot too far."""
    from repro_torch.core import cache as tcache

    base = (tcache.mem_write_base(t) if block == "mem_write"
            else tcache.coherence_base(t))
    out = stats.clone()
    out[..., base] = 0
    out[..., base + 1:] = 0
    out[..., base + 1:] += stats[..., base:-1]
    return out


@pytest.mark.parametrize("block", ["mem_write", "coherence"])
def test_stat_layout_detects_a_misplaced_block(monkeypatch, block):
    """A backend that writes the mem-write or coherence block at another
    base fails RA404 at every T: the triangulation trace moves every
    counter of both blocks."""
    from repro_torch.core import engine

    real = engine.run_traces

    def drifted(p, *args, **kwargs):
        stats, state = real(p, *args, **kwargs)
        return _misplaced(stats, p.n_targets, block), state

    monkeypatch.setattr(engine, "run_traces", drifted)
    findings = contracts.check_stat_layout("cpu")
    assert codes(findings) == ["RA404"] * len(contracts.LAYOUT_TARGETS)
    assert all("run_traces[reference] disagrees" in f.message
               for f in findings)


def test_stat_layout_detects_a_second_source_of_truth(monkeypatch):
    from repro_torch.kernels import cache_sim

    monkeypatch.setattr(cache_sim, "nstats", lambda t=2: 8 + 2 * t)
    findings = contracts.check_stat_layout("cpu")
    assert codes(findings) == ["RA404"]
    assert "second source of truth" in findings[0].message
    monkeypatch.delattr(cache_sim, "nstats")
    assert "does not import nstats" in \
        contracts.check_stat_layout("cpu")[0].message


def test_stat_layout_detects_a_drifted_backend(monkeypatch):
    from repro_torch.core import engine

    real = engine.run_traces

    def drifted(*args, **kwargs):
        stats, state = real(*args, **kwargs)
        return stats.flip(-1), state    # counters in another order

    monkeypatch.setattr(engine, "run_traces", drifted)
    findings = contracts.check_stat_layout("cpu")
    assert set(codes(findings)) == {"RA404"}
    assert len(findings) == len(contracts.LAYOUT_TARGETS)
    assert all("run_traces[reference] disagrees" in f.message
               for f in findings)


def test_registry_names_on_the_cpu():
    names = [n for n, _, _ in contracts.entry_points("cpu")]
    assert names == [
        "simulate_trace", "run_traces[reference]", "run_dynamic",
        "run_dynamic[sampling]", "run_dynamic[ssd]",
        "gups.device_trace", "hot_cold.device_trace",
        "kv_decode.device_trace", "moe_stream.device_trace",
        "pointer_chase.device_trace", "stream.device_trace"]
    # the kernel entry points are the card's alone
    assert not [n for n in names if "[cuda]" in n]


def test_registered_entry_points_trace_clean(graphs):
    for name, _, allow_floats in contracts.entry_points("cpu"):
        graph = graphs[name]
        assert not isinstance(graph, Exception), f"{name}: {graph!r}"
        findings = graph_audit.audit_graph(
            name, graph, allow_floats=allow_floats
        )
        assert findings == [], f"{name}: {[f.message for f in findings]}"


def test_kv_decode_graph_does_not_depend_on_what_ran_first(graphs):
    """The serving run behind KVDecode is cached per (workload,
    footprint); the audit traces it afresh, so its graph holds the
    serving stack (and its dead float writes) whether or not a host
    trace filled the cache first."""
    from repro_torch import workloads

    wl = workloads.get("kv_decode")
    wl.host_trace(contracts.TWIN_FOOTPRINT_BYTES)
    again = contracts._trace_workload(wl, torch.device("cpu"))
    first = graphs["kv_decode.device_trace"]
    assert len(again.graph.nodes) == len(first.graph.nodes)
    floats = [n for n in graph_audit.iter_nodes(again)
              if graph_audit._is_float(n.meta.get("val"))]
    assert floats                       # the pool's writes are in it
    assert not [n for n in graph_audit.iter_live_nodes(again)
                if n in floats]
    assert graph_audit.audit_graph("kv_decode.device_trace", again) == []


# ---------------------------------------------------------------------------
# Self-scan gate: src/repro_torch stays clean modulo the committed baseline
# ---------------------------------------------------------------------------
def test_self_scan_is_clean_modulo_baseline():
    baseline = load_baseline(ROOT / "tools" / "repro_torch_lint_baseline.json")
    assert len(baseline) <= 10, "baseline budget exceeded (max 10 entries)"
    kept, _ = lint_paths([ROOT / "src" / "repro_torch"], root=ROOT)
    new, _ = split_new(kept, baseline)
    assert new == [], "\n".join(f.format() for f in new)


def test_full_audit_is_clean(graphs):
    findings = contracts.run_audit("cpu", graphs=graphs)
    assert findings == [], "\n".join(f.format() for f in findings)
