"""Torch-graph walking: the dynamic half of the analyzer.

The twin of the JAX package's ``repro/analysis/jaxpr_audit.py``.  A torch
program has no jaxpr, so the file is named for what it walks, an FX graph
of aten operations, and findings carry ``path="<graph:NAME>"`` where the
JAX package writes ``<jaxpr:NAME>``.

:func:`trace_entry` runs a callable once on tiny concrete inputs under
``make_fx`` (real tensors) and records every aten operation it dispatches
into a ``torch.fx.GraphModule``.  Python loops unroll, so there are no
sub-graphs to recurse into.  By default the callable is wrapped in
``torch.func.functionalize(..., remove="mutations_and_views")``: in-place
writes (``add_``, ``index_put_``) become operations whose results later
reads consume, so a write into a tensor that feeds the outputs is a data
edge the backward slice follows.  :func:`audit_graph` walks the graph for
two contract breaks:

* **forbidden operations** (:data:`FORBIDDEN_PRIMITIVES`): aten's RNG ops
  (torch's hidden global generator, which no twin can replay) and
  ``aten._local_scalar_dense`` — a device value read to the host and
  brought back as a constant (``.item()``, ``int(t)``), torch's form of
  a host callback — have no place in a parity-critical entry point,
  whatever their dtype;
* **float leakage**: the stat pipelines are integer-only by design (int32
  counters, integer hotness keys), so *any* float-dtype value on the
  backward slice from the outputs is a promotion waiting to break bitwise
  device/host parity.
"""
from __future__ import annotations

import operator
from typing import Any, Dict, Iterator, List, Set, Tuple

import torch

from repro_torch.analysis.findings import ERROR, Finding

# aten's sampling operations, by base name.
_RNG_OPS = ("rand", "randn", "randint", "randperm", "rand_like", "randn_like",
            "randint_like", "normal", "bernoulli", "multinomial", "uniform",
            "exponential", "poisson", "random", "geometric", "cauchy",
            "log_normal")

# Operations (by aten base name: no overload, no trailing `_`) that must
# never appear in a parity-critical entry point.
FORBIDDEN_PRIMITIVES: Dict[str, str] = {
    **{op: ("RNG draws from a generator's hidden state, which no host "
            "twin replays bitwise") for op in _RNG_OPS},
    "_local_scalar_dense": (
        "a device value read to the host and traced back in as a "
        "constant is a hidden host callback"
    ),
}

# Integer-only pipelines may still contain these float-dtype operations:
# none.  (The allowlist exists so a future, reviewed exception is a
# one-line diff here instead of a weaker rule.)
FLOAT_ALLOWLIST: Set[str] = set()

# Entry points whose graphs may read device values to the host, each with
# its reason.  The CUDA kernels' wrappers check their inputs and plan the
# launch on the host before the ctypes call; the values go to a `raise` or
# to the launch's shape, never into a counter, and the kernels' results
# are held bitwise by RA404.  What these two graphs can still catch is the
# wrapper's own torch code around the launch: an RNG operation, a float
# buffer or conversion on the way to the outputs (RA401 walks the live
# slice, which reaches the buffers the kernel writes), and a wrapper that
# no longer traces.  The kernel's body is invisible to them.
HOST_READ_ALLOWLIST: Dict[str, str] = {
    "run_batch_segment[cuda]": (
        "the MESI kernel's wrapper checks that every core id lies in "
        "[0, cores)"),
    "run_dynamic[cuda]": (
        "the epoch kernel's wrapper checks core ids and periods and reads "
        "whether a migrating epoch boundary falls inside the segment"),
}


def op_name(node: Any) -> str:
    """The aten base name of a ``call_function`` node's target:
    ``aten.index_put_.default`` -> ``index_put``; other callables (such
    as ``operator.getitem``) by their ``__name__``."""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    name = packet.__name__ if packet is not None else getattr(
        target, "__name__", str(target))
    return name.rstrip("_")


def iter_nodes(graph_module: Any) -> Iterator[Any]:
    """Yield every ``call_function`` node of the traced graph."""
    graph = getattr(graph_module, "graph", graph_module)
    for node in graph.nodes:
        if node.op == "call_function":
            yield node


def iter_live_nodes(graph_module: Any) -> Iterator[Any]:
    """Yield ``call_function`` nodes on the backward slice from the output.

    ``make_fx`` records every operation the Python executed, including
    ones whose results never reach the return value (dead code).  The
    float-purity check only cares about values that *feed the outputs*,
    so it walks this slice; the forbidden-operation check deliberately
    walks :func:`iter_nodes` instead — a host read is a contract break
    even when its result is discarded.  Only a functionalized graph makes
    in-place writes into data edges; ``eliminate_dead_code`` would keep
    every in-place node, dead or not.
    """
    graph = getattr(graph_module, "graph", graph_module)
    live: Set[Any] = set()
    todo = [n for n in graph.nodes if n.op == "output"]
    while todo:
        node = todo.pop()
        if node in live:
            continue
        live.add(node)
        todo.extend(node.all_input_nodes)
    for node in graph.nodes:
        if node.op == "call_function" and node in live:
            yield node


def trace_entry(fn, *args, functional: bool = True):
    """``make_fx`` on concrete (tiny) example inputs.

    ``functional=True`` traces ``torch.func.functionalize(fn, remove=
    "mutations_and_views")``.  A kernel wrapper that hands ``data_ptr()``
    to a ctypes launch needs ``functional=False``: a functionalized tensor
    has no storage of its own.  Host reads are recorded as
    ``aten._local_scalar_dense`` nodes rather than failing the trace.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    if functional:
        fn = torch.func.functionalize(fn, remove="mutations_and_views")
    return make_fx(fn, tracing_mode="real",
                   _error_on_data_dependent_ops=False)(*args)


def _values(val: Any) -> List[Any]:
    if isinstance(val, (tuple, list)):
        out: List[Any] = []
        for v in val:
            out.extend(_values(v))
        return out
    return [val]


def _is_float(val: Any) -> bool:
    return any(isinstance(v, torch.Tensor) and v.dtype.is_floating_point
               for v in _values(val))


def audit_graph(
    name: str,
    graph_module: Any,
    *,
    allow_floats: bool = False,
) -> List[Finding]:
    """Audit one traced entry point; returns deduplicated findings.

    Parameters
    ----------
    name : str
        Entry-point label, reported as ``<graph:NAME>``.
    graph_module
        A ``torch.fx.GraphModule`` from :func:`trace_entry`.
    allow_floats : bool
        True for entry points that legitimately compute in floats
        (timing models); False for the integer stat pipelines, where
        any float node on the live slice is flagged as RA401.
    """
    findings: List[Finding] = []
    seen: Set[Tuple[str, str]] = set()
    path = f"<graph:{name}>"
    for node in iter_nodes(graph_module):
        prim = op_name(node)
        if prim == "_local_scalar_dense" and name in HOST_READ_ALLOWLIST:
            continue
        if prim in FORBIDDEN_PRIMITIVES and ("RA402", prim) not in seen:
            seen.add(("RA402", prim))
            findings.append(
                Finding(
                    code="RA402",
                    name="forbidden-primitive",
                    severity=ERROR,
                    path=path,
                    line=0,
                    col=0,
                    message=(
                        f"primitive `{prim}` in entry point {name}: "
                        f"{FORBIDDEN_PRIMITIVES[prim]}"
                    ),
                    symbol=name,
                )
            )
    if allow_floats:
        return findings
    for node in iter_live_nodes(graph_module):
        if node.target is operator.getitem:
            continue  # a tuple output's element: its producer is flagged
        prim = op_name(node)
        if prim in FLOAT_ALLOWLIST or ("RA401", prim) in seen:
            continue
        if _is_float(node.meta.get("val")):
            seen.add(("RA401", prim))
            findings.append(
                Finding(
                    code="RA401",
                    name="float-in-int-pipeline",
                    severity=ERROR,
                    path=path,
                    line=0,
                    col=0,
                    message=(
                        f"float-dtype `{prim}` feeding the integer "
                        f"stat pipeline {name}; parity requires "
                        f"int-only arithmetic end to end"
                    ),
                    symbol=name,
                )
            )
    return findings
