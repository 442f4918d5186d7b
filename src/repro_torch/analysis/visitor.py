"""Module-level AST context shared by every lint rule, and the runner.

One :class:`ModuleContext` per source file precomputes everything the
rules need so each rule stays a small, independent query:

* **alias resolution** — ``import numpy as np`` / ``from torch import
  cuda`` are folded into canonical dotted names, so a rule matches
  ``numpy.random.rand`` or ``torch.cuda.graph`` however the module spelled
  it;
* **tracer scopes** — code that PyTorch captures or compiles instead of
  running op by op: functions decorated with, or passed to,
  ``torch.compile``, ``torch.func.vmap`` / ``torch.vmap`` or
  ``torch.cuda.make_graphed_callables`` (directly or through
  ``functools.partial``), and the body of a ``with torch.cuda.graph(...)``
  block.  Functions nested inside a tracer scope are tracer scopes.  (The
  JAX package's twin keys on ``jax.jit``/``vmap``/``pmap`` and the bodies
  of ``lax.scan``/``fori_loop``/``while_loop``/``cond``/``pallas_call``;
  the port has none of those.)  Inside a scope a ``.item()`` breaks the
  capture or forces a graph break, and a Python branch on a tensor's value
  is frozen at capture time;
* **tracer taint** — per tracer scope, the set of local names assigned
  from expressions that call into ``torch.*`` (or reference an
  already-tainted name): these hold device tensors, so a Python
  ``if``/``while`` on them decides once, for every later replay;
* **inline suppressions** — ``# repro-lint: disable=CODE`` comments
  (:func:`repro_torch.analysis.findings.parse_suppressions`).
"""
from __future__ import annotations

import ast
import pathlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import (
    Finding,
    apply_suppressions,
    parse_suppressions,
)

# Call targets whose function-valued arguments run captured or compiled.
TRACER_WRAPPERS = frozenset(
    {
        "torch.compile",
        "torch.vmap",
        "torch.func.vmap",
        "torch.cuda.make_graphed_callables",
    }
)

# Context managers whose ``with`` body is captured into a CUDA graph.
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph"})

# Canonical prefix of calls that produce device tensors inside a scope,
# and the calls under it that return host metadata instead.
_TRACER_SOURCE = "torch."
_HOST_TORCH_CALLS = frozenset(
    {
        "torch.Size",
        "torch.device",
        "torch.finfo",
        "torch.iinfo",
        "torch.is_tensor",
        "torch.Generator",
        "torch.cuda.is_available",
        "torch.cuda.device_count",
        "torch.cuda.current_device",
        "torch.cuda.current_stream",
        "torch.cuda.CUDAGraph",
    }
)

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


class ModuleContext:
    """Parsed source file plus the resolved facts the rules query."""

    def __init__(self, path: pathlib.Path, rel_path: str, source: str):
        self.path = path
        self.rel_path = rel_path
        self.source = source
        self.tree = ast.parse(source, filename=str(path))
        self.suppressions = parse_suppressions(source)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        self._aliases = self._collect_aliases()
        self._functions = self._collect_functions()
        self._roots = self._collect_roots()
        self._scopes = self._collect_scopes()
        self._taints: Dict[ast.AST, Set[str]] = {
            scope: _tainted_names(self, scope) for scope in self._scopes
        }

    # -- name resolution ----------------------------------------------------
    def _collect_aliases(self) -> Dict[str, str]:
        aliases: Dict[str, str] = {"np": "numpy"}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name != "*":
                        aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, or None.

        ``cuda.graph`` after ``from torch import cuda`` resolves through
        the import aliases to ``torch.cuda.graph``; non-name expressions
        (calls, subscripts) resolve to None.
        """
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self._aliases.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    # -- scopes -------------------------------------------------------------
    def _collect_functions(self) -> Dict[str, List[ast.AST]]:
        by_name: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                by_name.setdefault(node.name, []).append(node)
        return by_name

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def enclosing_symbol(self, node: ast.AST) -> str:
        names: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.append(cur.name)
            elif isinstance(cur, ast.ClassDef):
                names.append(cur.name)
            cur = self._parents.get(cur)
        return ".".join(reversed(names)) or "<module>"

    def _callable_targets(self, node: ast.AST) -> List[str]:
        """Local function names an argument expression refers to."""
        if isinstance(node, ast.Name):
            return [node.id]
        if isinstance(node, ast.Call):
            canon = self.dotted(node.func)
            if canon in ("functools.partial", "partial") and node.args:
                return self._callable_targets(node.args[0])
        return []

    def _collect_roots(self) -> Set[ast.AST]:
        roots: Set[ast.AST] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if self._mentions_wrapper(dec):
                        roots.add(node)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if (isinstance(expr, ast.Call)
                            and self.dotted(expr.func) in CAPTURE_CONTEXTS):
                        roots.add(node)
            elif isinstance(node, ast.Call):
                canon = self.dotted(node.func)
                if canon not in TRACER_WRAPPERS:
                    continue
                for arg in node.args:
                    for name in self._callable_targets(arg):
                        for fn in self._functions.get(name, []):
                            roots.add(fn)
                    if isinstance(arg, ast.Lambda):
                        roots.add(arg)
        return roots

    def _mentions_wrapper(self, dec: ast.AST) -> bool:
        for sub in ast.walk(dec):
            canon = self.dotted(sub)
            if canon in TRACER_WRAPPERS:
                return True
        return False

    def _collect_scopes(self) -> Set[ast.AST]:
        scopes: Set[ast.AST] = set(self._roots)
        for node in ast.walk(self.tree):
            if isinstance(node, _FuncNode) and node not in scopes:
                cur = self._parents.get(node)
                while cur is not None:
                    if cur in self._roots:
                        scopes.add(node)
                        break
                    cur = self._parents.get(cur)
        return scopes

    def tracer_scopes(self) -> Set[ast.AST]:
        """Every function node or capture ``with`` block whose body runs
        captured or compiled."""
        return set(self._scopes)

    def enclosing_tracer_scope(self, node: ast.AST) -> Optional[ast.AST]:
        cur: Optional[ast.AST] = node
        while cur is not None:
            if cur in self._scopes:
                return cur
            cur = self._parents.get(cur)
        return None

    def tainted(self, scope: ast.AST) -> Set[str]:
        return self._taints.get(scope, set())


def _calls_tracer_source(ctx: ModuleContext, expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            canon = ctx.dotted(sub.func)
            if (canon and canon.startswith(_TRACER_SOURCE)
                    and canon not in _HOST_TORCH_CALLS):
                return True
    return False


def _references(names: Set[str], expr: ast.AST) -> bool:
    return any(isinstance(sub, ast.Name) and sub.id in names for sub in ast.walk(expr))


def _tainted_names(ctx: ModuleContext, scope: ast.AST) -> Set[str]:
    """Names in `scope` assigned from torch results (transitively)."""
    tainted: Set[str] = set()
    body = scope.body if isinstance(scope.body, list) else [scope.body]

    def visit(stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, _FuncNode):
                continue  # nested scopes run their own pass
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = stmt.value
                if value is not None and (
                    _calls_tracer_source(ctx, value) or _references(tainted, value)
                ):
                    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                    for t in targets:
                        for sub in ast.walk(t):
                            if isinstance(sub, ast.Name):
                                tainted.add(sub.id)
            # recurse into compound statement bodies in source order
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    visit([s for s in sub if isinstance(s, ast.stmt)])
            for handler in getattr(stmt, "handlers", []):
                visit(handler.body)

    visit([s for s in body if isinstance(s, ast.stmt)])
    return tainted


def iter_source_files(paths: Sequence[pathlib.Path]) -> List[pathlib.Path]:
    """Expand files/directories into the .py files to lint."""
    out: List[pathlib.Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(f for f in sorted(p.rglob("*.py")) if "__pycache__" not in f.parts)
        elif p.suffix == ".py":
            out.append(p)
    return out


def lint_file(
    path: pathlib.Path,
    rules: Sequence,
    root: Optional[pathlib.Path] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Run every applicable rule over one file.

    Returns ``(kept, suppressed)`` — findings surviving the inline
    ``# repro-lint: disable=`` comments, and the ones those silenced.
    """
    root = root or pathlib.Path.cwd()
    try:
        rel = str(path.resolve().relative_to(root.resolve()))
    except ValueError:
        rel = str(path)
    ctx = ModuleContext(path, rel, path.read_text())
    findings: List[Finding] = []
    for rule in rules:
        if rule.applies_to(rel):
            findings.extend(rule.check(ctx))
    findings.sort(key=lambda f: (f.line, f.col, f.code))
    return apply_suppressions(findings, ctx.suppressions)


def lint_paths(
    paths: Sequence[pathlib.Path],
    rules: Optional[Sequence] = None,
    root: Optional[pathlib.Path] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Lint every source file under `paths` with `rules`.

    Parameters
    ----------
    paths : sequence of pathlib.Path
        Files or directories to scan.
    rules : sequence of Rule, optional
        Defaults to the full registry
        (:data:`repro_torch.analysis.rules.RULES`).
    root : pathlib.Path, optional
        Paths in findings are reported relative to this (default: cwd).

    Returns
    -------
    (list of Finding, list of Finding)
        ``(findings, inline_suppressed)``.
    """
    if rules is None:
        from repro_torch.analysis.rules import RULES

        rules = RULES
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in iter_source_files(list(paths)):
        k, s = lint_file(f, rules, root=root)
        kept.extend(k)
        suppressed.extend(s)
    return kept, suppressed
