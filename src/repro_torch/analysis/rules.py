"""The lint rule catalog: determinism and parity-contract AST checks.

Every rule has a stable code (the suppression/baseline token), a slug, a
severity, and a ``check(ctx)`` generator over one
:class:`~repro_torch.analysis.visitor.ModuleContext`.  The codes, slugs and
severities are the JAX package's (``repro.analysis.rules``, catalog in
``docs/analysis.md``), so one baseline format and one suppression comment
serve both packages.  Each rule's docstring says what it was there and
what it is here.

========  ====================  ============================================
code      name                  flags
========  ====================  ============================================
RL101     seedless-rng          global-state / seedless RNG calls (NumPy,
                                stdlib and torch's global generator)
RL102     wall-clock            wall-clock reads in simulation paths
RL201     host-sync-in-jit      ``.item()``/``.tolist()``/``.cpu()``/
                                ``float()``/``np.asarray`` on values inside
                                compiled or CUDA-graph-captured scopes
RL202     tracer-branch         Python ``if``/``while`` on tensor-tainted
                                names inside those scopes
RL301     mutable-default-arg   mutable default argument values
RL302     bare-assert           ``assert`` in library (non-test) code
========  ====================  ============================================
"""
from __future__ import annotations

import abc
import ast
from typing import Iterator, Optional, Tuple

from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.analysis.visitor import ModuleContext

# numpy.random module-level functions that mutate hidden global state.
_NP_GLOBAL_RNG = frozenset(
    {
        "rand",
        "randn",
        "randint",
        "random",
        "random_sample",
        "ranf",
        "sample",
        "choice",
        "shuffle",
        "permutation",
        "bytes",
        "seed",
        "normal",
        "uniform",
        "standard_normal",
        "exponential",
        "poisson",
        "binomial",
        "integers",
    }
)

# stdlib `random` module-level twins (the hidden global Random()).
_STDLIB_GLOBAL_RNG = frozenset(
    {
        "random",
        "randint",
        "randrange",
        "choice",
        "choices",
        "shuffle",
        "sample",
        "uniform",
        "gauss",
        "normalvariate",
        "getrandbits",
        "randbytes",
        "seed",
    }
)

# torch samplers that draw from the hidden global generator unless they
# are given `generator=`.
_TORCH_SAMPLERS = frozenset(
    {
        "torch.rand",
        "torch.randn",
        "torch.randint",
        "torch.randperm",
        "torch.rand_like",
        "torch.randn_like",
        "torch.randint_like",
        "torch.normal",
        "torch.bernoulli",
        "torch.multinomial",
        "torch.poisson",
    }
)

# Calls that reseed (or read entropy into) torch's global generators.
_TORCH_GLOBAL_SEEDS = frozenset(
    {
        "torch.manual_seed",
        "torch.seed",
        "torch.random.manual_seed",
        "torch.random.seed",
        "torch.cuda.manual_seed",
        "torch.cuda.manual_seed_all",
        "torch.cuda.seed",
        "torch.cuda.seed_all",
    }
)

# In-place tensor samplers (``x.uniform_()``, ``torch.nn.init.normal_``).
_TORCH_INPLACE_SAMPLERS = frozenset(
    {
        "uniform_",
        "normal_",
        "bernoulli_",
        "random_",
        "exponential_",
        "geometric_",
        "cauchy_",
        "log_normal_",
    }
)

_WALL_CLOCK_CALLS = frozenset({"time.time", "time.time_ns", "time.localtime", "time.ctime"})
_ARGLESS_NOW = ("now", "today", "utcnow")

_HOST_SYNC_BUILTINS = frozenset({"float", "int", "bool", "complex"})
_HOST_SYNC_NUMPY = frozenset({"numpy.asarray", "numpy.array"})
_HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_STATIC_ATTRS = frozenset({"shape", "ndim", "size", "dtype", "numel"})


def _has_generator(node: ast.Call) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


class Rule(abc.ABC):
    """Base rule: code/name/severity plus an optional path scope."""

    code: str = "RL000"
    name: str = "rule"
    severity: str = ERROR
    description: str = ""
    # When set, the rule only runs on files whose relative path contains
    # one of these directory components.
    scope_dirs: Optional[Tuple[str, ...]] = None

    def applies_to(self, rel_path: str) -> bool:
        if self.scope_dirs is None:
            return True
        parts = rel_path.replace("\\", "/").split("/")
        return any(d in parts for d in self.scope_dirs)

    @abc.abstractmethod
    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        """Yield this rule's findings in one module."""

    def finding(self, ctx: ModuleContext, node: ast.AST, message: str) -> Finding:
        return Finding(
            code=self.code,
            name=self.name,
            severity=self.severity,
            path=ctx.rel_path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
            symbol=ctx.enclosing_symbol(node),
        )


class SeedlessRng(Rule):
    """Global-state RNG breaks the explicit-seed workload contract.

    In the JAX package the rule flags NumPy's and the stdlib's global
    generators and seedless ``default_rng()`` / ``Random()``; JAX's own
    RNG takes explicit keys and needs no rule.  Here it keeps those checks
    word for word and adds torch's hidden global generator: a sampler
    (``torch.rand``, ``randn``, ``randint``, ``randperm``, the ``*_like``
    forms, ``normal``, ``bernoulli``, ``multinomial``, ``poisson``) or an
    in-place sampler (``x.uniform_()``, ``normal_``, ``bernoulli_``,
    ``random_``, ``exponential_``, ``geometric_``, ``cauchy_``,
    ``log_normal_``) called without ``generator=``, and any reseeding of
    the global generators (``torch.manual_seed``, ``torch.seed``,
    ``torch.cuda.manual_seed[_all]``).
    """

    code = "RL101"
    name = "seedless-rng"
    severity = ERROR
    description = (
        "np.random.* / random.* / torch global-state RNG, or a Generator "
        "constructed without an explicit seed"
    )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr in _TORCH_INPLACE_SAMPLERS
                and not _has_generator(node)
            ):
                yield self.finding(
                    ctx,
                    node,
                    f"in-place sampler {func.attr}() draws from torch's "
                    f"global generator; pass generator=torch.Generator()"
                    f".manual_seed(seed)",
                )
                continue
            canon = ctx.dotted(func)
            if canon is None:
                continue
            if canon.startswith("numpy.random."):
                leaf = canon.rsplit(".", 1)[1]
                if leaf in _NP_GLOBAL_RNG:
                    yield self.finding(
                        ctx,
                        node,
                        f"global-state RNG np.random.{leaf}(); use an "
                        f"explicit-seed np.random.default_rng(seed)",
                    )
                elif leaf in ("default_rng", "Generator") and not (node.args or node.keywords):
                    yield self.finding(
                        ctx,
                        node,
                        f"np.random.{leaf}() without a seed draws OS "
                        f"entropy; pass an explicit seed",
                    )
            elif canon.startswith("random."):
                leaf = canon.rsplit(".", 1)[1]
                if leaf in _STDLIB_GLOBAL_RNG:
                    yield self.finding(
                        ctx,
                        node,
                        f"stdlib global RNG random.{leaf}(); use a seeded "
                        f"random.Random(seed) instance",
                    )
                elif leaf == "Random" and not (node.args or node.keywords):
                    yield self.finding(
                        ctx,
                        node,
                        "random.Random() without a seed; pass one explicitly",
                    )
            elif canon in _TORCH_SAMPLERS and not _has_generator(node):
                yield self.finding(
                    ctx,
                    node,
                    f"{canon}() without generator= draws from torch's "
                    f"global generator; pass generator=torch.Generator()"
                    f".manual_seed(seed)",
                )
            elif canon in _TORCH_GLOBAL_SEEDS:
                yield self.finding(
                    ctx,
                    node,
                    f"{canon}() reseeds torch's global generator, hidden "
                    f"state every later draw depends on; seed a "
                    f"torch.Generator and pass it instead",
                )


class WallClock(Rule):
    """Wall-clock reads make simulation paths non-reproducible.

    The same rule as in the JAX package, over the same directories.
    """

    code = "RL102"
    name = "wall-clock"
    severity = ERROR
    description = "time.time() / argless datetime.now() in core/ or workloads/ simulation paths"
    scope_dirs = ("core", "workloads", "kernels", "memory", "serving")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            canon = ctx.dotted(node.func)
            if canon is None:
                continue
            if canon in _WALL_CLOCK_CALLS:
                yield self.finding(
                    ctx,
                    node,
                    f"wall-clock read {canon}() in a simulation path; "
                    f"results must be a pure function of the inputs",
                )
            elif (
                canon.endswith(_ARGLESS_NOW)
                and "datetime" in canon
                and not (node.args or node.keywords)
            ):
                yield self.finding(
                    ctx,
                    node,
                    f"argless {canon}() reads the wall clock; pass the "
                    f"timestamp in from the caller",
                )


class HostSyncInJit(Rule):
    """Host syncs inside captured or compiled scopes.

    In the JAX package the rule flags ``.item()``, ``float``/``int``/
    ``bool``/``complex`` and ``np.asarray``/``np.array`` on traced values
    inside ``jax.jit``/``vmap``/``pmap`` and ``lax.scan``-style bodies.
    Here the scopes are the port's (functions under ``torch.compile``,
    ``torch.func.vmap``/``torch.vmap`` or
    ``torch.cuda.make_graphed_callables``, and ``with torch.cuda.graph``
    bodies), and the syncs are torch's: ``.item()``, ``.tolist()``,
    ``.cpu()`` and ``.numpy()``, the same builtins and the same NumPy
    calls.  Under CUDA graph capture such a read fails; under
    ``torch.compile`` it breaks the graph.  Static metadata (``.shape``,
    ``.ndim``, ``.dtype``, ``.size()``, ``.numel()``, ``len``) is fine.
    """

    code = "RL201"
    name = "host-sync-in-jit"
    severity = ERROR
    description = (
        ".item()/.tolist()/.cpu()/float()/np.asarray() on values inside "
        "compiled or CUDA-graph-captured scopes"
    )

    def _is_static_arg(self, node: ast.Call) -> bool:
        # int(x.shape[0]), int(x.numel()) and friends concretize static
        # metadata, not device values — those are fine under capture.
        if len(node.args) != 1:
            return len(node.args) > 1  # int(x, base) etc: not a sync
        arg = node.args[0]
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
                return True
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                if sub.func.id == "len":
                    return True
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.tracer_scopes():
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if ctx.enclosing_tracer_scope(node) is None:
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in _HOST_SYNC_METHODS:
                yield self.finding(
                    ctx,
                    node,
                    f".{func.attr}() inside a captured or compiled scope "
                    f"copies a device value to the host; keep it on the "
                    f"device or hoist the sync out",
                )
                continue
            canon = ctx.dotted(func)
            if canon in _HOST_SYNC_NUMPY:
                yield self.finding(
                    ctx,
                    node,
                    f"{canon.replace('numpy', 'np')}() inside a captured or "
                    f"compiled scope materializes on the host; use "
                    f"torch.as_tensor or hoist it out",
                )
            elif (
                isinstance(func, ast.Name)
                and func.id in _HOST_SYNC_BUILTINS
                and node.args
                and not self._is_static_arg(node)
            ):
                yield self.finding(
                    ctx,
                    node,
                    f"{func.id}() on a device value reads it to the host; "
                    f"use tensor casts (or hoist the host conversion out "
                    f"of the captured scope)",
                )


class TracerBranch(Rule):
    """Python control flow on device values inside captured scopes.

    In the JAX package a Python ``if``/``while`` on a tracer fails at
    trace time.  Here a branch on a tensor-tainted name inside a
    ``torch.compile``/``vmap`` function or a ``with torch.cuda.graph``
    body reads the value once: CUDA graph capture freezes the branch taken
    for every replay, ``vmap`` refuses it, and ``torch.compile``
    specializes or breaks the graph.  ``x is None``, ``isinstance`` and
    shape tests stay static.
    """

    code = "RL202"
    name = "tracer-branch"
    severity = ERROR
    description = (
        "data-dependent Python if/while on tensor-tainted names inside "
        "compiled or CUDA-graph-captured scopes"
    )

    def _dynamic_names(self, ctx: ModuleContext, test: ast.AST):
        # Names reached only through .shape/.ndim/.dtype/.size are
        # static metadata; `x is None` and `isinstance(x, ...)` tests
        # are staticness/type-dispatch checks, not value branches.
        if isinstance(test, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        ):
            return set()
        static_roots = set()
        for sub in ast.walk(test):
            if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
                for inner in ast.walk(sub.value):
                    if isinstance(inner, ast.Name):
                        static_roots.add(id(inner))
            elif (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id in ("isinstance", "len", "callable")
            ):
                for inner in ast.walk(sub):
                    if isinstance(inner, ast.Name):
                        static_roots.add(id(inner))
        return {
            sub.id
            for sub in ast.walk(test)
            if isinstance(sub, ast.Name) and id(sub) not in static_roots
        }

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.tracer_scopes():
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            scope = ctx.enclosing_tracer_scope(node)
            if scope is None:
                continue
            hot = self._dynamic_names(ctx, node.test) & ctx.tainted(scope)
            if hot:
                kind = "if" if isinstance(node, ast.If) else "while"
                names = ", ".join(sorted(hot))
                yield self.finding(
                    ctx,
                    node,
                    f"Python `{kind}` on device value(s) {names} inside a "
                    f"captured or compiled scope decides once for every "
                    f"replay; use torch.where",
                )


class MutableDefaultArg(Rule):
    """Mutable defaults are shared across calls — hidden global state.

    The same rule as in the JAX package.
    """

    code = "RL301"
    name = "mutable-default-arg"
    severity = WARNING
    description = "list/dict/set default argument values"

    def _is_mutable(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set)):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            return node.func.id in ("list", "dict", "set", "bytearray")
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]
            for d in defaults:
                if self._is_mutable(d):
                    yield self.finding(
                        ctx,
                        d,
                        f"mutable default argument in {node.name}(); "
                        f"default to None and construct inside",
                    )


class BareAssert(Rule):
    """Bare asserts vanish under ``python -O`` — use typed errors.

    The same rule as in the JAX package.
    """

    code = "RL302"
    name = "bare-assert"
    severity = WARNING
    description = "assert statements in library (non-test) code"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assert):
                yield self.finding(
                    ctx,
                    node,
                    "bare assert in library code is stripped under "
                    "python -O; raise ValueError (or a typed error) "
                    "instead",
                )


RULES = (
    SeedlessRng(),
    WallClock(),
    HostSyncInJit(),
    TracerBranch(),
    MutableDefaultArg(),
    BareAssert(),
)
