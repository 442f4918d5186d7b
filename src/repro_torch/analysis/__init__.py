"""Determinism & parity-contract static analysis for the port.

The twin of the JAX package's ``repro.analysis``.  The repo's central
invariant — every device path is bitwise-equal to its host twin and to
every other execution strategy — is enforced dynamically by the tests;
this package enforces it before a sweep runs, with two cooperating
passes:

**AST lint** (:mod:`repro_torch.analysis.rules` /
:mod:`repro_torch.analysis.visitor`)
    Pure-``ast`` rules over the source tree: seedless global RNG (NumPy,
    the stdlib and torch's global generator), wall-clock reads in
    simulation paths, host syncs and data-dependent Python branches
    inside compiled or CUDA-graph-captured scopes, mutable default
    arguments, and bare ``assert`` in library code.  Findings can be
    suppressed inline (``# repro-lint: disable=CODE``) or carried in a
    committed baseline file (the JAX package's format); anything new
    fails the run.

**graph audit** (:mod:`repro_torch.analysis.graph_audit` /
:mod:`repro_torch.analysis.contracts`)
    Traces the registered entry points (``simulate_trace``,
    ``run_traces``, ``run_dynamic``, every registered workload's
    ``device_trace``, and on a CUDA device the kernel entry points) with
    ``make_fx`` into aten graphs and walks them for float-dtype values
    feeding the integer pipelines, RNG operations and host reads;
    verifies the :class:`~repro_torch.workloads.base.Workload` device/host
    twin contract; and cross-checks the ``nstats``/``stat_names`` layout
    against the engine and, on the card, the CUDA kernels by triangulating
    the backends on one tiny trace.

Run it as ``python -m repro_torch.analysis [--device cpu]`` or via
``tools/repro_torch_lint.py``.  Importing it builds no kernel.
"""
from repro_torch.analysis.cli import main  # noqa: F401
from repro_torch.analysis.contracts import run_audit  # noqa: F401
from repro_torch.analysis.findings import Finding  # noqa: F401
from repro_torch.analysis.rules import RULES  # noqa: F401
from repro_torch.analysis.visitor import lint_paths  # noqa: F401
