#!/usr/bin/env python3
"""Repo entry point for the port's determinism & parity-contract analyzer.

Thin wrapper so the tool runs without installing the package:

    python tools/repro_torch_lint.py --baseline tools/repro_torch_lint_baseline.json
    python tools/repro_torch_lint.py --device cpu --baseline tools/repro_torch_lint_baseline.json

is equivalent to ``PYTHONPATH=src python -m repro_torch.analysis ...``.
The audit runs on the CUDA card unless ``--device`` names another
device; ``--no-audit`` lints only.  The rules are those of
``tools/repro_lint.py`` in torch's idiom (``docs/analysis.md`` has the
catalog; :mod:`repro_torch.analysis.rules` says what each became).
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
