"""The benchmark's CPU tests: the harness and the program side by side.

Run from the repository root: ``python -m pytest -q bench/tests``.
"""
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent.parent
for p in (BENCH.parent / "src", BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
