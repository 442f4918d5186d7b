#!/usr/bin/env python3
"""Record what the JAX package's quickstart and characterize examples print.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/examples_golden.py

Runs ``examples/quickstart.py`` and ``examples/characterize_cxl.py`` (the
reference, at their own cache geometries; about 40 s on a CPU) and writes
their standard output to ``examples/expected_output/<name>.txt``.
``chip_smoke.py`` holds the port's ``examples/*_torch.py`` to these lines
when it runs them on the card.
"""
import contextlib
import io
import pathlib
import runpy
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "examples" / "expected_output"
NAMES = ("quickstart", "characterize_cxl")


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    for name in NAMES:
        buf = io.StringIO()
        sys.argv = [name]
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                           run_name="__main__")
        (OUT / f"{name}.txt").write_text(buf.getvalue())
        print(f"{name}: {len(buf.getvalue().splitlines())} lines")
    return 0


if __name__ == "__main__":
    sys.exit(main())
