"""What the benchmark loads: no JAX, no JAX package, and references that
stand apart from the program."""
import ast
import json
import pathlib
import subprocess
import sys
import textwrap

from harness.core import BENCH, FORBIDDEN, ROOT


def imported_roots(path: pathlib.Path):
    """Top-level names of every module `path` imports."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def bench_sources():
    return [p for p in BENCH.rglob("*.py") if ".cache" not in p.parts]


def test_no_file_imports_jax_or_the_jax_package():
    for p in bench_sources():
        assert not imported_roots(p) & set(FORBIDDEN), p


def test_references_import_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in imported_roots(p), p
        assert imported_roots(p) <= {"__future__", "dataclasses", "math",
                                     "typing", "numpy", "torch",
                                     "reference"}, p


def test_nothing_reads_the_jax_benchmarks():
    for p in bench_sources():
        if p.name == pathlib.Path(__file__).name:
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, p
        assert "benchmarks" not in imported_roots(p), p


def test_a_run_loads_no_jax_module():
    """A whole CPU run of a small sweep cell, in a fresh interpreter."""
    code = textwrap.dedent(f"""
        import sys, json
        sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r},
                        {str(ROOT / 'src')!r}]
        import torch
        import run
        from bench_cells import small_sweep_cell
        from harness.core import forbidden_modules
        cell = small_sweep_cell()
        cell.traffic["footprint_x_l2"] = [1]
        line, err, rc = run.run_cell(cell, 5, 0.0, True, torch.device("cpu"))
        print(json.dumps([rc, json.loads(line)["correct"],
                          forbidden_modules()]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    rc, correct, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert (rc, correct, bad) == (0, True, [])


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """No card: exit 2, no result line.  A directory holding only the
    benchmark's files: exit 2 as well."""
    import shutil
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "table1-cxl.static-grid", "--seed",
                          "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "",
                                        "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "table1-cxl.static-grid", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
