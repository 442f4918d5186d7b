"""The port's four examples against the JAX package's, on the CPU.

``examples/*_torch.py`` make the calls of their JAX twins through
``repro_torch``.  Quickstart and characterize print the same lines as
``examples/quickstart.py`` and ``characterize_cxl.py`` when both run at
one reduced cache geometry (``CacheParams`` patched to ``SMALL`` on each
side, each script's own calls left alone: at their own geometries the
plain MESI version takes minutes on the CPU).  The serve example prints
the JAX example's ``tier stats:`` and ``kv:`` lines, which depend only on
the request shapes (tokens follow the weights, which differ).  The JAX
side runs in one subprocess, started when the first comparison asks for
it, while the port's side runs here.
"""
import ast
import math
import os
import pathlib
import re
import runpy
import subprocess
import sys
import time

import pytest

import repro_torch.core.cache as tcache

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "characterize_cxl", "serve_kv_cxl", "train_e2e")
SMALL = dict(l1_bytes=2048, l1_ways=2, l2_bytes=8192, l2_ways=4)

# Runs the JAX examples at SMALL, each one's output to <dir>/<name>.out as
# it finishes.  The serve example gets the jnp oracle for the Pallas
# paged-attention kernel (whose body JAX 0.9 cannot run) and jit around
# its model calls (unjitted they take ~1 s a decode step on the CPU).
_JAX_DRIVER = """
import contextlib, io, pathlib, runpy, sys
out, root = pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2])
small = eval(sys.argv[3])
import jax
import repro.core.cache as cache_mod
from repro.kernels import ops, ref
from repro.models import transformer as tf
real = cache_mod.CacheParams
cache_mod.CacheParams = lambda **kw: real(**{**kw, **small})
ops.paged_attention = ref.paged_attention
tf.forward_prefill = jax.jit(tf.forward_prefill, static_argnums=(1,))
tf.decode_step = jax.jit(tf.decode_step, static_argnums=(1,))
for name in ("quickstart", "characterize_cxl", "serve_kv_cxl"):
    buf = io.StringIO()
    sys.argv = [name]
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(root / "examples" / f"{name}.py"),
                       run_name="__main__")
    (out / f"{name}.tmp").write_text(buf.getvalue())
    (out / f"{name}.tmp").rename(out / f"{name}.out")
"""


class _JaxExamples:
    """The JAX examples' printed lines, from the subprocess."""

    def __init__(self, out: pathlib.Path):
        self.out = out
        self.log = (out / "stderr.txt").open("w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_DRIVER, str(out), str(ROOT),
             repr(SMALL)], stdout=subprocess.DEVNULL, stderr=self.log,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                 "JAX_PLATFORMS": "cpu",
                 **{k: os.environ[k] for k in ("HOME", "TMPDIR")
                    if k in os.environ}})

    def lines(self, name: str, timeout: float = 600.0):
        path = self.out / f"{name}.out"
        deadline = time.monotonic() + timeout
        while not path.exists():
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(
                    f"the JAX example {name} printed nothing:\n"
                    f"{(self.out / 'stderr.txt').read_text()[-4000:]}")
            time.sleep(0.05)
        return path.read_text().splitlines()

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()


@pytest.fixture(scope="module")
def jax_examples(tmp_path_factory):
    ref = _JaxExamples(tmp_path_factory.mktemp("jax_examples"))
    yield ref
    ref.close()


def run_port_example(monkeypatch, capsys, name, *argv):
    """Run ``examples/<name>_torch.py`` as a script with `argv`; return
    its printed lines."""
    path = ROOT / "examples" / f"{name}_torch.py"
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    capsys.readouterr()
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out.splitlines()


@pytest.fixture
def small_cache(monkeypatch):
    real = tcache.CacheParams
    monkeypatch.setattr(tcache, "CacheParams",
                        lambda **kw: real(**{**kw, **SMALL}))


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_examples_import_only_the_port(name):
    tree = ast.parse((ROOT / "examples" / f"{name}_torch.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


@pytest.mark.parametrize("name", ["quickstart", "characterize_cxl"])
def test_port_example_prints_the_jax_example_lines(
        name, jax_examples, small_cache, monkeypatch, capsys):
    got = run_port_example(monkeypatch, capsys, name, "--device", "cpu")
    want = jax_examples.lines(name)
    assert len(got) > 20
    assert got == want


def test_serve_example_prints_the_jax_tier_and_kv_lines(
        jax_examples, monkeypatch, capsys):
    got = run_port_example(monkeypatch, capsys, "serve_kv_cxl",
                           "--device", "cpu")
    want = jax_examples.lines("serve_kv_cxl")

    def pick(lines, prefix):
        return [ln for ln in lines if ln.startswith(prefix)]

    for prefix in ("arch=", "tier stats:", "kv:"):
        assert pick(got, prefix) == pick(want, prefix), prefix
        assert len(pick(got, prefix)) == 1
    assert "requests=6 prefill=48 decode=12" in pick(got, "arch=")[0]
    assert "tok/s on CPU" in "\n".join(got)


def test_train_example_restarts_once_with_finite_losses(
        monkeypatch, capsys, tmp_path):
    got = run_port_example(
        monkeypatch, capsys, "train_e2e", "--device", "cpu", "--steps", "4",
        "--fail-at", "2", "--ckpt-every", "2", "--layers", "2",
        "--d-model", "64", "--d-ff", "128", "--vocab", "256", "--log-every",
        "1", "--ckpt-dir", str(tmp_path / "ckpt"))
    text = "\n".join(got)
    assert "arch=granite-3-8b" in text and "(cpu)" in text
    summary = re.search(r"loss (\S+) -> (\S+) over (\d+) steps .*"
                        r"\(restarts=(\d+)\)", text)
    assert summary, text
    assert summary.group(4) == "1"
    losses = [float(x) for x in re.findall(r"loss=(\S+)", text)]
    assert len(losses) == int(summary.group(3)) >= 4
    assert all(math.isfinite(x) for x in losses)
    assert (tmp_path / "ckpt").is_dir()


def test_port_examples_default_to_the_card(monkeypatch, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    for name in EXAMPLES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_port_example(monkeypatch, capsys, name)
