"""The port stands alone: no JAX, no `repro`, the card by default, and
every architecture of ``configs/`` builds."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.core import distribute as tdistribute
from repro_torch.core import engine as tengine
from repro_torch.core import simulator as tsim
from repro_torch.core.cache import CacheParams, init_batch_carry
from repro_torch.core.tiering_dyn import DynamicTiering
from repro_torch.core.timing import TimingConfig
from repro_torch.kernels import cache_sim as tkernels
from repro_torch import workloads as tworkloads
from repro_torch.configs import ARCHS, get_smoke
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.memory.kvcache import PagedKVCache
from repro_torch.models import transformer as ttf

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, runpy, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_import_probe")
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(repr(names))
print(bad)
"""

# the training slice's modules, among those the probe imports
TRAINING_MODULES = {
    "repro_torch.tree", "repro_torch.optim.adamw",
    "repro_torch.optim.compress", "repro_torch.data.pipeline",
    "repro_torch.models.moe", "repro_torch.models.model",
    "repro_torch.runtime.fault", "repro_torch.runtime.elastic",
    "repro_torch.launch.train"}
# the recurrent block kinds' modules
RECURRENT_MODULES = {"repro_torch.models.rwkv", "repro_torch.models.rglru"}
# the codec, the oracle-form plain versions, the dry run and its roofline
DRYRUN_MODULES = {"repro_torch.core.packet", "repro_torch.kernels.ref",
                  "repro_torch.launch.dryrun", "repro_torch.roofline",
                  "repro_torch.roofline.analysis",
                  "repro_torch.roofline.report"}
# the analyzer: the lint, the torch-graph audit and the contracts
ANALYSIS_MODULES = {"repro_torch.analysis", "repro_torch.analysis.cli",
                    "repro_torch.analysis.contracts",
                    "repro_torch.analysis.findings",
                    "repro_torch.analysis.graph_audit",
                    "repro_torch.analysis.rules",
                    "repro_torch.analysis.visitor"}


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, check=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"})
    names, bad = out.stdout.splitlines()
    names = set(ast.literal_eval(names))
    assert len(names) >= 81
    assert TRAINING_MODULES <= names
    assert RECURRENT_MODULES <= names
    assert DRYRUN_MODULES <= names
    assert ANALYSIS_MODULES <= names
    assert bad.strip() == "[]"
    # chip_smoke.py imports the port inside main(): read its imports too
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
    imported += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)]
    assert "repro_torch.core.simulator" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.CXLRAMSim()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.run_sweep(tengine.SweepSpec(), CacheParams(), TimingConfig())
    # the dynamic path too: no fallback to the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.run_sweep(tengine.SweepSpec(tiering=(DynamicTiering(),)),
                          CacheParams(), TimingConfig())
    # nor for the sharded, streamed and resilient sweeps, the mesh's
    # default devices, or the pollution probe
    for kw in (dict(mesh=2), dict(stream_chunk=512), dict(resume="ckpt")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdistribute.run_sweep(tengine.SweepSpec(), CacheParams(),
                                  TimingConfig(), **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdistribute.Mesh().resolve_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tworkloads.pollution_probe(CacheParams())


def test_cuda_backend_on_cpu_tensors_raises():
    p = CacheParams(l1_bytes=1024, l1_ways=2, l2_bytes=4096, l2_ways=4)
    addr = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernels.mesi_cache_sim(addr, addr, addr, addr, params=p,
                                backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernels.mesi_segment(init_batch_carry(p, 1), addr, addr, addr, addr,
                              params=p, backend="cuda")
    # the JAX package's kernel backend name selects the CUDA kernel
    with pytest.raises(ValueError, match="CUDA tensors"):
        tengine.run_traces(p, addr, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        tengine.run_traces(p, addr, backend="tpu")


def test_unported_workloads_raise_by_name():
    """Every workload of the JAX package is ported: by name, by
    attribute, and none listed as unported; an unknown name raises."""
    assert tworkloads.UNPORTED == {}
    assert tworkloads.get("kv_decode") == tworkloads.KVDecode()
    assert tworkloads.get("moe_stream", seed=3) == \
        tworkloads.MoEStream(seed=3)
    assert callable(tworkloads.pollution_probe)
    assert set(tworkloads.WORKLOADS) == {
        "stream", "pointer_chase", "gups", "hot_cold", "kv_decode",
        "moe_stream"}
    with pytest.raises(KeyError, match="unknown workload"):
        tworkloads.get("meteor")


def test_serving_path_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    cfg = get_smoke("h2o-danube-3-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run(cfg, requests=1, decode=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(cfg, n_pages=4, page_size=4, max_blocks=2,
                     hbm_page_budget=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tworkloads.KVDecode().device_trace(16 * 1024)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_params(cfg)


def test_training_path_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    cfg = get_smoke("h2o-danube-3-4b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run(cfg, steps=1, batch=1, seq=8, log_every=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_at_step(cfg, DataConfig(), 0)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_unported_block_kinds_raise_naming_their_item(arch):
    """No block kind is left unported: for each of the ten architectures
    the smoke config builds, ``forward_prefill`` gives finite logits, and
    ``init_cache`` gives the prefill's cache tree (leaf names, shapes and
    dtypes) once the prefill is padded to the same capacity."""
    cfg = get_smoke(arch)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    kinds = {k for seg in ttf.segments(cfg) for k in seg.pattern}
    for seg in params["segments"]:
        for b, p in seg[0].items():
            assert {"ln1", "ln2"} <= set(p)
    lead = (1,) if cfg.n_codebooks == 1 else (1, cfg.n_codebooks)
    vision = (torch.zeros((1, cfg.vision_tokens, cfg.vision_dim))
              if cfg.vision_tokens else None)
    logits, caches = ttf.forward_prefill(
        params, cfg, torch.zeros(lead + (6,), dtype=torch.int32),
        vision=vision)
    assert bool(torch.isfinite(logits).all())
    caches = ttf.pad_cache(caches, cfg, 8)
    assert _shapes(caches) == _shapes(ttf.init_cache(cfg, 1, 8,
                                                     device="cpu")), kinds


def test_no_module_names_the_closed_item():
    """Every block kind is ported: no module of the port mentions the
    ROADMAP item that listed the missing ones, or raises
    NotImplementedError outside the abstract workload methods."""
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        text = path.read_text()
        assert "item 11" not in text, path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc.func if isinstance(node.exc, ast.Call) \
                    else node.exc
                if getattr(exc, "id", None) == "NotImplementedError":
                    assert path.name == "base.py" \
                        and path.parent.name == "workloads", path


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    from repro_torch.kernels import build
    (tmp_path / "k.cu").write_text('#include <climits>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = build._target("k")
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert build._target("k") != before
    assert set(build.LIBRARIES) == {"mesi", "mesi_dyn", "paged_attention",
                                    "cache_sim", "stream_triad",
                                    "flash_attention"}
    monkeypatch.setattr(build, "CSRC", build.HERE / "csrc")
    for name in ("mesi", "mesi_dyn"):
        assert [p.name for p in build.sources(name)] == [
            f"{name}.cu", "mesi_chain.cuh", "mesi_access.cuh"]
    assert [p.name for p in build.sources("cache_sim")] == [
        "cache_sim.cu", "mesi_chain.cuh", "mesi_access.cuh"]
    for name in ("paged_attention", "stream_triad"):
        assert [p.name for p in build.sources(name)] == [f"{name}.cu"]
    assert [p.name for p in build.sources("flash_attention")] == [
        "flash_attention.cu", "hopper.cuh"]


_BUILD_PROBE = """
import importlib, pkgutil, subprocess
def refuse(*a, **k):
    raise AssertionError("a module ran a process while it was imported")
subprocess.Popen = refuse
import repro_torch
from repro_torch.kernels import build
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch.kernels import cache_sim, flash_attention, ops, stream_triad
import repro_torch.kernels as kernels_pkg
assert kernels_pkg.ops is ops and kernels_pkg.ref.cache_sim
assert build.load.cache_info().currsize == 0
for mod in (flash_attention, stream_triad):
    assert mod._library.cache_info().currsize == 0
print(sorted(n for n in dir(ops) if not n.startswith("_")))
"""


def test_importing_the_kernels_builds_nothing():
    out = subprocess.run(
        [sys.executable, "-c", _BUILD_PROBE], capture_output=True, text=True,
        check=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    names = set(ast.literal_eval(out.stdout))
    for k in ("cache_sim", "stream_triad", "flash_attention",
              "paged_attention"):
        assert {k, k + "_ref"} <= names
