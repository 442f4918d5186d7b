"""The one-card dry run and its roofline against the JAX package.

The shape cells, `input_specs` and `param_shapes` (leaf by leaf, the JAX
tree's period axis unstacked as `convert.model_params` does) against the
reference's `jax.eval_shape` trees at full width; `model_flops` equal to
the reference for every (architecture x cell); the dry-run CLI on the
CPU; the FLOPs traced on fake tensors equal to a real CPU run's at smoke
size; and the roofline over the CLI's rows.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.models import transformer as jtf
from repro.roofline import analysis as janalysis
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.launch import dryrun
from repro_torch.memory import plan_serving
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from repro_torch.roofline import analysis, report

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = list(tmodel.SHAPES)


def leaves(node, path=()):
    """(path, leaf) pairs of a tree of dicts and lists, keys sorted."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from leaves(node[k], path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from leaves(v, path + (i,))
    else:
        yield path, node


def torch_layout(tree_):
    return {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in leaves(tree_)}


def unstacked(tree_, stacked_at: int):
    """The JAX tree's leaves with the period axis of every leaf under a
    stacked segment (path position `stacked_at`) split into periods."""
    out = {}
    for p, x in leaves(tree_):
        dt = str(x.dtype)
        if len(p) > stacked_at and (stacked_at == 0 or p[0] == "segments"):
            seg = p[:stacked_at + 1]
            for j in range(x.shape[0]):
                out[seg + (j,) + p[stacked_at + 1:]] = (tuple(x.shape[1:]),
                                                        dt)
        else:
            out[p] = (tuple(x.shape), dt)
    return out


@pytest.fixture(scope="module")
def jax_param_shapes():
    return {a: jtf.param_shapes(jget_config(a)) for a in ARCHS}


# ---------------------------------------------------------------------------
# shape cells, parameter shapes, input specs
# ---------------------------------------------------------------------------
def test_shape_cells_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tmodel.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jmodel.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_jax_eval_shape(arch, jax_param_shapes):
    got = ttf.param_shapes(get_config(arch))
    assert all(x.device.type == "meta" for _, x in leaves(got))
    want = unstacked(jax_param_shapes[arch], 1)
    assert torch_layout(got) == want


def test_param_shapes_run_at_full_width_without_allocating():
    cfg = get_config("deepseek-v3-671b")
    tree_ = ttf.param_shapes(cfg)
    # 671 B parameters: only meta tensors can hold them on this host
    assert ttf.n_param_elements(tree_) > 6.7e11
    assert {x.device.type for _, x in leaves(tree_)} == {"meta"}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, cell in tmodel.SHAPES.items():
        got = tmodel.input_specs(cfg, cell)
        assert all(x.device.type == "meta" for _, x in leaves(got))
        jcell = jmodel.SHAPES[name]
        if cell.kind != "decode":
            want = jmodel.input_specs(jcfg, jcell)
            assert torch_layout(got) == {
                p: (tuple(x.shape), str(x.dtype)) for p, x in leaves(want)}
            continue
        b, s = cell.global_batch, cell.seq_len
        caches = jax.eval_shape(lambda: jtf.init_cache(jcfg, b, s))
        assert torch_layout(got["caches"]) == unstacked(caches, 0), name
        assert tuple(got["token"].shape) == (
            (b, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b,))
        assert got["ctx_len"].shape == () and \
            got["ctx_len"].dtype == torch.int32


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch, cell):
    want = janalysis.model_flops(jget_config(arch), jmodel.SHAPES[cell])
    assert analysis.model_flops(get_config(arch),
                                tmodel.SHAPES[cell]) == want


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def danube_decode(tmp_path_factory):
    """The CLI on h2o-danube-3-4b decode_32k at full width, on the CPU."""
    out = tmp_path_factory.mktemp("dryrun")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "h2o-danube-3-4b", "--shape", "decode_32k", "--device", "cpu",
         "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return proc, out


def test_dryrun_cli_traces_the_decode_cell(danube_decode):
    proc, out = danube_decode
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[ok" in proc.stdout, proc.stdout
    meta = json.loads((out / "h2o-danube-3-4b__decode_32k__1xH100.json")
                      .read_text())
    assert meta["status"] == "ok" and meta["device"] == "cpu"
    assert meta["flops"] > 0 and meta["peak_memory_per_device"] > 0
    cfg = get_config("h2o-danube-3-4b")
    # parameters (bf16) and the window-sized caches are its arguments
    params = sum(x.numel() * x.element_size()
                 for _, x in leaves(ttf.param_shapes(cfg)))
    cache = 2 * 24 * 2 * 128 * min(cfg.window, 32768) * 8 * 120
    token = 128 * 4
    assert meta["argument_bytes"] == params + cache + token
    assert meta["peak_memory_per_device"] >= meta["argument_bytes"]
    assert meta["dot_traffic_bytes"] < meta["traffic_bytes"]


def test_roofline_over_the_dryrun_rows(danube_decode, tmp_path):
    _, out = danube_decode
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW) == (989e12, 3.35e12)
    (r,) = analysis.analyze_dir(out)
    meta = json.loads(next(out.glob("*.json")).read_text())
    cfg, cell = get_config(r.arch), tmodel.SHAPES["decode_32k"]
    assert r.chips == 1 and r.collective_s == 0.0 and r.mesh == "1xH100"
    assert r.compute_s == meta["flops"] / 989e12
    assert r.memory_s == meta["dot_traffic_bytes"] / 3.35e12
    assert r.memory_hi_s == meta["traffic_bytes"] / 3.35e12
    assert r.cxl_s == plan_serving(cfg, n_devices=1, batch=128,
                                   context=32768).cxl_seconds
    assert r.useful_ratio == analysis.model_flops(cfg, cell) / meta["flops"]
    assert r.dominant == max(r.terms(), key=r.terms().get)
    assert "TPU" not in r.next_action and "Pallas" not in r.next_action
    for table in (analysis.to_markdown([r]), report.roofline_table([r]),
                  report.dryrun_table(out), report.compare_table([r], [r])):
        assert "h2o-danube-3-4b" in table
    report.main(["--baseline", str(out), "--optimized", str(out), "--out",
                 str(tmp_path)])
    assert (tmp_path / "before_after.md").read_text().count("|") > 10


def test_long_500k_skip_rule(tmp_path, capsys):
    rc = dryrun.main(["--arch", "granite-3-8b", "--shape", "long_500k",
                      "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    assert "[skipped" in capsys.readouterr().out
    meta = json.loads((tmp_path / "granite-3-8b__long_500k__1xH100.json")
                      .read_text())
    assert meta["status"] == "skipped" and "quadratic" in meta["note"]
    # a sub-quadratic architecture traces the cell
    res = dryrun.run_cell("rwkv6-1.6b", "long_500k",
                          overrides=dict(n_layers=1), device="cpu")
    assert res.status == "ok" and res.flops > 0


def test_a_failing_cell_is_reported_failed():
    res = dryrun.run_cell("h2o-danube-3-4b", "decode_32k",
                          overrides=dict(head_dim=7), device="cpu")
    assert res.status == "failed" and res.note
    assert "[failed" in dryrun.line(res)


def test_memory_trace_counts_live_storages_and_bytes_moved():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        mem = dryrun.MemoryTrace(block=512)
        x = torch.empty(1000)
        mem.track(x)
        with mem:
            y = x * 2
            assert mem.live == 8192
            del y
            s = x.sum()
            v = x.view(10, 100)
    assert mem.peak == 8192 and mem.live == 4096 + 512
    assert mem.traffic == 8000 + 4004 and mem.dot_traffic == 0
    del s, v


def smoke_overrides(arch):
    full, smoke = get_config(arch), get_smoke(arch)
    over = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
            if getattr(smoke, f.name) != getattr(full, f.name)}
    assert dataclasses.replace(full, **over) == smoke
    return over


def real_inputs(cfg, cell, gen):
    """Random real tensors shaped like `input_specs` on the CPU."""
    def real(x):
        if x.dtype == torch.int32:
            return torch.randint(0, min(cfg.vocab_size, cell.seq_len),
                                 x.shape, generator=gen, dtype=torch.int32)
        return torch.randn(x.shape, generator=gen).to(x.dtype)
    specs = tmodel.input_specs(cfg, cell)
    if cell.kind == "decode":
        return {"token": real(specs["token"]),
                "caches": ttf.init_cache(cfg, cell.global_batch,
                                         cell.seq_len, device="cpu")}
    return {k: real(v) for k, v in specs.items()}


@pytest.mark.parametrize("arch,kind", [
    ("h2o-danube-3-4b", "train"), ("qwen3-moe-235b-a22b", "train"),
    ("rwkv6-1.6b", "train"), ("recurrentgemma-9b", "train"),
    ("deepseek-v3-671b", "train"), ("h2o-danube-3-4b", "prefill"),
    ("qwen2-vl-2b", "prefill"),
    ("musicgen-large", "prefill"), ("stablelm-12b", "prefill"),
    ("granite-3-8b", "decode"), ("starcoder2-3b", "decode"),
    ("deepseek-v3-671b", "decode"), ("rwkv6-1.6b", "decode"),
    ("recurrentgemma-9b", "decode")])
def test_fake_trace_counts_the_flops_of_a_real_run(arch, kind):
    cfg = get_smoke(arch)
    cell = tmodel.ShapeCell(f"smoke_{kind}", 16, 2, kind)
    res = dryrun.run_cell(arch, cell, overrides=smoke_overrides(arch),
                          device="cpu")
    assert res.status == "ok", res.note
    gen = torch.Generator().manual_seed(0)
    params = ttf.init_params(cfg, gen, "cpu")
    inputs = real_inputs(cfg, cell, gen)
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            opt = adamw.init(params)
            tmodel.make_train_step(cfg, adamw.AdamWConfig())(params, opt,
                                                             inputs)
        elif kind == "prefill":
            tmodel.prefill_step(params, cfg, inputs)
        else:
            tmodel.serve_step(params, cfg, inputs["token"], inputs["caches"],
                              cell.seq_len - 1)
    assert res.flops == counter.get_total_flops() > 0
    n = ttf.n_param_elements(params)
    p_bytes = sum(x.numel() * x.element_size() for _, x in leaves(params))
    assert res.peak_memory_per_device >= res.argument_bytes
    if kind == "train":
        # parameters, both f32 moments, the step counter and the batch
        assert res.argument_bytes == p_bytes + 8 * n + 4 + sum(
            x.numel() * 4 for x in inputs.values() if x.dtype == torch.int32
        ) + sum(x.numel() * 2 for x in inputs.values()
                if x.dtype == torch.bfloat16)
        assert res.peak_memory_per_device >= p_bytes + 8 * n
