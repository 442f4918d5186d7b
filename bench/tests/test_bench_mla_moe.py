"""The DeepSeek-V3 serving cell at smoke widths: a sound run is correct,
and a run with a fault planted in the program comes out not correct — a
gate that ignores the group limit, a layer that drops its held experts'
part, a latent pool priced at the GQA row.  Its metrics' frozen formulas
against the program's own arithmetic."""
import json

import pytest
import torch

import run as bench_run
from bench_mla_cells import small_mla_moe_cell
from harness.core import BENCH, load_module

CPU = torch.device("cpu")
GEN = load_module(BENCH / "generators" / "serve_mla_moe.py", "test_gen_mla_")


def run_line(cell, trace=False):
    line, _, rc = bench_run.run_cell(cell, 2**31 + 27, 0.0, trace, CPU)
    assert rc == 0
    return json.loads(line)


@pytest.mark.parametrize("name,generator,per_layer", [
    ("deepseek-v3-671b.serve-spill", "serve_mla_moe",
     {"moe_device_ms.serve", "k4_mla_roofline_pct",
      "decode_mfu_pct.mla_moe", "device_idle_pct.serve",
      "prefill_ms_per_request.serve"}),
    ("h2o-danube-3-4b.prefill-long", "serve",
     {"prefill_ms_per_request.serve"})])
def test_the_new_cells_are_found_by_name(name, generator, per_layer):
    from harness.core import Cell
    cell = Cell(name)
    assert cell.traffic["generator"] == generator
    assert {m["name"] for m in cell.per_layer} == per_layer
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "serve_tokens_per_s"}
    assert hasattr(cell.generator(), "Run")


def test_sound_run_is_correct_and_reads_its_metrics():
    out = run_line(small_mla_moe_cell(), trace=True)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == {"token_gap", "logit_err", "attn_err",
                                  "kv_mismatch", "route_mismatch"}
    # the CPU has no device time: K4's roofline share and the device's
    # idle share are not read
    assert set(out["metrics"]) == {"moe_device_ms.serve",
                                   "decode_mfu_pct.mla_moe",
                                   "prefill_ms_per_request.serve"}


def _gate_without_groups(moe):
    real = moe.gate

    def gate(params, xt, cfg):
        import dataclasses
        flat = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_group=1, topk_group=1))
        return real(params, xt, flat)
    return "gate", gate


def _held_part_dropped(moe):
    real = moe._held_ffn

    def held_ffn(params, xt, cfg, **kwargs):
        return torch.zeros_like(real(params, xt, cfg, **kwargs))
    return "_held_ffn", held_ffn


def _pool_priced_as_gqa(moe):
    from repro_torch.memory.kvcache import PagedKVCache

    def page_bytes(self):
        return self.page_size * self.cfg.n_kv_heads * self.cfg.head_dim * 4
    return PagedKVCache, "page_bytes", page_bytes


@pytest.mark.parametrize("fault", [_gate_without_groups, _held_part_dropped,
                                   _pool_priced_as_gqa])
def test_fault_is_not_correct(monkeypatch, fault):
    from repro_torch.models import moe
    planted = fault(moe)
    target = (moe,) + planted if len(planted) == 2 else planted
    monkeypatch.setattr(*target)
    out = run_line(small_mla_moe_cell())
    assert out["correct"] is False and out["failed"] > 0


def test_k4_mla_bytes_match_the_programs_bound_bytes():
    from repro_torch.kernels.paged_attention import bound_bytes
    k4 = load_module(BENCH / "metrics" / "k4_mla_roofline_pct.py", "t_k4m_")
    q = torch.zeros((8, 128, 576))
    pages = torch.zeros((568, 16, 1, 576))
    bt = torch.zeros((8, 70), dtype=torch.int32)
    ctx = torch.tensor([1024, 1030, 1, 0, 16, 17, 1119, 1120])
    call = {"q": tuple(q.shape), "q_bytes": 4, "pages": tuple(pages.shape),
            "kv_bytes": 4, "blocks": 70, "ctx": ctx.tolist()}
    assert k4.bound_bytes(call, 512) == bound_bytes(q, pages, bt, ctx,
                                                    v_dim=512,
                                                    shared_kv=True)


def test_decode_flops_count_the_programs_touched_parameters():
    """The FLOP count's parameters a decode token touches, against the
    program's own parameter tree at the cell's widths (meta tensors): every
    leaf but the embedding, the norms and the held experts' products."""
    from repro_torch.models import transformer as tf
    from harness.core import Cell
    mfu = load_module(BENCH / "metrics" / "decode_mfu_pct.mla_moe.py",
                      "t_mfu_")
    m = Cell("deepseek-v3-671b.serve-spill").config
    shapes = tf.param_shapes(GEN.program_config(m))

    def count(node, path=""):
        if isinstance(node, torch.Tensor):
            skip = (path.startswith("/embed") or "norm" in path
                    or "/ln" in path or path.endswith("bias")
                    or path.endswith("/moe/wiu") or path.endswith("/moe/wo"))
            return 0 if skip else node.numel()
        items = node.items() if isinstance(node, dict) else enumerate(node)
        return sum(count(v, f"{path}/{k}") for k, v in items)
    assert mfu.touched_params(m) == count(shapes)
    assert mfu.position_flops(m) == 2 * 128 * (576 + 512)
