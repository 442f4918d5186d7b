"""The Kimi-Linear serving cell at smoke widths: a sound run is correct,
and a run with a fault planted in the program comes out not correct — beta
dropped (every write at full strength), the decay per head instead of per
key channel, the convolution's window not carried into decode, rotary in
the MLA layers, the q / k l2 norm dropped, the state kind priced as a
latent page, K4 over float8 rows.  Its FLOP counts' frozen parameters
against the program's own tree."""
import dataclasses
import json

import pytest
import torch

import run as bench_run
from bench_kda_cells import small_kda_cell
from harness.core import BENCH, Cell, load_module

CPU = torch.device("cpu")
GEN = load_module(BENCH / "generators" / "serve_kda_mla_moe.py",
                  "test_gen_kda_")


def run_line(cell, trace=False):
    line, _, rc = bench_run.run_cell(cell, 2**31 + 27, 0.0, trace, CPU)
    assert rc == 0
    return json.loads(line)


def test_the_cell_is_found_by_name():
    cell = Cell("kimi-linear-48b-a3b.serve-16k")
    assert cell.traffic["generator"] == "serve_kda_mla_moe"
    assert {m["name"] for m in cell.per_layer} == {
        "kda_device_ms.serve", "serve_mfu_pct.kda_mla_moe",
        "decode_mfu_pct.kda_mla_moe",
        "moe_device_ms.serve", "k4_mla_roofline_pct",
        "device_idle_pct.serve", "prefill_ms_per_request.serve"}
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "serve_tokens_per_s", "decode_step_ms"}
    assert hasattr(cell.generator(), "Run")


def test_sound_run_is_correct_and_reads_its_metrics():
    out = run_line(small_kda_cell(), trace=True)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == {"token_gap", "logit_err", "attn_err",
                                  "state_err", "kv_mismatch",
                                  "route_mismatch"}
    # the CPU has no device time: K4's roofline share and the device's
    # idle share are not read
    assert set(out["metrics"]) == {"kda_device_ms.serve",
                                   "moe_device_ms.serve",
                                   "serve_mfu_pct.kda_mla_moe",
                                   "decode_mfu_pct.kda_mla_moe",
                                   "prefill_ms_per_request.serve"}


def _patch_inputs(monkeypatch, change):
    from repro_torch.models import kda
    real = kda._inputs

    def inputs(params, x, cfg, window):
        return change(*real(params, x, cfg, window))
    monkeypatch.setattr(kda, "_inputs", inputs)


def _beta_dropped(monkeypatch):
    _patch_inputs(monkeypatch, lambda q, k, v, g, beta, w: (
        q, k, v, g, torch.ones_like(beta), w))


def _decay_per_head(monkeypatch):
    _patch_inputs(monkeypatch, lambda q, k, v, g, beta, w: (
        q, k, v, g.mean(-1, keepdim=True).expand_as(g), beta, w))


def _window_not_carried(monkeypatch):
    from repro_torch.models import kda
    real = kda._inputs

    def inputs(params, x, cfg, window):
        return real(params, x, cfg, torch.zeros_like(window))
    monkeypatch.setattr(kda, "_inputs", inputs)


def _rotary_in_mla(monkeypatch):
    from repro_torch.models import attention as attn
    real = attn._mla_qkv
    monkeypatch.setattr(attn, "_mla_qkv", lambda p, x, cfg, pos: real(
        p, x, dataclasses.replace(cfg, rope="rope"), pos))


def _l2_norm_dropped(monkeypatch):
    from repro_torch.models import kda
    monkeypatch.setattr(kda, "_l2norm", lambda x: x)


def _state_priced_as_a_latent_page(monkeypatch):
    from repro_torch.models import kda
    page = small_kda_cell().traffic["page_size"]
    monkeypatch.setattr(kda, "state_bytes", lambda cfg: page * 2 * (
        cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim))


def _k4_over_float8_rows(monkeypatch):
    from repro_torch.memory.kvcache import PagedKVCache
    real = PagedKVCache.f32_pools

    def f32_pools(self, layer):
        return tuple(p.to(torch.float8_e4m3fn).float()
                     for p in real(self, layer))
    monkeypatch.setattr(PagedKVCache, "f32_pools", f32_pools)


@pytest.mark.parametrize("fault", [_beta_dropped, _decay_per_head,
                                   _window_not_carried, _rotary_in_mla,
                                   _l2_norm_dropped,
                                   _state_priced_as_a_latent_page,
                                   _k4_over_float8_rows])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_line(small_kda_cell())
    assert out["correct"] is False and out["failed"] > 0


def test_flops_count_the_programs_touched_parameters():
    """The FLOP count's parameters a token touches, against the program's
    own parameter tree at the cell's widths (meta tensors): every leaf but
    the embedding, the norms, A_log, dt_bias, the biases and the held
    experts' products; its attention's and its recurrence's FLOPs."""
    from repro_torch.models import transformer as tf
    mfu = load_module(BENCH / "metrics" / "serve_mfu_pct.kda_mla_moe.py",
                      "t_mfu_kda_")
    m = Cell("kimi-linear-48b-a3b.serve-16k").config
    shapes = tf.param_shapes(GEN.program_config(m))

    def count(node, path=""):
        if isinstance(node, torch.Tensor):
            skip = (path.startswith("/embed") or "norm" in path
                    or "/ln" in path or path.endswith("bias")
                    or path.endswith("A_log")
                    or path.endswith("/moe/wiu") or path.endswith("/moe/wo"))
            return 0 if skip else node.numel()
        items = node.items() if isinstance(node, dict) else enumerate(node)
        return sum(count(v, f"{path}/{k}") for k, v in items)
    head = m["hidden_size"] * m["vocab_size"]
    assert mfu.body_params(m) + head == count(shapes)
    # 7 MLA layers attend, 20 KDA layers recur
    assert mfu.attended_flops(m, 10) == 7 * 2 * 32 * (192 + 128) * 10
    assert mfu.recurrence_flops(m) == 20 * 6 * 32 * 128 * 128
    assert mfu.request_flops(m, 1, 0) == (
        2 * (mfu.body_params(m) + head) + mfu.recurrence_flops(m)
        + mfu.attended_flops(m, 1))
    # a decode token: the same parameters and recurrence, the absorbed
    # attention over 576-wide latent rows with 512-wide values
    dec = load_module(BENCH / "metrics" / "decode_mfu_pct.kda_mla_moe.py",
                      "t_dmfu_kda_")
    assert dec.token_flops(m) == 2 * (mfu.body_params(m) + head) \
        + mfu.recurrence_flops(m)
    assert dec.position_flops(m) == 7 * 2 * 32 * (576 + 512)
