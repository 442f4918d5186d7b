"""The MiMo-V2-Flash serving cell at smoke widths: a sound run is correct,
and a run with a fault planted in the program comes out not correct — the
sinks dropped, the window ignored in decode, the window layers at the full
layers' rope theta, the pool priced as one kind.  Its metrics' frozen
formulas against the program's own arithmetic."""
import dataclasses
import json

import pytest
import torch

import run as bench_run
from bench_hybrid_cells import small_hybrid_cell
from harness.core import BENCH, Cell, load_module

CPU = torch.device("cpu")
GEN = load_module(BENCH / "generators" / "serve_hybrid_moe.py",
                  "test_gen_hybrid_")


def run_line(cell, trace=False):
    line, _, rc = bench_run.run_cell(cell, 2**31 + 27, 0.0, trace, CPU)
    assert rc == 0
    return json.loads(line)


def test_the_cell_is_found_by_name():
    cell = Cell("mimo-v2-flash-309b.serve-4k")
    assert cell.traffic["generator"] == "serve_hybrid_moe"
    assert {m["name"] for m in cell.per_layer} == {
        "k4_hybrid_roofline_pct", "decode_mfu_pct.hybrid_moe",
        "serve_mfu_pct.hybrid_moe", "moe_device_ms.serve", "device_idle_pct.serve",
        "prefill_ms_per_request.serve"}
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "serve_tokens_per_s", "decode_step_ms"}
    assert hasattr(cell.generator(), "Run")


def test_sound_run_is_correct_and_reads_its_metrics():
    out = run_line(small_hybrid_cell(), trace=True)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == {"token_gap", "logit_err", "attn_err",
                                  "kv_mismatch", "route_mismatch"}
    # the CPU has no device time: K4's roofline share and the device's
    # idle share are not read
    assert set(out["metrics"]) == {"moe_device_ms.serve",
                                   "decode_mfu_pct.hybrid_moe",
                                   "serve_mfu_pct.hybrid_moe",
                                   "prefill_ms_per_request.serve"}


def _sinks_dropped(monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    blockwise, decode, k4 = (attn.blockwise_attention, attn.decode_attention,
                             ops.paged_attention)
    monkeypatch.setattr(attn, "blockwise_attention", lambda *a, **kw: (
        blockwise(*a, **dict(kw, sinks=None))))
    monkeypatch.setattr(attn, "decode_attention", lambda q, k, v, n, s=None: (
        decode(q, k, v, n)))
    monkeypatch.setattr(ops, "paged_attention", lambda *a, **kw: (
        k4(*a, **dict(kw, sinks=None))))


def _window_ignored_in_decode(monkeypatch):
    from repro_torch.models import attention as attn
    real = attn.attention_decode

    def decode(params, x, cfg, cache, ctx_len, **kwargs):
        return real(params, x, dataclasses.replace(cfg, window=None), cache,
                    ctx_len)
    monkeypatch.setattr(attn, "attention_decode", decode)


def _window_layers_at_the_full_theta(monkeypatch):
    from repro_torch.configs import base
    real = base._layer_config

    def layer(cfg, i):
        return dataclasses.replace(real(cfg, i), rope_theta=cfg.rope_theta)
    monkeypatch.setattr(base, "_layer_config", layer)


def _pool_priced_as_one_kind(monkeypatch):
    from repro_torch.memory.kvcache import PagedKVCache
    real = PagedKVCache.page_bytes
    monkeypatch.setattr(PagedKVCache, "page_bytes",
                        lambda self, kind=0: real(self, 0))


@pytest.mark.parametrize("fault", [_sinks_dropped, _window_ignored_in_decode,
                                   _window_layers_at_the_full_theta,
                                   _pool_priced_as_one_kind])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_line(small_hybrid_cell())
    assert out["correct"] is False and out["failed"] > 0


@pytest.mark.parametrize("kind", ["full", "window"])
def test_k4_hybrid_bytes_match_the_programs_bound_bytes(kind):
    from repro_torch.kernels.paged_attention import bound_bytes
    k4 = load_module(BENCH / "metrics" / "k4_hybrid_roofline_pct.py",
                     "t_k4h_")
    kh, nblk, sinks = (4, 262, False) if kind == "full" else (8, 8, True)
    q = torch.zeros((8, 64, 192))
    pages = torch.zeros((2104, 16, kh, 192))
    bt = torch.zeros((8, nblk), dtype=torch.int32)
    ctx = torch.tensor([4096, 4100, 1, 0, 16, 17, 4159, 4160]).clamp(
        max=nblk * 16)
    call = {"q": tuple(q.shape), "q_bytes": 4, "pages": tuple(pages.shape),
            "v_width": 128, "kv_bytes": 4, "blocks": nblk,
            "ctx": ctx.tolist(), "sinks": sinks}
    assert k4.bound_bytes(call) == bound_bytes(q, pages, bt, ctx, v_dim=128,
                                               sinks=sinks)


@pytest.mark.parametrize("reader", ["decode_mfu_pct.hybrid_moe",
                                    "serve_mfu_pct.hybrid_moe"])
def test_flops_count_the_programs_touched_parameters(reader):
    """Each FLOP count's parameters a token touches, against the program's
    own parameter tree at the cell's widths (meta tensors): every leaf but
    the embedding, the norms, the sinks, the biases and the held experts'
    products; and its FLOPs per attended position and layer."""
    from repro_torch.models import transformer as tf
    mfu = load_module(BENCH / "metrics" / f"{reader}.py", "t_mfu_h_")
    m = Cell("mimo-v2-flash-309b.serve-4k").config
    shapes = tf.param_shapes(GEN.program_config(m))

    def count(node, path=""):
        if isinstance(node, torch.Tensor):
            skip = (path.startswith("/embed") or "norm" in path
                    or "/ln" in path or path.endswith("bias")
                    or path.endswith("sinks")
                    or path.endswith("/moe/wiu") or path.endswith("/moe/wo"))
            return 0 if skip else node.numel()
        items = node.items() if isinstance(node, dict) else enumerate(node)
        return sum(count(v, f"{path}/{k}") for k, v in items)
    per_position = 2 * 64 * (192 + 128)
    if reader.startswith("decode"):
        assert mfu.touched_params(m) == count(shapes)
        assert mfu.position_flops(m) == per_position
    else:
        head = m["hidden_size"] * m["vocab_size"]
        assert mfu.body_params(m) + head == count(shapes)
        # 3 full layers see every position, 9 window layers at most 128
        assert mfu.attended_flops(m, 3, 9, 4096) == per_position * (
            3 * 4096 + 9 * 128)
        assert mfu.request_flops(m, 3, 9, 1, 0) == (
            2 * (mfu.body_params(m) + head) + per_position * 12)
