"""The served model's reference against the port at danube's smoke widths."""
import dataclasses

import pytest
import torch

from bench_cells import small_serve_cell
from harness.core import BENCH, load_module

REF = load_module(BENCH / "reference" / "dense_lm.py", "test_ref_")
SERVE = load_module(BENCH / "generators" / "serve.py", "test_generator_")
CPU = torch.device("cpu")


def f32_cell():
    cell = small_serve_cell()
    cell.config["model"]["dtype"] = "float32"
    return cell


def test_forward_matches_the_ports_prefill_in_float32():
    from repro_torch.models import transformer as tf
    m = f32_cell().config["model"]
    w = REF.make_params(m, 7, CPU, 0.1)
    cfg = SERVE.program_config(m)
    toks = torch.randint(0, m["vocab_size"], (20,),
                         generator=torch.Generator().manual_seed(1))
    got, cache = tf.forward_prefill(SERVE.program_params(m, w), cfg,
                                    toks[None].to(torch.int32))
    ref = REF.forward(m, w, toks, [19])
    assert REF.max_rel_err(got[0, -1:], ref) < 1e-5
    k_prog = cache[0][0]["b0"]["k"][0]
    assert REF.max_rel_err(k_prog, REF.layer0_keys(m, w, toks)) < 1e-5


def test_served_tokens_and_logits_match_in_float32():
    cell = f32_cell()
    run = SERVE.Run(cell, 2**31 + 3, CPU)
    run.window(0.0)
    run.release()
    r = run.readings()
    assert r["token_gap"] == 0.0
    assert r["logit_err"] < 1e-5 and r["attn_err"] < 1e-5
    # the loop prices a KV page at 2 B an element whatever the dtype, the
    # reference at the dtype's size: float32 pages differ, bf16 ones agree
    assert r["kv_mismatch"] > 0


@pytest.mark.parametrize("shape", [(3, 24, 6, 4, 5), (2, 7, 9, 2, 1),
                                   (4, 16, 3, 8, 100)])
def test_kv_accounting_matches_the_ports_cache(shape):
    from repro_torch.launch import serve
    from repro_torch.configs import get_smoke
    requests, prefill, decode, page, hbm = shape
    cfg = dataclasses.replace(get_smoke("h2o-danube-3-4b"), window=64)
    out = serve.run(cfg, requests=requests, prefill=prefill, decode=decode,
                    page_size=page, hbm_pages=hbm, device="cpu")
    cxl = small_serve_cell().traffic["cxl"]
    rd, wr = REF.cxl_payload_gbps(cxl)
    pb = page * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    want = REF.kv_accounting(requests, prefill, decode, page, hbm, pb, rd, wr)
    assert want == out["kv_stats"]


def test_cxl_payload_is_the_timing_models():
    from repro_torch.core.timing import CXLTiming
    rd, wr = REF.cxl_payload_gbps(small_serve_cell().traffic["cxl"])
    assert rd == CXLTiming().payload_read_gbps
    assert wr == CXLTiming().payload_write_gbps


def test_paged_attention_matches_the_ports_plain_version():
    from repro_torch.kernels.paged_attention import paged_attention_ref
    g = torch.Generator().manual_seed(3)
    b, h, kh, d, page, n_ctx = 3, 4, 2, 16, 4, 13
    q = torch.randn(b, h, d, generator=g)
    keys = torch.randn(b, 16, kh, d, generator=g)
    vals = torch.randn(b, 16, kh, d, generator=g)
    pools = [x.reshape(b * 4, page, kh, d) for x in (keys, vals)]
    bt = torch.arange(b * 4, dtype=torch.int32).reshape(b, 4)
    cl = torch.full((b,), n_ctx, dtype=torch.int32)
    got = paged_attention_ref(q, pools[0], pools[1], bt, cl)
    want = REF.paged_attention(q, keys, vals, n_ctx)
    assert REF.max_rel_err(got, want) < 1e-6


def test_inputs_are_the_serving_loops():
    """The loop draws its prompts and queries from default_rng(0)."""
    import numpy as np
    prompts, queries = REF.serve_inputs(2, 5, 3, 100, 4, 8, 0)
    rng = np.random.default_rng(0)
    assert (prompts[0] == rng.integers(0, 100, (1, 5))[0]).all()
    assert (prompts[1] == rng.integers(0, 100, (1, 5))[0]).all()
    assert np.array_equal(queries[0], rng.standard_normal(
        (2, 4, 8)).astype(np.float32))


def test_calibration_reads_both_sides():
    import calibrate
    prog, ctrl = calibrate.readings(small_serve_cell(), 9, 0.0, True, CPU)
    assert set(prog) == {"token_gap", "logit_err", "attn_err", "kv_mismatch"}
    assert set(ctrl) == {"token_gap", "logit_err", "attn_err"}
    assert ctrl["logit_err"] > prog["logit_err"]
