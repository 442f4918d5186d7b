"""``serve_mfu_pct``: a whole batch's model FLOPs over its prefill and
decode time, by hand on fixed counters and against the dry run's analytic
prefill count it departs from (no embedding, the head once a request,
attention over each position's own context)."""
from harness.core import BENCH, Cell, load_module

SMALL = {"n_layers": 1, "d_model": 4, "d_ff": 2, "vocab_size": 10,
         "n_heads": 2, "n_kv_heads": 1, "head_dim": 2, "window": None,
         "tie_embeddings": False}


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", "test_metric_")


def test_serve_mfu_by_hand():
    mfu, dm = metric("serve_mfu_pct"), metric("decode_mfu_pct")
    # 72 body parameters (decode_mfu_pct's 152 less the embedding's and the
    # head's 40 each): a position at context c costs 2 x 72 + 4 x 2 heads
    # x 2 x c = 144 + 16 c; the head 2 x 4 x 10 = 80; the embedding none
    assert mfu.position_flops(SMALL, 5) == 144 + 16 * 5
    assert mfu.position_flops(SMALL, 5) + 80 + 80 == dm.token_flops(SMALL, 5)
    # prompt positions 1..3, the head once
    assert mfu.prefill_flops(SMALL, 3) == 3 * 144 + 16 * 6 + 80
    assert mfu.prefill_flops(SMALL, 3) == sum(
        dm.token_flops(SMALL, p) for p in (1, 2, 3)) - 3 * 80 - 2 * 80
    # then decode tokens at contexts 4 and 5, each with the head
    assert mfu.request_flops(SMALL, 3, 2) == 608 + 288 + 304
    ctx = {"peaks": {"bf16_flops_per_s": 1000.0},
           "counters": {"model": SMALL, "requests": 3, "prefill": 3,
                        "decode": 2, "calls": 2, "prefill_s": [3.0, 5.0],
                        "decode_s": [1.0, 3.0]}}
    # 2 batches x 3 requests x 1,200 FLOPs over 12 s at 1,000 FLOP/s
    assert mfu.read(ctx) == 100.0 * 2 * 3 * 1200 / (12 * 1000.0)
    assert mfu.read(dict(ctx, counters=dict(ctx["counters"], calls=0))) \
        is None


def test_serve_mfu_prefill_against_the_dry_runs_count():
    """The prefill-long cell's prompt: the dry run counts the embedding and
    the head at every position and attention at S / 2 positions a token."""
    from repro_torch.models.model import ShapeCell
    from repro_torch.roofline.analysis import model_flops
    program_config = load_module(BENCH / "generators" / "serve.py",
                                 "test_generator_").program_config
    mfu = metric("serve_mfu_pct")
    m = Cell("h2o-danube-3-4b.prefill-long").config["model"]
    assert not m["tie_embeddings"]
    p = 8192
    dry = model_flops(program_config(m), ShapeCell("prefill", p, 1,
                                                   "prefill"))
    attn = m["n_layers"] * 4.0 * m["n_heads"] * m["head_dim"]
    dv = 2.0 * m["d_model"] * m["vocab_size"]
    want = dry - dv * p - dv * (p - 1) + attn * (p * (p + 1) / 2 - p * p / 2)
    assert abs(mfu.prefill_flops(m, p) - want) <= 1e-9 * want
    # 8 requests a batch of 8,192 + 8 tokens: ~587 TFLOP
    assert 586e12 < 8 * mfu.request_flops(m, p, 8) < 588e12
