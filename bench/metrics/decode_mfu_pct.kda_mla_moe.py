"""The whole decode step's share of the card's bf16 peak for a model of
gated delta-rule (KDA) and latent-attention (MLA) layers over sparse
experts, held as one expert-parallel rank: model FLOPs of every decode
token of the window, over the summed ``decode_s`` of its batches times 989
TFLOP/s.  ``decode_s`` is the serving loop's decode step as a whole
(``gather_args``, the pool cast, K4, every sequence's ``decode_step``);
the layer is named so.

The FLOP count, frozen here: a token costs 2 x the parameters it touches
(``serve_mfu_pct.kda_mla_moe``'s ``body_params``: each KDA layer's
projections and convolution, each MLA layer's matrices, which the absorbed
decode reads whole, the dense layer's FFN, each MoE layer's gate over all
routed experts and its shared expert; and the head), plus 6 x heads x key
width x value width per KDA layer for the recurrence, plus 2 x heads x
(576 + 512) per attended position and MLA layer (the absorbed decode's
scores over the latent and its key's rope part, and its values over the
latent), plus 2 x 3 x d x expert width for each assignment to a held
expert, counted from the routes the program's gate chose in the decode
steps (the generator's ``decode_held``).  Decode token i (0..D-1) of a
P-token prompt attends P + i + 1 positions.
"""
import pathlib

from harness.core import load_module

_SERVE = load_module(
    pathlib.Path(__file__).with_name("serve_mfu_pct.kda_mla_moe.py"),
    "bench_metric_decode_kda_")


def position_flops(m) -> int:
    """Per attended position, summed over the MLA layers."""
    mla = sum(not _SERVE._is_kda(m, i) for i in range(m["num_hidden_layers"]))
    kvl = m["kv_lora_rank"]
    return 2 * m["num_attention_heads"] * (
        kvl + m["qk_rope_head_dim"] + kvl) * mla


def token_flops(m) -> int:
    """A decode token's FLOPs, its attention and the held experts left
    out."""
    return (2 * (_SERVE.body_params(m) + m["hidden_size"] * m["vocab_size"])
            + _SERVE.recurrence_flops(m))


def read(ctx):
    c = ctx["counters"]
    m = c.get("model") or {}
    if not c.get("calls") or not sum(c.get("decode_s") or []) \
            or "linear_attn_config" not in m \
            or len(c.get("decode_held") or []) != c["calls"]:
        return None
    p, d, r = c["prefill"], c["decode"], c["requests"]
    per_batch = r * (d * token_flops(m) + position_flops(m) * sum(
        p + i + 1 for i in range(d)))
    expert = 2 * 3 * m["hidden_size"] * m["moe_intermediate_size"]
    flops = c["calls"] * per_batch + expert * sum(c["decode_held"])
    return 100.0 * flops / (sum(c["decode_s"])
                            * ctx["peaks"]["bf16_flops_per_s"])
