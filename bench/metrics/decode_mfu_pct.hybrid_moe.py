"""The whole decode step's share of the card's bf16 peak for a model of
window and full attention layers over sparse experts, held as one
expert-parallel rank: model FLOPs of every decode token of the window, over
the summed ``decode_s`` of its batches times 989 TFLOP/s.  ``decode_s`` is
the serving loop's decode step as a whole (``gather_args``, the pool casts,
K4 once per pool kind, every sequence's ``decode_step``); the layer is
named so.

The FLOP count, frozen here: a token costs 2 x the parameters it touches
(every layer's q | k | v and output projections, the dense layers' FFNs,
each MoE layer's gate over all routed experts, the head; not the
embedding, a lookup, nor the norms, sinks and biases), plus 2 x heads x
(head width + value width) per attended position and layer, a full layer
attending every position up to the token's, a window layer at most a
window of them (the per-kind layer counts: the generator's
``attn_layers``), plus 2 x 3 x d x expert width for each assignment to a
held expert, counted from the routes the program's gate chose in the
decode steps (the generator's ``decode_held``).
"""


def touched_params(m) -> int:
    d, n, v = m["hidden_size"], m["num_attention_heads"], m["vocab_size"]
    hd, hv, layers = m["head_dim"], m["v_head_dim"], m["num_hidden_layers"]
    total = d * v
    for i in range(layers):
        window = m["hybrid_layer_pattern"][i] == 1
        kh = m["swa_num_key_value_heads" if window else "num_key_value_heads"]
        total += d * ((n + kh) * hd + kh * hv) + n * hv * d
        total += (d * m["expert_parallel"]["router_experts"]
                  if m["moe_layer_freq"][i] else 3 * d
                  * m["intermediate_size"])
    return total


def position_flops(m) -> int:
    """Per attended position and layer."""
    return 2 * m["num_attention_heads"] * (m["head_dim"] + m["v_head_dim"])


def read(ctx):
    c = ctx["counters"]
    if not c.get("calls") or not sum(c["decode_s"]) \
            or len(c.get("decode_held") or []) != c["calls"] \
            or "attn_layers" not in c:
        return None
    m, p, d, r = c["model"], c["prefill"], c["decode"], c["requests"]
    full, window = c["attn_layers"]["full"], c["attn_layers"]["window"]
    w = m["sliding_window"]
    per_batch = r * d * 2 * touched_params(m) + r * sum(
        position_flops(m) * (full * (p + i + 1) + window * min(p + i + 1, w))
        for i in range(d))
    expert = 2 * 3 * m["hidden_size"] * m["moe_intermediate_size"]
    flops = c["calls"] * per_batch + expert * sum(c["decode_held"])
    return 100.0 * flops / (sum(c["decode_s"])
                            * ctx["peaks"]["bf16_flops_per_s"])
