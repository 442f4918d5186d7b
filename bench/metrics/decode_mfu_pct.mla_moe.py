"""The whole decode step's share of the card's bf16 peak for a latent-
attention MoE model held as one expert-parallel rank: model FLOPs of every
decode token of the window, over the summed ``decode_s`` of its batches
times 989 TFLOP/s.  ``decode_s`` is the serving loop's decode step as a
whole (``gather_args``, the pool cast, K4, every sequence's
``decode_step``); the layer is named so.

The FLOP count, frozen here: a token costs 2 x the parameters it touches
(every layer's MLA matrices, which the absorbed decode reads whole; the
dense layers' FFNs; each MoE layer's gate over all routed experts and its
shared experts; the head; not the embedding, a lookup, nor the norms), plus
2 x 128 x (576 + 512) per attended position and layer (the absorbed
decode's scores over the latent and rope key, and its values over the
latent), plus 2 x 3 x d x expert width for each assignment to a held
expert, counted from the routes the program's gate chose in the decode
steps (the generator's ``decode_held``).
"""


def touched_params(m) -> int:
    d, n, v = m["hidden_size"], m["num_attention_heads"], m["vocab_size"]
    ql, kvl = m["q_lora_rank"], m["kv_lora_rank"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    layers, dense = m["num_hidden_layers"], m["first_k_dense_replace"]
    mla = (d * ql + ql * n * (nope + rope) + d * (kvl + rope)
           + kvl * n * (nope + vd) + n * vd * d)
    moe = (d * m["expert_parallel"]["router_experts"]
           + 3 * d * m["moe_intermediate_size"] * m["n_shared_experts"])
    return (layers * mla + dense * 3 * d * m["intermediate_size"]
            + (layers - dense) * moe + d * v)


def position_flops(m) -> int:
    """Per attended position and layer."""
    kvl = m["kv_lora_rank"]
    return 2 * m["num_attention_heads"] * (kvl + m["qk_rope_head_dim"] + kvl)


def read(ctx):
    c = ctx["counters"]
    if not c.get("calls") or not sum(c["decode_s"]) \
            or len(c.get("decode_held") or []) != c["calls"]:
        return None
    m, p, d, r = c["model"], c["prefill"], c["decode"], c["requests"]
    per_batch = r * d * 2 * touched_params(m) + r * sum(
        m["num_hidden_layers"] * position_flops(m) * (p + i + 1)
        for i in range(d))
    expert = 2 * 3 * m["hidden_size"] * m["moe_intermediate_size"]
    flops = c["calls"] * per_batch + expert * sum(c["decode_held"])
    return 100.0 * flops / (sum(c["decode_s"])
                            * ctx["peaks"]["bf16_flops_per_s"])
