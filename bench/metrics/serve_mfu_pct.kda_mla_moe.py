"""A whole serving batch's share of the card's bf16 peak for a model of
gated delta-rule (KDA) and latent-attention (MLA) layers over sparse
experts, held as one expert-parallel rank: model FLOPs of every prompt
position and every decode token of the window, over the summed
``prefill_s`` and ``decode_s`` of its batches times 989 TFLOP/s.  It bounds
``serve_tokens_per_s`` where the prefill is most of a batch, as with 16k
prompts; a reading above 100% means work was left out.

The FLOP count, frozen here: a position costs 2 x the parameters it
touches (each KDA layer's q | k | v projection and convolution, its decay,
beta and output-gate projections and its output projection; each MLA
layer's query, latent, latent expansion and output projections; the dense
layer's FFN; each MoE layer's gate over all routed experts and its shared
expert; not the embedding, a lookup, nor the norms, A_log, dt_bias and
biases), plus 6 x heads x key width x value width per KDA layer for the
recurrence (the decay, the state's read by k, its update and its read by
q), plus 2 x heads x (192 + 128) per attended position and MLA layer,
plus 2 x 3 x d x expert width for each assignment to a held expert,
counted from the routes the program's gate chose (the generator's
``prefill_held`` and ``decode_held``).  The head's d x vocab product
counts where logits are computed: once a request at the prefill's last
position, and at every decode token.  Prompt position p (1..P) attends p
positions, decode token i (0..D-1) P + i + 1.
"""


def _is_kda(m, i) -> bool:
    return i + 1 in m["linear_attn_config"]["kda_layers"]


def body_params(m) -> int:
    """The parameters a position touches, the head and the held experts
    left out."""
    d, n = m["hidden_size"], m["num_attention_heads"]
    la = m["linear_attn_config"]
    h, dk, cw = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    w = h * dk
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    kvl, fe = m["kv_lora_rank"], m["moe_intermediate_size"]
    total = 0
    for i in range(m["num_hidden_layers"]):
        if _is_kda(m, i):
            total += (3 * d * w + cw * 3 * w + 2 * (d * dk + dk * w)
                      + d * h + w * d)
        else:
            total += (d * n * (nope + rope) + d * (kvl + rope)
                      + kvl * n * (nope + vd) + n * vd * d)
        if i < m["first_k_dense_replace"]:
            total += 3 * d * m["intermediate_size"]
        else:
            total += (d * m["expert_parallel"]["router_experts"]
                      + 3 * d * fe * m["num_shared_experts"])
    return total


def recurrence_flops(m) -> int:
    """The KDA layers' recurrence, a token."""
    la = m["linear_attn_config"]
    kda = sum(_is_kda(m, i) for i in range(m["num_hidden_layers"]))
    return 6 * la["num_heads"] * la["head_dim"] ** 2 * kda


def attended_flops(m, ctx: int) -> int:
    """The MLA layers' attention for a position that sees `ctx`
    positions."""
    mla = sum(not _is_kda(m, i) for i in range(m["num_hidden_layers"]))
    return 2 * m["num_attention_heads"] * (
        m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"]) \
        * ctx * mla


def request_flops(m, prefill: int, decode: int) -> int:
    """One request's FLOPs, the held experts left out: its prefill, then
    `decode` tokens."""
    head = 2 * m["hidden_size"] * m["vocab_size"]
    n = prefill + decode
    return (n * (2 * body_params(m) + recurrence_flops(m))
            + (1 + decode) * head
            + attended_flops(m, n * (n + 1) // 2))


def read(ctx):
    c = ctx["counters"]
    busy = sum(c.get("prefill_s", [])) + sum(c.get("decode_s", []))
    held = [c.get(k) or [] for k in ("prefill_held", "decode_held")]
    m = c.get("model") or {}
    if not c.get("calls") or not busy or "linear_attn_config" not in m \
            or any(len(h) != c["calls"] for h in held):
        return None
    per_request = request_flops(m, c["prefill"], c["decode"])
    expert = 2 * 3 * m["hidden_size"] * m["moe_intermediate_size"]
    flops = (c["calls"] * c["requests"] * per_request
             + expert * sum(sum(h) for h in held))
    return 100.0 * flops / (busy * ctx["peaks"]["bf16_flops_per_s"])
