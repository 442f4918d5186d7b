"""A whole serving batch's share of the card's bf16 peak for a model of
window and full attention layers over sparse experts, held as one
expert-parallel rank: model FLOPs of every prompt position and every decode
token of the window, over the summed ``prefill_s`` and ``decode_s`` of its
batches times 989 TFLOP/s.  It bounds ``serve_tokens_per_s`` where the
prefill is much of a batch, as with 4k prompts; a reading above 100% means
work was left out.

The FLOP count, frozen here: a position costs 2 x the parameters it
touches (every layer's q | k | v and output projections, the dense layers'
FFNs, each MoE layer's gate over all routed experts; not the embedding, a
lookup, nor the norms, sinks and biases), plus 2 x heads x (head width +
value width) per attended position and layer, a full layer attending every
position up to its own, a window layer at most a window of them (the
per-kind layer counts: the generator's ``attn_layers``), plus 2 x 3 x d x
expert width for each assignment to a held expert, counted from the routes
the program's gate chose (the generator's ``prefill_held`` and
``decode_held``).  The head's d x vocab product counts where logits are
computed: once a request at the prefill's last position, and at every
decode token.  Prompt position p (1..P) attends p positions, decode token
i (0..D-1) P + i + 1.
"""


def body_params(m) -> int:
    """The parameters a position touches, the head left out."""
    d, n = m["hidden_size"], m["num_attention_heads"]
    hd, hv, layers = m["head_dim"], m["v_head_dim"], m["num_hidden_layers"]
    total = 0
    for i in range(layers):
        window = m["hybrid_layer_pattern"][i] == 1
        kh = m["swa_num_key_value_heads" if window else "num_key_value_heads"]
        total += d * ((n + kh) * hd + kh * hv) + n * hv * d
        total += (d * m["expert_parallel"]["router_experts"]
                  if m["moe_layer_freq"][i] else 3 * d
                  * m["intermediate_size"])
    return total


def attended_flops(m, full: int, window: int, ctx: int) -> int:
    """Attention's FLOPs for a position that sees `ctx` positions."""
    return 2 * m["num_attention_heads"] * (m["head_dim"] + m["v_head_dim"]) \
        * (full * ctx + window * min(ctx, m["sliding_window"]))


def request_flops(m, full: int, window: int, prefill: int,
                  decode: int) -> int:
    """One request's FLOPs, the held experts left out: its prefill, then
    `decode` tokens."""
    head = 2 * m["hidden_size"] * m["vocab_size"]
    body = 2 * body_params(m)
    return (prefill + decode) * body + (1 + decode) * head + sum(
        attended_flops(m, full, window, p)
        for p in range(1, prefill + decode + 1))


def read(ctx):
    c = ctx["counters"]
    busy = sum(c.get("prefill_s", [])) + sum(c.get("decode_s", []))
    held = [c.get(k) or [] for k in ("prefill_held", "decode_held")]
    if not c.get("calls") or not busy or "attn_layers" not in c \
            or any(len(h) != c["calls"] for h in held):
        return None
    m = c["model"]
    per_request = request_flops(m, c["attn_layers"]["full"],
                                c["attn_layers"]["window"], c["prefill"],
                                c["decode"])
    expert = 2 * 3 * m["hidden_size"] * m["moe_intermediate_size"]
    flops = (c["calls"] * c["requests"] * per_request
             + expert * sum(sum(h) for h in held))
    return 100.0 * flops / (busy * ctx["peaks"]["bf16_flops_per_s"])
