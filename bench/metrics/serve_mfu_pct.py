"""A whole serving batch's share of the card's bf16 peak: model FLOPs of
every prompt position and every decode token of the window, over the summed
``prefill_s`` and ``decode_s`` of its batches times 989 TFLOP/s.  It bounds
``serve_tokens_per_s`` where the prefill is most of a batch, as with long
prompts: a reading above 100% means work was left out.

A position costs 2 x the body's parameters (the attention projections and
the MLP of every layer, the norms not) plus, per attention layer, 4 x heads
x head size x the positions it attends (its context with itself, capped by
the window): ``decode_mfu_pct``'s convention (the dry run's analytic one)
without the embedding, which is a lookup.  The head's d x vocab product
counts where logits are computed: once a request at the prefill's last
position, and at every decode token.  Decode token i (0..D-1) attends
P + i + 1 positions.
"""


def body_params(m) -> int:
    d, f, hd = m["d_model"], m["d_ff"], m["head_dim"]
    nq, nkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    return m["n_layers"] * (d * (nq + 2 * nkv) + nq * d + 3 * d * f)


def position_flops(m, ctx: int) -> float:
    eff = min(ctx, m["window"]) if m.get("window") else ctx
    return 2.0 * body_params(m) + m["n_layers"] * 4.0 * m["n_heads"] \
        * m["head_dim"] * eff


def head_flops(m) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


def prefill_flops(m, n: int) -> float:
    """The model FLOPs of one request's `n`-token prefill."""
    return sum(position_flops(m, p) for p in range(1, n + 1)) + head_flops(m)


def request_flops(m, prefill: int, decode: int) -> float:
    """One request: its prefill, then `decode` tokens."""
    return prefill_flops(m, prefill) + sum(
        position_flops(m, prefill + i + 1) + head_flops(m)
        for i in range(decode))


def read(ctx):
    c = ctx["counters"]
    busy = sum(c.get("prefill_s", [])) + sum(c.get("decode_s", []))
    if not c.get("calls") or not busy:
        return None
    flops = c["calls"] * c["requests"] * request_flops(
        c["model"], c["prefill"], c["decode"])
    return 100.0 * flops / (busy * ctx["peaks"]["bf16_flops_per_s"])
