"""The whole decode step's share of the card's bf16 peak: model FLOPs of
every decode token of the window at its context, over the summed
``decode_s`` of its batches times 989 TFLOP/s.  ``decode_s`` is the serving
loop's decode step as a whole: ``PagedKVCache.gather_args``' host
accounting, the f32 cast of the layer-0 pool, K4 and the model's
``decode_step`` per sequence; the layer is named so.

The FLOP count is the dry run's analytic convention, copied here whole so
that it cannot move: a token costs 2 x the parameters (embedding and head
included, the norms not) plus, per attention layer, 4 x heads x head size x
the positions it attends (its context with itself, capped by the window).
"""


def n_params(m) -> int:
    d, f, v, hd = m["d_model"], m["d_ff"], m["vocab_size"], m["head_dim"]
    nq, nkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    total = v * d + (0 if m["tie_embeddings"] else d * v)
    return total + m["n_layers"] * (d * (nq + 2 * nkv) + nq * d + 3 * d * f)


def token_flops(m, ctx: int) -> float:
    eff = min(ctx, m["window"]) if m.get("window") else ctx
    return 2.0 * n_params(m) + m["n_layers"] * 4.0 * m["n_heads"] \
        * m["head_dim"] * eff


def read(ctx):
    c = ctx["counters"]
    if not c.get("calls") or not sum(c["decode_s"]):
        return None
    m, p, d = c["model"], c["prefill"], c["decode"]
    per_batch = c["requests"] * sum(token_flops(m, p + i + 1)
                                    for i in range(d))
    flops = c["calls"] * per_batch
    return 100.0 * flops / (sum(c["decode_s"])
                            * ctx["peaks"]["bf16_flops_per_s"])
