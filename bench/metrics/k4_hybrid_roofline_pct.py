"""K4's share of its roofline over a hybrid model's two-kind pool: the
least time the card's HBM needs for the bytes of each traced
``ops.paged_attention`` call (the full kind's launch and the window kind's
inside ``serve.window_pool``, both in ``bench.k4``), over the device time
of everything launched inside those calls.

The bytes (a frozen copy of the program's ``paged_attention.bound_bytes``
arithmetic with separate V rows and sinks): q read (B x H x the key width)
and the output written (B x H x the value width), each live position's K
row (the key width) and V row (the value width) of every kv head read
once, the sinks read (4 B a query head) where the call has them, the live
block-table entries and the lengths read.
"""


def bound_bytes(call) -> int:
    b, h, d = call["q"]
    _, page, kh, _ = call["pages"]
    dv, nblk = call["v_width"], call["blocks"]
    ctx = [min(max(x, 0), nblk * page) for x in call["ctx"]]
    live = sum(min(-(-x // page), nblk) for x in ctx)
    return (b * h * (d + dv) * call["q_bytes"]
            + sum(ctx) * kh * (d + dv) * call["kv_bytes"]
            + 4 * (live + b) + 4 * h * call["sinks"])


def read(ctx):
    s, calls = ctx["summary"], ctx["counters"].get("k4_calls") or []
    if s is None or not calls or "v_width" not in calls[0]:
        return None
    dev_us = s.device_us("bench.k4")
    if dev_us <= 0:
        return None
    nbytes = sum(bound_bytes(c) for c in calls)
    return 100.0 * (nbytes / ctx["peaks"]["hbm_bytes_per_s"]) / (dev_us * 1e-6)
