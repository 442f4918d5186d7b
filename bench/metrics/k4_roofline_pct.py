"""K4's share of its roofline: the least time the card's HBM needs for the
bytes of each traced ``ops.paged_attention`` call, over the device time of
everything launched inside those calls.

The bytes (a frozen copy of the program's ``paged_attention.bound_bytes``
arithmetic): q read and the output written, every live position's K and V
rows of every kv head read, the live block-table entries and the lengths
read, each once.
"""


def bound_bytes(call) -> int:
    b, h, d = call["q"]
    _, page, kh, _ = call["pages"]
    nblk = call["blocks"]
    ctx = [min(max(x, 0), nblk * page) for x in call["ctx"]]
    live = sum(min(-(-x // page), nblk) for x in ctx)
    return (2 * b * h * d * call["q_bytes"]
            + sum(ctx) * kh * 2 * d * call["kv_bytes"] + 4 * (live + b))


def read(ctx):
    s, calls = ctx["summary"], ctx["counters"].get("k4_calls") or []
    if s is None or not calls:
        return None
    dev_us = s.device_us("bench.k4")
    if dev_us <= 0:
        return None
    nbytes = sum(bound_bytes(c) for c in calls)
    return 100.0 * (nbytes / ctx["peaks"]["hbm_bytes_per_s"]) / (dev_us * 1e-6)
