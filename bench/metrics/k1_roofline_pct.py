"""K1/K2's share of its roofline: the least time the card's HBM needs for
the bytes of the work (each input byte read once, each output byte written
once) over the device time of everything launched inside the
``ops.mesi_cache_sim`` / ``ops.mesi_run_segment`` entries.

The bytes of a launch: the trace fields of every simulated access (padding
left out), the packed cache carry read and written (L1 and L2 lines,
counters, clock).  A MESI step is a dependent chain, so the kernel is bound
by latency far below this roofline; the share tracks it all the same.
"""


def bound_bytes(calls, accesses: int) -> int:
    """Bytes of the traced launches that together simulated `accesses`."""
    if not calls:
        return 0
    return accesses * calls[0]["field_bytes"] + sum(
        c["fixed_bytes"] for c in calls)


def read(ctx):
    s, c = ctx["summary"], ctx["counters"]
    calls = c.get("k1_calls") or []
    if s is None or not calls:
        return None
    dev_us = s.device_us("bench.k1")
    if dev_us <= 0:
        return None
    nbytes = bound_bytes(calls, c["accesses_per_sweep"] * c["traced_sweeps"])
    return 100.0 * (nbytes / ctx["peaks"]["hbm_bytes_per_s"]) / (dev_us * 1e-6)
