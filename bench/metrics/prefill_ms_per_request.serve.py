"""``serve.run``'s own prefill time (host clock, ending in a synchronize)
over the requests prefilled, for the batches of the window."""


def read(ctx):
    c = ctx["counters"]
    n = c.get("calls", 0) * c.get("requests", 0)
    if not n:
        return None
    return sum(c["prefill_s"]) / n * 1e3
