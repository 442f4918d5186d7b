"""Share of the traced stretch of decode steps (K4, then every
sequence's ``decode_step``) in which no kernel, copy or set ran on the
card."""


def read(ctx):
    s = ctx["summary"]
    if s is None or s.window_us <= 0 or not s.ops:
        return None
    return 100.0 * (1.0 - s.busy_us / s.window_us)
