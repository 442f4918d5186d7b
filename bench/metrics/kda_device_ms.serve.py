"""Device time per traced decode step inside the program's KDA spans,
summed over the batch's sequences and the KDA layers:
``repro_torch.kda.step`` (a layer's convolution window, gates and
recurrent step, updating the state in place) of ``models/kda.py``, as
``harness.spans.reduce_spans`` gives it over the traced stretch."""


def read(ctx):
    c = ctx["counters"]
    spans, steps = c.get("spans") or {}, c.get("traced_steps", 0)
    step = spans.get("kda.step", {})
    if not steps or not step.get("calls"):
        return None
    return step.get("device_us", 0.0) / steps / 1e3
