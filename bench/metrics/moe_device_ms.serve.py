"""Device time per traced decode step inside the program's MoE spans,
summed over the batch's sequences and the MoE layers:
``repro_torch.moe.route`` (the gate over all routed experts, the group
top-k, the sort of the assignments) and ``repro_torch.moe.experts`` (the
held experts' products and the combine) of ``models/moe.py``, as
``harness.spans.reduce_spans`` gives them over the traced stretch."""

STAGES = ("moe.route", "moe.experts")


def read(ctx):
    c = ctx["counters"]
    spans, steps = c.get("spans") or {}, c.get("traced_steps", 0)
    if not steps or not any(spans.get(s, {}).get("calls") for s in STAGES):
        return None
    return sum(spans.get(s, {}).get("device_us", 0.0)
               for s in STAGES) / steps / 1e3
