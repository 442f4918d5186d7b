"""The program's own spans in a traced stretch: host, device and idle time
per stage.

While a profiler records, ``repro_torch`` opens a ``repro_torch.<stage>``
range (``repro_torch.<stage>#<id>`` for one request's) at each stage
boundary of a sweep and of a serve (``repro_torch.runtime.trace.SPANS``).
:func:`reduce_spans` reduces the Chrome-trace events of a traced stretch
to figures per stage, the name before ``#``, over its ``bench.window``:

- ``calls``: the spans that overlap the stretch;
- ``host_us``: their durations, clipped to the stretch;
- ``self_us``: ``host_us`` less the part its direct child spans cover;
- ``device_us``: the device operations whose launching runtime event
  (matched by correlation id, as :func:`harness.trace.reduce_trace` does)
  lies innermost in one of its spans;
- ``idle_us``: the device's idle gaps whose next launch lies innermost in
  one of its spans.

Operations and gaps launched outside every span go under ``(no span)``,
the stretch after the last device operation under its own entry.  A span
that began before the profiler started is not in the trace: its children
count as outermost spans.  The program opens its spans on one thread.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional

from harness.trace import DEVICE_CATS, WINDOW

PREFIX = "repro_torch."
NO_SPAN = "(no span)"
TAIL = "(after the last device operation)"
FIELDS = ("calls", "host_us", "self_us", "device_us", "idle_us")

# the per-layer metrics the spans are for: metric -> (stage, field, the
# generator's counter of traced units); each reads ms per traced unit
PER_UNIT = {
    "trace_build_ms.sweep": ("engine.build", "host_us", "traced_sweeps"),
    "fixed_point_ms.sweep": ("machine.time_batch", "host_us",
                             "traced_sweeps"),
    "kv_gather_ms.serve": ("kv.gather_args", "host_us", "traced_steps"),
    "decode_dispatch_ms.serve": ("serve.model", "self_us", "traced_steps"),
}


class _Spans:
    """The program's spans sorted by start, each with its parent."""

    def __init__(self, xs: List[Dict]):
        rows = sorted((float(e["ts"]), -float(e["dur"]),
                       e["name"][len(PREFIX):].partition("#")[0])
                      for e in xs if e.get("cat") == "user_annotation"
                      and e["name"].startswith(PREFIX))
        self.start = [s for s, _, _ in rows]
        self.end = [s - neg for s, neg, _ in rows]
        self.name = [n for _, _, n in rows]
        self.parent: List[Optional[int]] = []
        stack: List[int] = []
        for i, s in enumerate(self.start):
            while stack and self.end[stack[-1]] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def innermost(self, ts: Optional[float]) -> Optional[int]:
        """The innermost span holding `ts`: the last one started by then,
        or the nearest of its ancestors that was still open."""
        if ts is None:
            return None
        i = bisect.bisect_right(self.start, ts) - 1
        while i is not None and i >= 0 and self.end[i] < ts:
            i = self.parent[i]
        return None if i is None or i < 0 else i


def reduce_spans(events: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Per-stage figures (:data:`FIELDS`) of the ``bench.window`` stretch
    (the first one, if several) of a Chrome trace's events."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if not win:
        raise ValueError("the trace has no bench.window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    sp = _Spans(xs)
    out: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: dict.fromkeys(FIELDS, 0))

    def clipped(i: int) -> float:
        return max(min(sp.end[i], w1) - max(sp.start[i], w0), 0.0)

    for i, name in enumerate(sp.name):
        if sp.start[i] < w1 and sp.end[i] > w0:
            d = clipped(i)
            out[name]["calls"] += 1
            out[name]["host_us"] += d
            out[name]["self_us"] += d
            p = sp.parent[i]
            if p is not None:
                out[sp.name[p]]["self_us"] -= d

    launch = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])

    def owner(corr) -> str:
        i = sp.innermost(launch.get(corr))
        return NO_SPAN if i is None else sp.name[i]

    dev = sorted((float(e["ts"]), float(e["dur"]),
                  e.get("args", {}).get("correlation")) for e in xs
                 if e.get("cat") in DEVICE_CATS
                 and w0 <= float(e["ts"]) <= w1)
    edge = w0
    for ts, dur, corr in dev:
        who = owner(corr)
        out[who]["device_us"] += dur
        if ts > edge:
            out[who]["idle_us"] += ts - edge
        edge = max(edge, min(ts + dur, w1))
    if w1 > edge:
        out[TAIL]["idle_us"] += w1 - edge
    return dict(out)


def in_seconds(spans: Dict[str, Dict[str, float]]) -> Dict[str, Dict]:
    """The figures with times in seconds (``host_s`` ...), the stages in
    falling ``host_us``."""
    order = sorted(spans, key=lambda n: (-spans[n]["host_us"], n))
    return {n: {f.replace("_us", "_s") if f != "calls" else f:
                (spans[n][f] if f == "calls" else spans[n][f] * 1e-6)
                for f in FIELDS} for n in order}


def idle_share(spans: Dict[str, Dict[str, float]], name: str
               ) -> Optional[float]:
    """`name`'s share of the stretch's device idle time (None without
    idle time)."""
    idle = sum(v["idle_us"] for v in spans.values())
    if idle <= 0:
        return None
    return spans.get(name, {}).get("idle_us", 0.0) / idle


def per_unit_ms(spans: Dict[str, Dict[str, float]], metric: str,
                counters: Dict) -> Optional[float]:
    """The :data:`PER_UNIT` metric `metric`: its stage's field in ms per
    traced unit; None without the stage or without traced units."""
    stage, field, units = PER_UNIT[metric]
    n = counters.get(units, 0)
    if not n or not spans.get(stage, {}).get("calls"):
        return None
    return spans[stage][field] / n / 1e3
