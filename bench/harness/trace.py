"""Device trace of a short sub-window, reduced to what the per-layer
readers need.

:class:`Profile` runs ``torch.profiler`` (host and CUDA activity) around a
stretch of the window marked by a ``bench.window`` range.  The benchmark's
own wrappers open ``bench.<layer>`` ranges around the program's entry
points; a device operation belongs to a range when the host call that
launched it (its runtime event, matched by correlation id) lies inside it.
The trace is exported as Chrome JSON into the process's temporary
directory, read once and deleted.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench.window"
NAME_CHARS = 160


class Summary:
    """What a traced sub-window holds.

    ``window_us``: the marked stretch's wall time; ``busy_us``: the union
    of device operations inside it; ``ops``: (name, duration us, range or
    None) per device operation; ``gaps``: (host op, us) per idle stretch.
    """

    def __init__(self, window_us: float, busy_us: float,
                 ops: List[Tuple[str, float, Optional[str]]],
                 gaps: List[Tuple[str, float]]):
        self.window_us, self.busy_us = window_us, busy_us
        self.ops, self.gaps = ops, gaps

    def device_us(self, in_range: Optional[str] = None,
                  outside: Tuple[str, ...] = ()) -> float:
        """Summed device time of the operations launched inside
        `in_range` (all when None), leaving out those inside `outside`."""
        return sum(d for _, d, r in self.ops
                   if (in_range is None or r == in_range)
                   and r not in outside)

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        by_op = collections.Counter()
        for name, d, _ in self.ops:
            by_op[name[:NAME_CHARS]] += d
        by_gap = collections.Counter()
        for name, d in self.gaps:
            by_gap[name[:NAME_CHARS]] += d
        return {"device_ops": [[n, us * 1e-6]
                               for n, us in by_op.most_common(top)],
                "idle_gaps": [[n, us * 1e-6]
                              for n, us in by_gap.most_common(top)]}


def _containing(starts, ends, names, ts) -> Optional[str]:
    """Innermost interval holding `ts` among nested ones sorted by start."""
    i = bisect.bisect_right(starts, ts) - 1
    while i >= 0:
        if ends[i] >= ts:
            return names[i]
        i -= 1
    return None


def reduce_trace(events: List[Dict]) -> Summary:
    """Reduce Chrome-trace events to a :class:`Summary` of the
    ``bench.window`` stretch (the first one, if several)."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    if not win:
        raise ValueError("the trace has no bench.window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    launch = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in xs
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("bench.")
                    and e["name"] != WINDOW)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in xs
                  if e.get("cat") in HOST_CATS and e["name"] != WINDOW)
    r_s, r_e, r_n = ([r[i] for r in ranges] for i in range(3))
    h_s, h_e, h_n = ([h[i] for h in host] for i in range(3))
    dev = sorted((float(e["ts"]), float(e["dur"]), e["name"],
                  e.get("args", {}).get("correlation")) for e in xs
                 if e.get("cat") in DEVICE_CATS
                 and w0 <= float(e["ts"]) <= w1)
    ops, gaps = [], []
    busy, edge = 0.0, w0
    for ts, dur, name, corr in dev:
        at = launch.get(corr)
        rng = None if at is None else _containing(r_s, r_e, r_n, at)
        ops.append((name, dur, rng))
        end = min(ts + dur, w1)
        if ts > edge:
            what = (None if at is None
                    else _containing(h_s, h_e, h_n, at))
            gaps.append((what or "(no host op)", ts - edge))
        busy += max(end - max(ts, edge), 0.0)
        edge = max(edge, end)
    if w1 > edge:
        gaps.append(("(after the last device operation)", w1 - edge))
    return Summary(w1 - w0, busy, ops, gaps)


class Profile:
    """``with Profile() as p: ...``; inside, ``with p.window(): ...``
    marks the stretch to reduce; ``p.summary`` after the block."""

    def __init__(self, device: torch.device):
        self.device = device
        self.summary: Optional[Summary] = None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = reduce_trace(events)

    def open_window(self):
        """Mark the start of the stretch to reduce (after a synchronize);
        returns the handle :meth:`close_window` takes."""
        self._sync()
        rf = torch.profiler.record_function(WINDOW)
        rf.__enter__()
        return rf

    def close_window(self, rf) -> None:
        self._sync()
        rf.__exit__(None, None, None)

    @contextlib.contextmanager
    def window(self):
        rf = self.open_window()
        try:
            yield
        finally:
            self.close_window(rf)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def ranged(fn, name: str, record=None):
    """`fn` inside a ``bench.<name>`` range; ``record(args, kwargs)`` is
    called first on every call when given."""
    label = f"bench.{name}"

    def wrapper(*args, **kwargs):
        if record is not None:
            record(args, kwargs)
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    wrapper.__wrapped__ = fn
    return wrapper
