"""Spans at the stage boundaries of a sweep and of a serve, on the torch
profiler's timeline.

``with span("engine.build"): ...`` marks a stage.  While a
``torch.profiler.profile`` records, the span is a
``torch.profiler.record_function`` range named ``repro_torch.<name>``
(``repro_torch.<name>#<id>`` for one request's span), so it sits beside
the device operations it launched, on the profiler's clock; the span that
caused it is the one it nests in.  The profiler keeps the ranges in memory
and writes them out with its trace.  Otherwise a span is one check of
``torch.autograd._profiler_enabled()`` and a shared do-nothing context:
nothing is allocated, no clock is read.

    with torch.profiler.profile() as prof:
        serve.run(cfg)
    prof.export_chrome_trace("serve.json")     # open in Perfetto

:data:`SPANS` names every span the package opens.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

PREFIX = "repro_torch."

SPANS = (
    "sweep",               # core/simulator.py CXLRAMSim.sweep, the root
    "engine.build",        # the trace build, routing and stacking
    "engine.traces",       # each workload's trace, generated on the device
    "engine.simulate",     # K1 or K3 launched, the host's wait for its stats
    "machine.time_batch",  # the timing fixed point (host NumPy f64)
    "engine.rows",         # the result rows assembled
    "serve.prefill",       # one request's prefill (#<sid>)
    "serve.step",          # one decode step of the batch, the root
    "kv.gather_args",      # block tables walked, CXL charged, uploaded
    "serve.pool_cast",     # the layer-0 pools cast to f32 for K4
    "serve.capture",       # a sequence's step captured as a CUDA graph
    "serve.model",         # a sequence's decode_step run or replayed (#<sid>)
    "serve.sample",        # the wait for its logits and the argmax (#<sid>)
    "kv.append_tokens",    # pages walked, evicted, the pools written
)

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


def span(name: str, id: Optional[int] = None):
    """The stage `name` (one of :data:`SPANS`), of request `id` when
    given, as a context manager."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(
        PREFIX + name + ("" if id is None else "#%d" % id))
