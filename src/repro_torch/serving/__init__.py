"""Continuous-batching serving over the tier-aware paged KV cache."""
from repro_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatcher, EngineStats, Request,
)
