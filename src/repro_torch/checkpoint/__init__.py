"""Checkpoints of tensor trees: atomic, asynchronous, keep-K."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointError, CheckpointManager,
)
