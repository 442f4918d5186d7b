"""Deterministic synthetic training data."""
from repro_torch.data.pipeline import (DataConfig,  # noqa: F401
                                       batch_at_step, iterate)
