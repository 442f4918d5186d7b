"""Optimizer: AdamW and the int8 error-feedback gradient codec."""
from repro_torch.optim.adamw import (AdamWConfig, OptState,  # noqa: F401
                                     init, lr_at, update)
