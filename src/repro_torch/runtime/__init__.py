"""Training runtime (restart, stragglers) and the fleet bookkeeping the
sweep executors share."""
from repro_torch.runtime.fault import (FleetState,  # noqa: F401
                                       RuntimeConfig, TrainingRuntime,
                                       WorkerFailure)
