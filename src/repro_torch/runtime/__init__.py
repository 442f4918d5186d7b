"""Fleet bookkeeping shared by the sweep executors (host eviction)."""
from repro_torch.runtime.fault import FleetState, WorkerFailure  # noqa: F401
