"""Workload trace generators (STREAM so far; see :mod:`.base`)."""
from repro_torch.workloads.base import (  # noqa: F401
    Stream, Workload, WorkloadTrace, lines_for_footprint, pages_for_lines,
)
