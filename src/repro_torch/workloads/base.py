"""Workload trace generators: the contract, and STREAM.

Every workload implements one contract (:class:`Workload`) with two
mirrored generators:

``device_trace``
    Torch ops producing the ``(addr, is_write[, tier])`` tensors directly on
    the simulation device — the batched engine
    (:mod:`repro_torch.core.engine`) stacks them there, never on the host.
``host_trace``
    The NumPy twin of the same sequence, and the parity oracle: the device
    and host traces must be element-for-element equal.

Only STREAM is ported so far; the other generators of the JAX package
(pointer chase, GUPS, hot/cold, KV decode, MoE streaming) come with ROADMAP
queue 1, item 5.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import stream as stream_mod
from repro_torch.core.machine import CPUModel
from repro_torch.core.numa import LINES_PER_PAGE
from repro_torch.core.spec import CACHELINE_BYTES


@dataclasses.dataclass(frozen=True)
class WorkloadTrace:
    """One generated trace: per-access address/write streams (+ tier).

    Attributes
    ----------
    addr : (N,) int32 tensor or array
        Window-relative cacheline indices (device tensor or host array).
    is_write : (N,) int32/bool tensor or array
        1/True for stores.
    n_pages : int
        Pages spanned by the address space — the domain a page-placement
        policy (:mod:`repro_torch.core.numa`) maps over.
    tier : (N,) int32, optional
        Per-access DRAM(0)/CXL(1) intent.  ``None`` means the placement
        policy decides (STREAM).
    """
    addr: object
    is_write: object
    n_pages: int
    tier: Optional[object] = None

    @property
    def n_accesses(self) -> int:
        return int(self.addr.shape[0])


class Workload:
    """Base class: a named, footprint-scalable trace generator.

    Subclasses are frozen dataclasses (hashable — they ride the
    :class:`repro_torch.core.engine.SweepSpec` ``workloads`` axis).

    Attributes
    ----------
    name : str
        Row label in sweep results.
    serial_deps : bool
        True when every access depends on the previous one: the timing
        model then collapses memory-level parallelism to 1 outstanding miss
        regardless of the CPU model.
    """
    name: str = "workload"
    serial_deps: bool = False

    def device_trace(self, footprint_bytes: int,
                     device=None) -> WorkloadTrace:
        """Generate the trace on `device` with torch ops."""
        raise NotImplementedError

    def host_trace(self, footprint_bytes: int) -> WorkloadTrace:
        """NumPy reference generator — the parity oracle."""
        raise NotImplementedError

    def cpu_for(self, cpu: CPUModel) -> CPUModel:
        """CPU model that times this workload (MLP=1 for dependent loads)."""
        if self.serial_deps and cpu.effective_mlp != 1:
            return dataclasses.replace(cpu, mlp=1)
        return cpu


@dataclasses.dataclass(frozen=True)
class Stream(Workload):
    """The four STREAM kernels (:mod:`repro_torch.core.stream`) under the
    workload contract; the engine's default axis entry.

    Parameters
    ----------
    kernel : str
        One of ``copy | scale | add | triad``.
    """
    kernel: str = "triad"

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"stream_{self.kernel}"

    def device_trace(self, footprint_bytes: int,
                     device=None) -> WorkloadTrace:
        layout = stream_mod.layout_for_footprint(footprint_bytes)
        addr, is_write = stream_mod.stream_trace(self.kernel, layout, device)
        return WorkloadTrace(addr=addr, is_write=is_write,
                             n_pages=layout.n_pages)

    def host_trace(self, footprint_bytes: int) -> WorkloadTrace:
        layout = stream_mod.layout_for_footprint(footprint_bytes)
        reads, write = stream_mod._PATTERN[self.kernel]
        n = layout.n_elems
        line = np.arange(n, dtype=np.int32) // stream_mod.ELEMS_PER_LINE
        cols = [np.int32(layout.base_line(r)) + line for r in reads]
        cols.append(np.int32(layout.base_line(write)) + line)
        addr = np.stack(cols, axis=1).reshape(-1)
        is_write = np.tile(
            np.asarray([0] * len(reads) + [1], np.int32), n)
        return WorkloadTrace(addr=addr, is_write=is_write,
                             n_pages=layout.n_pages)


def lines_for_footprint(footprint_bytes: int) -> int:
    """Cachelines covering a footprint (floor, >= 2)."""
    return max(footprint_bytes // CACHELINE_BYTES, 2)


def pages_for_lines(n_lines: int) -> int:
    """4 KiB pages covering `n_lines` cachelines (ceil, >= 1)."""
    return max(-(-n_lines // LINES_PER_PAGE), 1)
