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

The stochastic generators draw every random number from :func:`mix32`, a
32-bit avalanche hash of the access counter.  Its torch form computes in
int64 and keeps the low 32 bits after every step (the CPU build of torch
has no uint32 shift or remainder); its NumPy form is the uint32
recurrence of the JAX package.  Same seed, same trace, on every device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import stream as stream_mod
from repro_torch.core.machine import CPUModel
from repro_torch.core.numa import LINES_PER_PAGE
from repro_torch.core.spec import CACHELINE_BYTES


_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Shared integer recurrences
# ---------------------------------------------------------------------------
def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``(x * k) mod 2**32`` for int64 `x` in [0, 2**32), without overflow.

    The constant is split in 16-bit halves, so no partial product reaches
    2**48 and nothing relies on how signed int64 overflow wraps.
    """
    lo = x * (k & 0xFFFF)
    hi = ((x * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def mix32(x, seed: int):
    """SplitMix-style 32-bit avalanche hash (the JAX package's ``mix32``).

    Parameters
    ----------
    x : torch.Tensor or numpy array of non-negative ints
        Counter values to hash.  A tensor is hashed in int64 on its own
        device; a NumPy array in uint32 (the host twin).
    seed : int
        Stream selector, folded in before the first round.

    Returns
    -------
    int64 tensor, or uint32 array, of values in [0, 2**32)
        Bitwise equal between the two forms.
    """
    if isinstance(x, torch.Tensor):
        x = (x.to(torch.int64) & _MASK32) ^ (seed & _MASK32)
        x = _mul32(x, 0x9E3779B1)
        x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
        x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
        return x ^ (x >> 16)
    x = np.asarray(x, np.uint32)
    x = (x ^ np.uint32(seed & _MASK32)) * np.uint32(0x9E3779B1)
    x = (x ^ (x >> 16)) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> 13)) * np.uint32(0xC2B2AE35)
    return x ^ (x >> 16)


def mix32_int(x: int) -> int:
    """Scalar Python-int twin of :func:`mix32` (parameter derivation)."""
    x &= _MASK32
    x = (x * 0x9E3779B1) & _MASK32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _MASK32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _MASK32
    return x ^ (x >> 16)


def full_period_affine(n: int, seed: int) -> Tuple[int, int, int]:
    """Parameters of a full-period affine ring ``pos -> (a*pos + c) mod n``.

    Satisfies the Hull–Dobell theorem for any ``n >= 2``: ``a - 1`` is
    divisible by every prime factor of ``n`` (and by 4 when ``4 | n``) and
    ``gcd(c, n) == 1``, so iterating the map from any start visits every
    residue exactly once per lap.  This is the permuted ring the
    pointer-chase workload walks.

    Returns
    -------
    (a, c, p0) : tuple of int
        Multiplier, increment and start position, all in ``[0, n)``.
    """
    if n < 2:
        raise ValueError(f"ring needs >= 2 lines, got {n}")
    x, d, m = n, 2, 1
    while d * d <= x:
        if x % d == 0:
            m *= d
            while x % d == 0:
                x //= d
        d += 1
    if x > 1:
        m *= x
    if n % 4 == 0 and m % 4 != 0:
        m *= 2
    a = (m + 1) % n
    c = mix32_int(seed) % n
    while math.gcd(c, n) != 1:
        c = (c + 1) % n
    p0 = mix32_int(seed ^ 0x5BF03635) % n
    if a * (n - 1) + c >= 2 ** 31:
        raise ValueError(f"ring of {n} lines overflows int32 chase "
                         f"arithmetic (a={a})")
    return a, c, p0


# ---------------------------------------------------------------------------
# The workload contract
# ---------------------------------------------------------------------------
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
