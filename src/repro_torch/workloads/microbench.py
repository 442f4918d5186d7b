"""Latency/locality microbenchmark generators: pointer chase, GUPS,
hot/cold.

``pointer_chase`` is the paper's idle-latency and cache-pollution probe:
a dependent-load walk over a permuted ring of cachelines.  Each access's
address is the previous access's "pointee", so memory-level parallelism
collapses to one outstanding miss (``serial_deps``).

``gups`` is the HPCC RandomAccess kernel: a seeded random
read-modify-write stream over a power-of-two table.

``hot_cold`` drives the dynamic tierer: a skewed-popularity random stream
where a small, scattered set of hot pages receives most of the accesses —
the page-popularity shape TPP-style promotion exploits
(:mod:`repro_torch.core.tiering_dyn`).

Each generator builds its trace on the simulation device with torch ops
(:meth:`device_trace`) and on the host with NumPy (:meth:`host_trace`);
the two are element-for-element equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.numa import LINES_PER_PAGE
from repro_torch.workloads.base import (Workload, WorkloadTrace,
                                        full_period_affine,
                                        lines_for_footprint, mix32,
                                        pages_for_lines)


def _affine_orbit(length: int, a: int, c: int, p0: int, n: int,
                  device=None) -> torch.Tensor:
    """``[p0, f(p0), f(f(p0)), ...]`` (`length` terms) of
    ``f(x) = (a*x + c) mod n``, by doubling.

    Each round applies ``f^L`` (kept as the affine pair ``(A, C)``) to the
    ``L`` terms known so far, doubling them, then squares the map.  Every
    operand is below ``n < 2**31``, so each int64 product stays below
    ``2**62``.  ``log2(length)`` rounds of vector work replace the
    dependent loop of ``length`` steps.
    """
    orbit = torch.tensor([p0], dtype=torch.int64, device=device)
    big_a, big_c = a % n, c % n
    while orbit.shape[0] < length:
        orbit = torch.cat([orbit, (orbit * big_a + big_c) % n])
        big_a, big_c = (big_a * big_a) % n, (big_a * big_c + big_c) % n
    return orbit[:length].to(torch.int32)


@dataclasses.dataclass(frozen=True)
class PointerChase(Workload):
    """Dependent loads over a full-period permuted ring of cachelines.

    The ring is ``pos -> (a*pos + c) mod n`` with Hull–Dobell full-period
    parameters (:func:`~repro_torch.workloads.base.full_period_affine`), so
    one lap of ``n`` hops touches every line of the footprint once in a
    scrambled order.  All accesses are reads; ``serial_deps`` collapses
    MLP to 1.

    Parameters
    ----------
    seed : int
        Selects the ring increment and start position.
    hops_per_line : int
        Laps over the ring; the trace has ``hops_per_line * n_lines``
        accesses.
    """
    seed: int = 0
    hops_per_line: int = 2

    name = "pointer_chase"
    serial_deps = True

    def _ring(self, footprint_bytes: int):
        n = lines_for_footprint(footprint_bytes)
        return (n,) + full_period_affine(n, self.seed)

    def device_trace(self, footprint_bytes: int,
                     device=None) -> WorkloadTrace:
        n, a, c, p0 = self._ring(footprint_bytes)
        addr = _affine_orbit(self.hops_per_line * n, a, c, p0, n, device)
        return WorkloadTrace(addr=addr, is_write=torch.zeros_like(addr),
                             n_pages=pages_for_lines(n))

    def host_trace(self, footprint_bytes: int) -> WorkloadTrace:
        n, a, c, p0 = self._ring(footprint_bytes)
        h = self.hops_per_line * n
        addr = np.empty(h, np.int32)
        pos = p0
        for t in range(h):
            addr[t] = pos
            pos = (pos * a + c) % n
        return WorkloadTrace(addr=addr, is_write=np.zeros(h, np.int32),
                             n_pages=pages_for_lines(n))


@dataclasses.dataclass(frozen=True)
class Gups(Workload):
    """Seeded random update (HPCC RandomAccess / GUPS).

    Each update hashes its counter through :func:`~repro_torch.workloads.
    base.mix32` to a slot of a power-of-two table and issues a read
    followed by a write of the same line.  The table is the largest power
    of two of lines fitting the footprint.

    Parameters
    ----------
    seed : int
        Hash stream selector; same seed => bitwise-identical trace.
    updates_per_line : int
        Trace has ``updates_per_line * table_lines`` updates (2 accesses
        each).
    """
    seed: int = 1
    updates_per_line: int = 2

    name = "gups"

    def _table(self, footprint_bytes: int) -> int:
        return 1 << (lines_for_footprint(footprint_bytes).bit_length() - 1)

    def device_trace(self, footprint_bytes: int,
                     device=None) -> WorkloadTrace:
        table = self._table(footprint_bytes)
        u = self.updates_per_line * table
        idx = mix32(torch.arange(u, device=device), self.seed)
        idx = (idx & (table - 1)).to(torch.int32)
        addr = torch.stack([idx, idx], dim=1).reshape(-1)
        is_write = torch.tensor([0, 1], dtype=torch.int32,
                                device=device).repeat(u)
        return WorkloadTrace(addr=addr, is_write=is_write,
                             n_pages=pages_for_lines(table))

    def host_trace(self, footprint_bytes: int) -> WorkloadTrace:
        table = self._table(footprint_bytes)
        u = self.updates_per_line * table
        idx = mix32(np.arange(u, dtype=np.uint32), self.seed)
        idx = (idx & np.uint32(table - 1)).astype(np.int32)
        addr = np.stack([idx, idx], axis=1).reshape(-1)
        is_write = np.tile(np.asarray([0, 1], np.int32), u)
        return WorkloadTrace(addr=addr, is_write=is_write,
                             n_pages=pages_for_lines(table))


@dataclasses.dataclass(frozen=True)
class HotCold(Workload):
    """Skewed-popularity random access: a hot page set soaks the traffic.

    A fraction ``hot_page_frac`` of the footprint's pages, scattered evenly
    across the address space, receives ``hot_access_frac`` of all
    accesses; the rest are uniform over the whole footprint.  Page
    popularity is stationary, the regime an epoch-based dynamic tierer
    converges on.  About a quarter of the accesses are writes.

    Parameters
    ----------
    seed : int
        Hash stream selector.
    hot_page_frac : float
        Fraction of the footprint's pages in the hot set (>= 1 page).
    hot_access_frac : float
        Fraction of accesses directed at the hot set.
    accesses_per_line : int
        Trace has ``accesses_per_line * n_lines`` accesses.
    """
    seed: int = 5
    hot_page_frac: float = 0.125
    hot_access_frac: float = 0.9
    accesses_per_line: int = 4

    name = "hot_cold"

    def _shape(self, footprint_bytes: int):
        n_lines = lines_for_footprint(footprint_bytes)
        n_pages = pages_for_lines(n_lines)
        n_hot = max(1, int(n_pages * self.hot_page_frac))
        stride = max(n_pages // n_hot, 1)    # evenly scattered hot pages
        return (n_lines, n_pages, n_hot, stride,
                self.accesses_per_line * n_lines,
                int(self.hot_access_frac * 1024))

    def device_trace(self, footprint_bytes: int,
                     device=None) -> WorkloadTrace:
        n_lines, n_pages, n_hot, stride, n_acc, hot_1024 = \
            self._shape(footprint_bytes)
        hot_pages = (torch.arange(n_hot, dtype=torch.int64, device=device)
                     * stride + stride // 2) % n_pages
        ctr = torch.arange(n_acc, device=device)
        gate = mix32(ctr, self.seed)
        pick = mix32(ctr, self.seed ^ 0x9E3779B9)
        off = mix32(ctr, self.seed ^ 0x7F4A7C15)
        to_hot = (gate % 1024) < hot_1024
        hot_line = (hot_pages[pick % n_hot] * LINES_PER_PAGE
                    + off % LINES_PER_PAGE)
        cold_line = pick % n_lines
        addr = torch.where(to_hot, hot_line, cold_line) \
            .clamp(0, n_lines - 1).to(torch.int32)
        is_write = ((off >> 8) % 4 == 0).to(torch.int32)
        return WorkloadTrace(addr=addr, is_write=is_write, n_pages=n_pages)

    def host_trace(self, footprint_bytes: int) -> WorkloadTrace:
        n_lines, n_pages, n_hot, stride, n_acc, hot_1024 = \
            self._shape(footprint_bytes)
        hot_pages = (np.arange(n_hot, dtype=np.int32) * stride
                     + stride // 2) % n_pages
        ctr = np.arange(n_acc, dtype=np.uint32)
        gate = mix32(ctr, self.seed)
        pick = mix32(ctr, self.seed ^ 0x9E3779B9)
        off = mix32(ctr, self.seed ^ 0x7F4A7C15)
        to_hot = (gate % np.uint32(1024)) < np.uint32(hot_1024)
        hot_line = (hot_pages[(pick % np.uint32(n_hot)).astype(np.int32)]
                    * np.int32(LINES_PER_PAGE)
                    + (off % np.uint32(LINES_PER_PAGE)).astype(np.int32))
        cold_line = (pick % np.uint32(n_lines)).astype(np.int32)
        addr = np.clip(np.where(to_hot, hot_line, cold_line),
                       0, n_lines - 1).astype(np.int32)
        is_write = ((off >> np.uint32(8)) % np.uint32(4) == 0) \
            .astype(np.int32)
        return WorkloadTrace(addr=addr, is_write=is_write, n_pages=n_pages)
