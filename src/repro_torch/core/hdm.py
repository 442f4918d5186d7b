"""HDM (Host-managed Device Memory) decoder address math.

An HDM decoder maps a host-physical-address (HPA) window onto `ways`
interleaved targets at a fixed granularity:

    off  = hpa - base
    way  = (off // granularity) mod ways          -> which target device
    dpa  = (off // (granularity*ways)) * granularity + off mod granularity

This is the CXL 2.0 §8.2.5.12 decode (including the non-power-of-two
3/6/12-way modes), in pure-Python ints (arbitrary precision) for
topology/enumeration on full 64-bit addresses, and vectorized over tensors
of window-relative cacheline indices (:meth:`InterleaveProgram.
decode_lines`) for per-access routing on the device.
:func:`weighted_page_policy` is the vectorized OS page-interleave rule the
placement policies of :mod:`repro_torch.core.numa` apply to page indices.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.spec import CACHELINE_BYTES


@dataclasses.dataclass(frozen=True)
class InterleaveProgram:
    """Static decode program of one committed HDM decoder."""
    base: int                 # bytes, host physical
    size: int                 # bytes
    ways: int
    granularity: int          # bytes per contiguous chunk on one target
    targets: Tuple[int, ...]  # global target (endpoint/region) ids

    def __post_init__(self):
        if len(self.targets) != self.ways:
            raise ValueError(
                f"targets ({len(self.targets)}) must match ways "
                f"({self.ways})")
        if self.granularity % CACHELINE_BYTES != 0:
            raise ValueError(
                f"granularity {self.granularity} must be a multiple of "
                f"{CACHELINE_BYTES}")
        if self.size % (self.granularity * self.ways) != 0:
            raise ValueError("window must hold whole interleave sets")

    def decode(self, hpa: int) -> Tuple[int, int]:
        """hpa -> (target_id, device-physical address)."""
        if not (self.base <= hpa < self.base + self.size):
            raise ValueError(f"hpa {hpa:#x} outside window")
        off = hpa - self.base
        way = (off // self.granularity) % self.ways
        dpa = ((off // (self.granularity * self.ways)) * self.granularity
               + off % self.granularity)
        return self.targets[way], dpa

    def encode(self, target_id: int, dpa: int) -> int:
        """(target, dpa) -> hpa. Inverse of :meth:`decode`."""
        way = self.targets.index(target_id)
        chunk, rem = divmod(dpa, self.granularity)
        off = (chunk * self.ways + way) * self.granularity + rem
        hpa = self.base + off
        if not (self.base <= hpa < self.base + self.size):
            raise ValueError("dpa outside device share of window")
        return hpa

    # -- vectorized (trace-relative line indices) ---------------------------
    def decode_lines(self, line_idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Vectorized decode over window-relative cacheline indices.

        Args:
          line_idx: (N,) integer cacheline indices relative to `base`.
        Returns:
          (way, dpa_line): each (N,) int32 on the device of `line_idx`.
          `way` indexes `self.targets`; `dpa_line` is the device-local
          cacheline index.
        """
        g_lines = self.granularity // CACHELINE_BYTES
        line_idx = line_idx.to(torch.int32)
        chunk = line_idx // g_lines
        way = chunk % self.ways
        dpa_line = (chunk // self.ways) * g_lines + line_idx % g_lines
        return way.to(torch.int32), dpa_line.to(torch.int32)

    def encode_lines(self, way: torch.Tensor,
                     dpa_line: torch.Tensor) -> torch.Tensor:
        """Vectorized inverse of :meth:`decode_lines`."""
        g_lines = self.granularity // CACHELINE_BYTES
        chunk, rem = dpa_line // g_lines, dpa_line % g_lines
        return ((chunk * self.ways + way) * g_lines + rem).to(torch.int32)


def traffic_split(program: InterleaveProgram,
                  line_idx: torch.Tensor) -> torch.Tensor:
    """Per-target request counts for a trace — the interleave balance
    statistic the paper's §IV sweep reports."""
    way, _ = program.decode_lines(line_idx)
    return torch.bincount(way, minlength=program.ways)


def weighted_page_policy(page_idx: torch.Tensor, dram_weight: int,
                         cxl_weight: int) -> torch.Tensor:
    """OS weighted page interleaving (DRAM:CXL = dram_weight:cxl_weight).

    Models Linux `numactl --weighted-interleave` page placement: pages are
    dealt round-robin in runs of `dram_weight` to node 0 (DRAM) then
    `cxl_weight` to node 1 (CXL).

    Returns (N,) int32 of {0: DRAM, 1: CXL} per page index, on the
    device of `page_idx`.
    """
    period = dram_weight + cxl_weight
    pos = page_idx.to(torch.int32) % period
    return (pos >= dram_weight).to(torch.int32)
