"""STREAM micro-benchmark trace generation (paper §IV characterization).

The paper executes STREAM "with 2, 4, 6 and 8 times the size of L2 cache,
thereby maximizing stress on CXL memory" and sweeps OS page-interleaving
ratios.  We generate the exact element-granular address traces of the four
STREAM kernels over three arrays laid out contiguously (page-aligned), so
the cache simulator reproduces the compulsory/capacity miss structure and
the interleave policy maps each page to its tier:

    copy :  a[i] = b[i]                 (1R 1W)
    scale:  a[i] = s*b[i]               (1R 1W)
    add  :  c[i] = a[i] + b[i]          (2R 1W)
    triad:  a[i] = b[i] + s*c[i]        (2R 1W)

Traces are (line_addr int32, is_write bool) tensors built on the requested
device; element size 8 B (doubles), so each 64 B line serves 8 consecutive
elements — hits on the 7 trailing elements are real accesses in the trace,
exactly as the CPU would issue them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.numa import LINES_PER_PAGE
from repro_torch.core.spec import CACHELINE_BYTES

ELEM_BYTES = 8  # STREAM doubles
ELEMS_PER_LINE = CACHELINE_BYTES // ELEM_BYTES

KERNELS = ("copy", "scale", "add", "triad")
# (reads from, writes to) in array-slot terms: arrays are [a, b, c]
_PATTERN = {
    "copy": ((1,), 0),
    "scale": ((1,), 0),
    "add": ((0, 1), 2),
    "triad": ((1, 2), 0),
}


@dataclasses.dataclass(frozen=True)
class StreamLayout:
    """Three arrays, each `n_elems` doubles, page-aligned & contiguous."""
    n_elems: int

    @property
    def array_lines(self) -> int:
        lines = -(-self.n_elems * ELEM_BYTES // CACHELINE_BYTES)
        # page-align each array start
        return -(-lines // LINES_PER_PAGE) * LINES_PER_PAGE

    @property
    def footprint_bytes(self) -> int:
        return 3 * self.array_lines * CACHELINE_BYTES

    @property
    def n_pages(self) -> int:
        return 3 * self.array_lines // LINES_PER_PAGE

    def base_line(self, arr: int) -> int:
        return arr * self.array_lines


def layout_for_footprint(footprint_bytes: int) -> StreamLayout:
    """Layout whose 3-array footprint is ~`footprint_bytes` (>=, page rounded)."""
    n = footprint_bytes // (3 * ELEM_BYTES)
    return StreamLayout(n_elems=max(int(n), ELEMS_PER_LINE))


def stream_trace(kernel: str, layout: StreamLayout, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Element-granular (line_addr, is_write) trace of one kernel pass.

    Access order per element i: all reads, then the write — matching the
    load/store order the compiled STREAM loop issues.  Built on `device`.
    """
    if kernel not in _PATTERN:
        raise ValueError(f"unknown STREAM kernel {kernel!r}")
    reads, write = _PATTERN[kernel]
    n = layout.n_elems
    line_in_array = (torch.arange(n, dtype=torch.int32, device=device)
                     // ELEMS_PER_LINE)
    cols = [layout.base_line(r) + line_in_array for r in reads]
    cols.append(layout.base_line(write) + line_in_array)
    addr = torch.stack(cols, dim=1).reshape(-1)               # (n*ops,)
    pattern = torch.tensor([False] * len(reads) + [True], device=device)
    return addr, pattern.repeat(n)


def stream_bytes(kernel: str, layout: StreamLayout) -> Dict[str, int]:
    """Nominal STREAM-reported bytes (the benchmark's own accounting)."""
    reads, _ = _PATTERN[kernel]
    n = layout.n_elems * ELEM_BYTES
    return {"read_bytes": len(reads) * n, "write_bytes": n,
            "total_bytes": (len(reads) + 1) * n}
