"""CXL.mem wire accounting: the slot costs the timing model prices.

Only the three constants :mod:`repro_torch.core.timing` needs to turn flit
geometry into payload bandwidth live here so far.  A 68-byte CXL 2.0 flit
carries four 16-byte slots plus CRC; in a saturated stream slots from
different messages share flits, so one slot costs 17 wire bytes.  A header
takes one slot and a 64-byte cacheline of data four.
"""
from __future__ import annotations

from repro_torch.core import spec

# Wire accounting (slots; 1 slot = 17 wire bytes in a saturated stream).
SLOT_WIRE_BYTES = spec.FLIT_BYTES_CXL2 // 4  # 17
SLOTS_HEADER = 1
SLOTS_DATA = 4
