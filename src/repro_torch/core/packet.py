"""CXL.mem transaction-layer packetization and de-packetization.

The port of ``repro.core.packet``.  The paper (Fig. 4) implements the
CXL.mem transaction layer with packetization at the Root Complex and
de-packetization at the CXL endpoint, carrying opcodes in packet headers
over four channels:

    M2S Req   - memory reads (CPU loads)            -> S2M DRS (MemData)
    M2S RwD   - memory writes (CPU stores, +64B)    -> S2M NDR (Cmp)

A batch of N requests packs into an ``(N, n_words)`` header array of
32-bit words through a generic little-endian bit-field codec driven by
:data:`repro_torch.core.spec.M2S_FIELDS` / :data:`~repro_torch.core.spec.
S2M_FIELDS`, on the device of the inputs.  The reference's words are
uint32; PyTorch's CPU build has no uint32 shift, so each word here is an
int64 holding the same 32 bits (0 <= word < 2**32), and the headers equal
the reference's bit for bit.

Address convention: the 46-bit ``address`` slot carries a cacheline index
(host physical address >> 6) that fits in 32 bits; trace-relative int32
line indices cover windows of 2**31 lines.

Wire accounting follows the 68-byte CXL 2.0 flit: four 16-byte slots plus
4 bytes of framing and CRC.  A header message occupies one slot, a 64-byte
data payload four; in a saturated stream slots of different messages
share flits, so wire bytes = slots x 17.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.core import spec

_WORD_BITS = 32
_MASK32 = 0xFFFFFFFF
_WORD = torch.int64             # a uint32 word, held in the low 32 bits


def _mask(width: int) -> int:
    """Bit mask of `width` low bits (width <= 32)."""
    return _MASK32 if width >= 32 else (1 << width) - 1


def _word(v, n: int, device) -> torch.Tensor:
    """`v` (a scalar or an (N,) array) as (N,) words, wrapped to 32 bits
    as the reference's ``astype(uint32)`` wraps."""
    t = torch.as_tensor(v, device=device).to(_WORD)
    return (t.expand(n) if t.ndim == 0 else t) & _MASK32


@dataclasses.dataclass(frozen=True)
class FieldCodec:
    """Generic little-endian bit-field codec over 32-bit words.

    Fields wider than 32 bits occupy word-spanning bit ranges, but the
    values supplied for them must fit in 32 bits (see the module
    docstring: the 46-bit address slot carries <= 31-bit line indices).
    """

    fields: Tuple[Tuple[str, int], ...]

    @property
    def total_bits(self) -> int:
        return sum(w for _, w in self.fields)

    @property
    def n_words(self) -> int:
        return -(-self.total_bits // _WORD_BITS)

    def offsets(self) -> Dict[str, Tuple[int, int]]:
        """{name: (bit_offset, width)} in packing order."""
        out, off = {}, 0
        for name, width in self.fields:
            out[name] = (off, width)
            off += width
        return out

    def pack(self, values: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Pack {field: (N,) integer tensor} -> (N, n_words) words."""
        names = {n for n, _ in self.fields}
        unknown = set(values) - names
        if unknown:
            raise KeyError(f"unknown fields: {sorted(unknown)}")
        if not values:
            raise ValueError("at least one field value required")
        first = torch.as_tensor(next(iter(values.values())))
        n, device = first.shape[0], first.device
        words = [torch.zeros((n,), dtype=_WORD, device=device)
                 for _ in range(self.n_words)]
        off = 0
        for name, width in self.fields:
            v = values.get(name)
            if v is None:
                off += width
                continue
            v = _word(v, n, device) & _mask(min(width, 32))
            w0, b0 = divmod(off, _WORD_BITS)
            # low part into word w0
            words[w0] = words[w0] | ((v << b0) & _MASK32)
            # spill into word w0 + 1 if the value-bearing bits cross
            if b0 + min(width, 32) > _WORD_BITS:
                words[w0 + 1] = words[w0 + 1] | (v >> (_WORD_BITS - b0))
            off += width
        return torch.stack(words, dim=-1)

    def unpack(self, packed: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(N, n_words) words -> {field: (N,) values in [0, 2**32)}."""
        packed = torch.as_tensor(packed).to(_WORD) & _MASK32
        out: Dict[str, torch.Tensor] = {}
        off = 0
        for name, width in self.fields:
            w0, b0 = divmod(off, _WORD_BITS)
            take = min(width, 32)
            v = packed[..., w0] >> b0
            if b0 + take > _WORD_BITS:
                v = v | (packed[..., w0 + 1] << (_WORD_BITS - b0))
            out[name] = v & _mask(take)
            off += width
        return out


M2S_CODEC = FieldCodec(spec.M2S_FIELDS)
S2M_CODEC = FieldCodec(spec.S2M_FIELDS)

# Channel encodings used in the `channel` field.
CH_M2S_REQ = 0
CH_M2S_RWD = 1
CH_S2M_NDR = 0
CH_S2M_DRS = 1

# Wire accounting (slots; 1 slot = 17 wire bytes in a saturated stream).
SLOT_WIRE_BYTES = spec.FLIT_BYTES_CXL2 // 4  # 17
SLOTS_HEADER = 1
SLOTS_DATA = 4


def _legal(opcode: torch.Tensor, table) -> torch.Tensor:
    return torch.isin(opcode, torch.tensor([int(o) for o in table],
                                           dtype=_WORD,
                                           device=opcode.device))


def _slots_and_bytes(slots: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"slots": slots.to(torch.int32),
            "wire_bytes": (slots.sum() * SLOT_WIRE_BYTES).to(torch.int32)}


# ---------------------------------------------------------------------------
# Root-complex side (the "master"): packetize CPU requests into M2S flits.
# ---------------------------------------------------------------------------
def rc_packetize(line_addr, is_write, tags=None,
                 ld_id=0) -> Dict[str, torch.Tensor]:
    """Packetize a batch of CPU memory requests into M2S headers, on the
    device of `line_addr`.

    Args:
      line_addr: (N,) int32 cacheline indices.
      is_write:  (N,) bool: True => M2S RwD MemWr, False => M2S Req MemRd.
      tags:      (N,) request tags; defaults to arange (matching completion).
      ld_id:     logical-device id (for MLDs; SLD => 0), or (N,) ids.

    Returns a dict with:
      headers:     (N, W) packed M2S header words.
      slots:       (N,) int32 wire slots per message (1 read / 5 write).
      wire_bytes:  () int32 total M2S wire bytes (slots x 17).
    """
    line_addr = torch.as_tensor(line_addr)
    device = line_addr.device
    is_write = torch.as_tensor(is_write, device=device).to(torch.bool)
    n = line_addr.shape[0]
    if tags is None:
        tags = torch.arange(n, dtype=_WORD, device=device) & 0xFFFF

    def full(value):
        return torch.full((n,), int(value), dtype=_WORD, device=device)

    headers = M2S_CODEC.pack({
        "valid": full(1),
        "channel": torch.where(is_write, CH_M2S_RWD, CH_M2S_REQ),
        "opcode": torch.where(is_write, int(spec.M2SRwD.MEM_WR),
                              int(spec.M2SReq.MEM_RD)),
        "meta_field": full(spec.MetaField.ANY),
        "meta_value": full(0),
        "snp_type": full(spec.SnpType.NO_OP),
        "tag": tags,
        "address": line_addr,
        "ld_id": ld_id,
        "tc": full(0),
    })
    slots = torch.where(is_write, SLOTS_HEADER + SLOTS_DATA, SLOTS_HEADER)
    return {"headers": headers, **_slots_and_bytes(slots)}


# ---------------------------------------------------------------------------
# Endpoint side (the "subordinate"): de-packetize M2S, emit S2M responses.
# ---------------------------------------------------------------------------
def ep_depacketize(headers: torch.Tensor) -> Dict[str, torch.Tensor]:
    """De-packetize M2S headers at the endpoint.

    Returns the decoded fields plus:
      is_write: (N,) bool
      legal:    (N,) bool: the opcode is legal for its channel per the
                spec's tables.
    """
    f = M2S_CODEC.unpack(headers)
    is_rwd = f["channel"] == CH_M2S_RWD
    legal = (f["valid"] == 1) & torch.where(
        is_rwd, _legal(f["opcode"], spec.M2SRwD),
        _legal(f["opcode"], spec.M2SReq))
    return {**f, "is_write": is_rwd, "legal": legal}


def ep_respond(headers: torch.Tensor, *,
               dev_load=int(spec.DevLoad.LIGHT),
               nxm=None) -> Dict[str, torch.Tensor]:
    """Generate S2M responses for a batch of decoded M2S requests.

    Writes  -> S2M NDR  Cmp        (1 slot)
    Reads   -> S2M DRS  MemData    (1 + 4 slots)   [MemDataNXM if `nxm`]
    """
    req = ep_depacketize(headers)
    n = req["tag"].shape[0]
    device = req["tag"].device
    nxm = (torch.zeros((n,), dtype=torch.bool, device=device) if nxm is None
           else torch.as_tensor(nxm, device=device).to(torch.bool))
    channel = torch.where(req["is_write"], CH_S2M_NDR, CH_S2M_DRS)
    opcode = torch.where(
        req["is_write"], int(spec.S2MNDR.CMP),
        torch.where(nxm, int(spec.S2MDRS.MEM_DATA_NXM),
                    int(spec.S2MDRS.MEM_DATA)))
    resp = S2M_CODEC.pack({
        "valid": req["valid"],
        "channel": channel,
        "opcode": opcode,
        "meta_field": req["meta_field"],
        "meta_value": req["meta_value"],
        "tag": req["tag"],
        "ld_id": req["ld_id"],
        "dev_load": dev_load,
        "poison": nxm,
    })
    slots = torch.where(req["is_write"], SLOTS_HEADER,
                        SLOTS_HEADER + SLOTS_DATA)
    return {"headers": resp, **_slots_and_bytes(slots)}


def rc_complete(s2m_headers: torch.Tensor) -> Dict[str, torch.Tensor]:
    """De-packetize S2M responses at the root complex (host completion)."""
    f = S2M_CODEC.unpack(s2m_headers)
    is_drs = f["channel"] == CH_S2M_DRS
    legal = (f["valid"] == 1) & torch.where(
        is_drs, _legal(f["opcode"], spec.S2MDRS),
        _legal(f["opcode"], spec.S2MNDR))
    return {**f, "is_read_data": is_drs, "legal": legal}


def roundtrip_wire_bytes(n_reads: int, n_writes: int) -> Tuple[int, int]:
    """Closed-form wire bytes (m2s, s2m) for a read/write mix, with which
    the timing model prices CXL.mem traffic without materializing
    packets."""
    m2s = n_reads * SLOTS_HEADER + n_writes * (SLOTS_HEADER + SLOTS_DATA)
    s2m = n_reads * (SLOTS_HEADER + SLOTS_DATA) + n_writes * SLOTS_HEADER
    return m2s * SLOT_WIRE_BYTES, s2m * SLOT_WIRE_BYTES
