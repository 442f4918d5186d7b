"""CXL 2.0/3.0 protocol constants and register layouts.

This module is the single source of truth for the protocol-level numbers the
rest of the simulator uses: CXL.mem opcodes (M2S / S2M channels), flit
geometry (68-byte flit of CXL 1.1/2.0 over PCIe 5.0, 256-byte flit of CXL
3.x), DVSEC / capability IDs, and HDM decoder encoding rules.

Everything here mirrors the public CXL specification fields that the paper's
register model (Fig. 3) names: DVSEC GPF / Flexbus / Port / Register Locator
for the root complex (Set 1); Link / RAS / SEC / Component / HDM decoder
registers for the host bridge (Set 2); Mailbox / Status registers for the
endpoint (Set 3).
"""
from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Flit geometry
# ---------------------------------------------------------------------------
# CXL 1.1/2.0: 528-bit protocol flit = 4 x 16B slots + 2B CRC  -> 68 bytes on
# the wire carrying at most 64B of data payload (one cacheline) plus header.
FLIT_BYTES_CXL2 = 68
FLIT_PAYLOAD_BYTES_CXL2 = 64
# CXL 3.x (PCIe 6.0 PAM4): 256B flit, 238B usable slots (we model 240 for the
# simple all-data case the spec calls out).
FLIT_BYTES_CXL3 = 256
FLIT_PAYLOAD_BYTES_CXL3 = 238

CACHELINE_BYTES = 64

# PCIe physical-layer raw bandwidth per lane per direction (GB/s), before
# flit/packet overheads (overheads are applied by core.timing).
PCIE_GEN_GBPS_PER_LANE = {
    4: 1.969,   # 16 GT/s, 128/130b
    5: 3.938,   # 32 GT/s, 128/130b
    6: 7.563,   # 64 GT/s, PAM4 FLIT
}


class CXLVersion(enum.IntEnum):
    CXL_1_1 = 11
    CXL_2_0 = 20
    CXL_3_0 = 30


def flit_bytes(version: CXLVersion) -> int:
    return FLIT_BYTES_CXL3 if version >= CXLVersion.CXL_3_0 else FLIT_BYTES_CXL2


def flit_payload_bytes(version: CXLVersion) -> int:
    return (FLIT_PAYLOAD_BYTES_CXL3 if version >= CXLVersion.CXL_3_0
            else FLIT_PAYLOAD_BYTES_CXL2)


def wire_efficiency(version: CXLVersion) -> float:
    """Payload bytes per wire byte for an all-data stream."""
    return flit_payload_bytes(version) / flit_bytes(version)


# ---------------------------------------------------------------------------
# CXL.mem opcodes — Transaction layer, M2S (master-to-subordinate) and S2M.
# Values follow the spec's MemOpcode encodings for the Req / RwD / NDR / DRS
# message classes the paper implements (Section III-B.2).
# ---------------------------------------------------------------------------
class M2SReq(enum.IntEnum):
    """M2S Request channel (no data): reads & metadata ops."""
    MEM_INV = 0b0000          # invalidate (metadata only)
    MEM_RD = 0b0001           # memory read        <- CPU load requests
    MEM_RD_DATA = 0b0010      # read, no current data needed
    MEM_RD_FWD = 0b0011
    MEM_WR_FWD = 0b0100
    MEM_SPEC_RD = 0b1000      # speculative read (latency hiding)
    MEM_INV_NT = 0b1001


class M2SRwD(enum.IntEnum):
    """M2S Request-with-Data channel: writes."""
    MEM_WR = 0b0001           # memory write       <- CPU store requests
    MEM_WR_PTL = 0b0010       # partial (byte-enabled) write


class S2MNDR(enum.IntEnum):
    """S2M No-Data-Response channel: write completions."""
    CMP = 0b000               # completion         -> store globally observed
    CMP_S = 0b001             # completion, shared
    CMP_E = 0b010             # completion, exclusive
    BI_CONFLICT_ACK = 0b100


class S2MDRS(enum.IntEnum):
    """S2M Data-Response channel: read data."""
    MEM_DATA = 0b000          # read data          -> load completion
    MEM_DATA_NXM = 0b001      # non-existent-memory poison response


class MetaField(enum.IntEnum):
    """2-bit MetaValue used for coherence state hints (Meta0-State)."""
    INVALID = 0b00
    ANY = 0b10
    SHARED = 0b11


class SnpType(enum.IntEnum):
    NO_OP = 0b000
    SNP_DATA = 0b001
    SNP_CUR = 0b010
    SNP_INV = 0b011


# Packed header field widths (bits) for our M2S/S2M codecs (packet.py).
# Mirrors the spec's field inventory; widths chosen to cover the spec ranges.
M2S_FIELDS = (
    ("valid", 1),
    ("channel", 2),      # 0=Req, 1=RwD
    ("opcode", 4),
    ("meta_field", 2),
    ("meta_value", 2),
    ("snp_type", 3),
    ("tag", 16),
    ("address", 46),     # cacheline address (bits 51:6)
    ("ld_id", 4),        # logical device within an MLD
    ("tc", 2),           # traffic class
)

S2M_FIELDS = (
    ("valid", 1),
    ("channel", 2),      # 0=NDR, 1=DRS
    ("opcode", 3),
    ("meta_field", 2),
    ("meta_value", 2),
    ("tag", 16),
    ("ld_id", 4),
    ("dev_load", 2),     # DevLoad: QoS telemetry (Light/Optimal/Mod/Severe)
    ("poison", 1),
)


def fields_bits(fields) -> int:
    return sum(w for _, w in fields)


M2S_HEADER_BITS = fields_bits(M2S_FIELDS)      # 82 bits -> fits 2 slots w/ ECC
S2M_HEADER_BITS = fields_bits(S2M_FIELDS)


class DevLoad(enum.IntEnum):
    """S2M DevLoad QoS telemetry (CXL 2.0 §3.3.4): device-reported load."""
    LIGHT = 0
    OPTIMAL = 1
    MODERATE = 2
    SEVERE = 3


# ---------------------------------------------------------------------------
# CXL.io — PCIe config-space identity & DVSEC IDs (register model).
# ---------------------------------------------------------------------------
PCI_VENDOR_ID_CXL = 0x1E98          # CXL consortium vendor ID used in DVSEC
PCI_CLASS_MEMORY_CXL = 0x0502       # class 05h (memory), subclass 02h (CXL)

# DVSEC IDs (CXL 2.0 table 8-2)
DVSEC_PCIE_DEVICE = 0x0     # CXL PCIe device capability
DVSEC_FLEXBUS_PORT = 0x7    # Flex Bus port
DVSEC_PORT_GPF = 0x4        # Global Persistent Flush (port)
DVSEC_DEVICE_GPF = 0x5      # GPF (device)
DVSEC_REGISTER_LOCATOR = 0x8
DVSEC_MLD = 0x9

# Component register block identifiers (Register Locator BIR targets)
BLOCK_ID_COMPONENT = 0x1
BLOCK_ID_BAR_VIRT = 0x2
BLOCK_ID_DEVICE = 0x3       # CXL device registers (mailbox lives here)

# Capability IDs inside the component register block (CXL 2.0 §8.2.5)
CAP_ID_RAS = 0x2
CAP_ID_SECURITY = 0x3
CAP_ID_LINK = 0x4
CAP_ID_HDM_DECODER = 0x5

# HDM decoder constants
HDM_DECODER_MAX = 10                 # decoders per component (spec allows 1-10)
HDM_GRANULARITY_BYTES = tuple(256 << i for i in range(9))  # 256B .. 64KiB
HDM_MAX_WAYS = (1, 2, 4, 8, 16, 3, 6, 12)  # spec-legal interleave ways

# Mailbox (CXL 2.0 §8.2.8.4): command register + doorbell bit
MBOX_DOORBELL = 1 << 0
MBOX_CMD_IDENTIFY = 0x4000           # Identify Memory Device
MBOX_CMD_GET_PARTITION = 0x4100
MBOX_CMD_SET_PARTITION = 0x4102
MBOX_CMD_GET_LSA = 0x4102
MBOX_CMD_GET_HEALTH = 0x4200
MBOX_PAYLOAD_MAX = 1 << 20

# Memory Device Status register
MEMDEV_STATUS_FATAL = 1 << 0
MEMDEV_STATUS_FW_HALT = 1 << 1
MEMDEV_STATUS_MEDIA_READY = 1 << 2   # media trained & ready

# ---------------------------------------------------------------------------
# Reference timing constants (calibration defaults; all overridable in
# core.timing.TimingConfig). Sources: CXL-DMSim silicon validation, published
# Astera/Samsung CXL expander measurements, and the v5e host path.
# ---------------------------------------------------------------------------
DRAM_IDLE_LATENCY_NS = 90.0          # local DDR5 load-to-use
CXL_IDLE_LATENCY_NS = 255.0          # typical x8 Gen5 expander load-to-use
CXL_PACKETIZE_NS = 12.0              # RC packetization (paper exposes this)
CXL_DEPACKETIZE_NS = 12.0            # EP de-packetization
CXL_LINK_PROP_NS = 20.0              # retimer + wire + SERDES
CXL_BACKEND_NS = 110.0               # device-side DDR access
DRAM_CHANNEL_GBPS = 38.4             # one DDR5-4800 channel
HOST_DRAM_GBPS = 307.2               # 8-channel DDR5 host
CXL_X16_GBPS = 63.0                  # raw gen5 x16 per direction
CXL_X8_GBPS = 31.5

# CXL-SSD expander (flash-backed .mem device with an internal DRAM
# cache; cf. the CXL-SSD full-system simulation line of work).  Media
# latencies are flash-article values, asymmetric read/write; the cache
# hit path is DRAM-speed behind the same CXL pipeline.
SSD_READ_LATENCY_NS = 3_000.0        # flash page read (media miss)
SSD_WRITE_LATENCY_NS = 20_000.0      # flash program
SSD_CACHE_HIT_LATENCY_NS = 350.0     # internal DRAM cache hit (incl. link)
SSD_CACHE_HIT_FRAC = 0.6             # default internal cache hit rate
SSD_READ_GBPS = 6.0                  # sustained media read bandwidth
SSD_WRITE_GBPS = 2.0                 # sustained media program bandwidth

# The JAX package's planner defaults (memory/tiering.TierSpec): a TPU v5e
# host.  Inputs of the capacity model, copied as they are; the port keeps
# them as the named spec `memory.tiering.TPU_V5E`.
TPU_V5E_HBM_BYTES = 16 * 2**30
TPU_V5E_PCIE_GBPS = 32e9             # host<->chip staging path

# The card the port runs on, an NVIDIA H100 SXM: data-sheet values (NVIDIA's
# H100 data sheet), not measurements.  The default `memory.tiering.TierSpec`.
H100_HBM_BYTES = 80 * 2**30          # 80 GB HBM3
H100_PCIE_GBPS = 64e9                # PCIe Gen5 x16, each way (128 GB/s both)
H100_BF16_FLOPS = 989e12             # dense bf16 tensor-core peak (no sparsity)
H100_HBM_GBPS = 3.35e12              # HBM3 bandwidth, bytes/s
