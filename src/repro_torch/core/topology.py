"""PCIe/CXL hierarchy, firmware tables, enumeration, and the CXL-CLI flow.

gem5-side, the paper builds: an x86 BIOS (E820 + MCFG + DSDT + CEDT + SRAT)
describing the hierarchy, the Linux `cxl` driver enumerating Root Complex ->
Host Bridge -> Root Port -> Endpoint, and CXL-CLI/NDCTL creating regions and
onlining them as a CPU-less **zNUMA** node (or leaving capacity in **flat**
mode contiguous with system DRAM).

Here the byte-level ACPI encodings are replaced by typed table objects
with identical *content*, and :func:`enumerate_system` plays the driver:
it verifies every register precondition (via :mod:`.registers`),
programs + commits HDM decoders per CFMWS window, and produces a
:class:`SystemMap` — the authoritative host physical address map that the
timing / cache / tiering layers consume.  :class:`CxlCli` exposes the same
verbs the paper's user-space flow uses (`list`, `create-region`,
`online-memory`) over the mailbox doorbell.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import registers as regs
from repro_torch.core import spec
from repro_torch.core.hdm import InterleaveProgram

MiB = 2**20
GiB = 2**30
ALIGN = 256 * MiB


class TopologyError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CXLMemDevice:
    """A Type-3 CXL memory expander endpoint (SLD; MLD hooks via ld_count).

    ``media`` distinguishes the backing store behind the .mem interface:
    ``"dram"`` (the paper's expander cards) or ``"flash"`` — a CXL-SSD
    whose asymmetric media latency and internal DRAM cache are priced by
    :class:`repro_torch.core.timing.SSDTiming` (the third tier the dynamic
    tierer demotes cold pages into; see docs/fidelity.md).
    """
    name: str
    capacity: int                      # bytes
    serial: int = 0
    ld_count: int = 1                  # 1 => SLD
    media: str = "dram"                # 'dram' | 'flash'
    registers: regs.EndpointRegisters = dataclasses.field(
        default_factory=regs.EndpointRegisters)

    def __post_init__(self) -> None:
        if self.capacity % ALIGN:
            raise TopologyError("device capacity must be 256MiB-aligned")
        if self.media not in ("dram", "flash"):
            raise TopologyError(f"unknown media {self.media!r}")
        self.registers.mailbox.device = self

    # Mailbox command handler — the device side of the doorbell protocol.
    def mbox_execute(self, command: int, payload: bytes) -> Tuple[int, bytes]:
        if command == spec.MBOX_CMD_IDENTIFY:
            return 0, regs.identify_payload(self.capacity)
        if command == spec.MBOX_CMD_GET_HEALTH:
            return 0, bytes([0x00, self.registers.status.raw() & 0xFF])
        if command == spec.MBOX_CMD_GET_PARTITION:
            return 0, regs.identify_payload(self.capacity)
        return 0x15, b""  # CXL_MBOX_CMD_RC_UNSUPPORTED


@dataclasses.dataclass
class RootPort:
    name: str
    endpoint: Optional[CXLMemDevice] = None


@dataclasses.dataclass
class HostBridge:
    """CXL host bridge (one per CHBS entry)."""
    uid: int
    name: str
    root_ports: List[RootPort] = dataclasses.field(default_factory=list)
    registers: regs.HostBridgeRegisters = dataclasses.field(
        default_factory=regs.HostBridgeRegisters)

    def endpoints(self) -> List[CXLMemDevice]:
        return [rp.endpoint for rp in self.root_ports if rp.endpoint]


@dataclasses.dataclass
class RootComplex:
    name: str
    host_bridges: List[HostBridge] = dataclasses.field(default_factory=list)
    registers: regs.RootComplexRegisters = dataclasses.field(
        default_factory=regs.RootComplexRegisters)

    def __post_init__(self) -> None:
        # locate the component block (BAR0 + 0): required for driver bind
        if not self.registers.locator.entries:
            self.registers.locator.add(spec.BLOCK_ID_COMPONENT, 0, 0)


# ---------------------------------------------------------------------------
# Firmware tables (content-equivalent to the paper's modeled BIOS, Fig. 2)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class E820Entry:
    base: int
    size: int
    kind: str                         # 'ram' | 'reserved'


@dataclasses.dataclass(frozen=True)
class CHBS:
    """CEDT: CXL Host Bridge Structure."""
    uid: int
    cxl_version: spec.CXLVersion
    register_base: int


@dataclasses.dataclass(frozen=True)
class CFMWS:
    """CEDT: CXL Fixed Memory Window Structure — an HPA window the firmware
    reserves for CXL memory, with its host-bridge interleave program."""
    base: int
    size: int
    interleave_ways: int
    granularity: int
    targets: Tuple[int, ...]          # host-bridge uids
    qtg_id: int = 0                   # QoS throttling group


@dataclasses.dataclass(frozen=True)
class SRATMemAffinity:
    base: int
    size: int
    proximity_domain: int
    hotplug: bool = False


@dataclasses.dataclass(frozen=True)
class SRATApicAffinity:
    apic_id: int
    proximity_domain: int


@dataclasses.dataclass(frozen=True)
class FirmwareTables:
    e820: Tuple[E820Entry, ...]
    chbs: Tuple[CHBS, ...]
    cfmws: Tuple[CFMWS, ...]
    srat_mem: Tuple[SRATMemAffinity, ...]
    srat_apic: Tuple[SRATApicAffinity, ...]
    mcfg_base: int = 0xE000_0000      # ECAM window (MCFG table content)


# ---------------------------------------------------------------------------
# The system under simulation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class System:
    """Host + CXL topology before enumeration."""
    dram_size: int
    n_cores: int = 4
    root_complex: RootComplex = dataclasses.field(
        default_factory=lambda: RootComplex("rc0"))
    cxl_window_base: Optional[int] = None   # default: above DRAM, aligned

    def add_expander(self, name: str, capacity: int,
                     bridge_uid: Optional[int] = None,
                     ld_count: int = 1,
                     media: str = "dram") -> CXLMemDevice:
        """Attach an expander card below (a possibly new) host bridge.

        ld_count > 1 attaches a **Multi-Logical-Device** (beyond the paper's
        v1.0 SLD scope): capacity splits into `ld_count` equal partitions,
        each enumerated as its own region / zNUMA node, with the LD id
        carried in the CXL.mem packet headers (spec DVSEC ID 9).

        ``media="flash"`` attaches a CXL-SSD (flash-backed expander with
        an internal DRAM cache); give it its own ``bridge_uid`` so it
        enumerates as its own CFMWS window / region.
        """
        if bridge_uid is None:
            bridge_uid = len(self.root_complex.host_bridges)
        hb = next((h for h in self.root_complex.host_bridges
                   if h.uid == bridge_uid), None)
        if hb is None:
            hb = HostBridge(uid=bridge_uid, name=f"hb{bridge_uid}")
            self.root_complex.host_bridges.append(hb)
        if ld_count > 1:
            if capacity % (ld_count * ALIGN):
                raise TopologyError("MLD partitions must be 256MiB-aligned")
            if len(hb.endpoints()) > 0:
                raise TopologyError("an MLD must own its host bridge")
        dev = CXLMemDevice(name=name, capacity=capacity,
                           serial=len(hb.root_ports) + 1000 * bridge_uid,
                           ld_count=ld_count, media=media)
        if ld_count > 1:   # one decoder per logical device, both levels
            dev.registers.component = regs.HostBridgeRegisters(
                n_decoders=max(2, ld_count))
            hb.registers = regs.HostBridgeRegisters(
                n_decoders=max(4, ld_count))
        hb.root_ports.append(RootPort(name=f"{hb.name}.rp{len(hb.root_ports)}",
                                      endpoint=dev))
        dev.registers.component.decoders  # materialize endpoint decoders
        self.root_complex.registers.flexbus.train()
        return dev

    def devices(self) -> List[CXLMemDevice]:
        out: List[CXLMemDevice] = []
        for hb in self.root_complex.host_bridges:
            out.extend(hb.endpoints())
        return out

    def build_firmware(self) -> FirmwareTables:
        """Emit the BIOS tables (paper Fig. 2): E820, CEDT(CHBS+CFMWS), SRAT."""
        if self.dram_size % ALIGN:
            raise TopologyError("DRAM size must be 256MiB-aligned")
        e820 = (E820Entry(0, self.dram_size, "ram"),
                E820Entry(0xE000_0000, 256 * MiB, "reserved"))  # ECAM
        chbs = tuple(CHBS(hb.uid, spec.CXLVersion.CXL_2_0,
                          0xF000_0000 + 0x1_0000 * hb.uid)
                     for hb in self.root_complex.host_bridges)
        base = self.cxl_window_base
        if base is None:
            base = max(4 * GiB, ((self.dram_size + ALIGN - 1)//ALIGN) * ALIGN)
        cfmws: List[CFMWS] = []
        for hb in self.root_complex.host_bridges:
            eps = hb.endpoints()
            cap = sum(d.capacity for d in eps)
            if cap == 0:
                continue
            if len(eps) == 1 and eps[0].ld_count > 1:
                # MLD: one fixed window per logical device
                part = eps[0].capacity // eps[0].ld_count
                for _ in range(eps[0].ld_count):
                    cfmws.append(CFMWS(base=base, size=part,
                                       interleave_ways=1, granularity=256,
                                       targets=(hb.uid,)))
                    base += part
            else:
                cfmws.append(CFMWS(base=base, size=cap, interleave_ways=1,
                                   granularity=256, targets=(hb.uid,)))
                base += cap
        srat_mem = [SRATMemAffinity(0, self.dram_size, 0)]
        # one proximity domain (CPU-less -> zNUMA candidate) per CXL window
        for i, w in enumerate(cfmws):
            srat_mem.append(SRATMemAffinity(w.base, w.size, 1 + i,
                                            hotplug=True))
        srat_apic = tuple(SRATApicAffinity(c, 0) for c in range(self.n_cores))
        return FirmwareTables(e820=e820, chbs=chbs, cfmws=tuple(cfmws),
                              srat_mem=tuple(srat_mem), srat_apic=srat_apic)


# ---------------------------------------------------------------------------
# Enumeration (the "unmodified driver" pass) and the resulting address map
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Region:
    """An active CXL region (committed decode chain), pre-onlining."""
    name: str
    hpa_base: int
    size: int
    program: InterleaveProgram        # host-bridge level interleave
    devices: Tuple[CXLMemDevice, ...]
    numa_node: int                    # proximity domain
    mode: str = "znuma"               # 'znuma' | 'flat'
    ld_id: int = 0                    # logical device within an MLD


@dataclasses.dataclass
class NumaNode:
    node_id: int
    kind: str                         # 'dram' | 'cxl'
    base: int
    size: int
    online: bool
    cpus: Tuple[int, ...] = ()

    @property
    def cpuless(self) -> bool:
        return not self.cpus


@dataclasses.dataclass
class SystemMap:
    """Post-enumeration authoritative address map."""
    firmware: FirmwareTables
    nodes: List[NumaNode]
    regions: List[Region]
    dram_size: int

    def resolve(self, hpa: int) -> Tuple[str, Optional[CXLMemDevice], int, int]:
        """hpa -> (kind, device, device-physical-address, numa_node)."""
        if 0 <= hpa < self.dram_size:
            return "dram", None, hpa, 0
        for r in self.regions:
            if r.hpa_base <= hpa < r.hpa_base + r.size:
                tgt, dpa = r.program.decode(hpa)
                return "cxl", r.devices[tgt], dpa, r.numa_node
        raise TopologyError(f"hpa {hpa:#x} unmapped")

    def node_of(self, hpa: int) -> int:
        return self.resolve(hpa)[3]

    def online_nodes(self) -> List[NumaNode]:
        return [n for n in self.nodes if n.online]

    def total_online_bytes(self) -> int:
        return sum(n.size for n in self.online_nodes())


def enumerate_system(system: System) -> SystemMap:
    """The driver-equivalent pass: bind checks + decoder programming.

    Walks RC -> HB -> RP -> EP exactly as `cxl_acpi`/`cxl_port`/`cxl_pci`
    would, raising :class:`registers.RegisterError` wherever the real driver
    would refuse to bind, then programs and *commits* HDM decoders for every
    CFMWS window (commit-order and alignment rules enforced in
    :class:`registers.HdmDecoder`).
    """
    fw = system.build_firmware()
    rc = system.root_complex
    rc.registers.check_bind()

    regions: List[Region] = []
    nodes: List[NumaNode] = [
        NumaNode(0, "dram", 0, system.dram_size, online=True,
                 cpus=tuple(range(system.n_cores)))]
    next_decoder: Dict[int, int] = {}      # bridge uid -> decoder index

    for w in fw.cfmws:
        hbs = [hb for hb in rc.host_bridges if hb.uid in w.targets]
        if len(hbs) != len(w.targets):
            raise TopologyError(f"CFMWS targets missing host bridge: {w}")
        devices: List[CXLMemDevice] = []
        ld_id = 0
        for hb in hbs:
            eps = hb.endpoints()
            if not eps:
                raise TopologyError(f"{hb.name}: CFMWS names empty bridge")
            for ep in eps:
                ep.registers.check_bind()
            # host-bridge decoder: window -> endpoints below this bridge
            # (an MLD gets one window per LD -> decoder index advances)
            ways = len(eps)
            if ways not in spec.HDM_MAX_WAYS:
                raise TopologyError(f"{hb.name}: {ways} endpoints not an "
                                    "interleavable way count")
            di = next_decoder.get(hb.uid, 0)
            ld_id = di if eps[0].ld_count > 1 else 0
            next_decoder[hb.uid] = di + 1
            dec = hb.registers.decoders[di]
            dec.program(w.base, w.size, ways, w.granularity,
                        tuple(range(ways)))
            hb.registers.commit_decoder(di)
            # endpoint decoders: their slice of the window
            for i, ep in enumerate(eps):
                edec = ep.registers.component.decoders[di]
                edec.program(w.base, w.size, ways, w.granularity,
                             tuple(range(ways)))
                ep.registers.component.commit_decoder(di)
            devices.extend(eps)
        node_id = 1 + len(regions)
        program = InterleaveProgram(
            base=w.base, size=w.size, ways=len(devices),
            granularity=w.granularity,
            targets=tuple(range(len(devices))))
        regions.append(Region(name=f"region{len(regions)}", hpa_base=w.base,
                              size=w.size, program=program,
                              devices=tuple(devices), numa_node=node_id,
                              ld_id=ld_id))
        # CPU-less node, initially offline (needs cxl-cli/ndctl onlining)
        nodes.append(NumaNode(node_id, "cxl", w.base, w.size, online=False))

    return SystemMap(firmware=fw, nodes=nodes, regions=regions,
                     dram_size=system.dram_size)


# ---------------------------------------------------------------------------
# CXL-CLI / numactl equivalent (the paper's user-space flow)
# ---------------------------------------------------------------------------
class CxlCli:
    """`cxl list` / `cxl create-region` / onlining, driven via the mailbox
    doorbell — the same verbs (and the same state machine underneath) as the
    paper's CXL-CLI + NDCTL + numactl flow."""

    def __init__(self, system: System, sysmap: SystemMap):
        self.system = system
        self.map = sysmap

    def list_memdevs(self) -> List[Dict]:
        out = []
        for dev in self.system.devices():
            mbox = dev.registers.mailbox
            mbox.submit(spec.MBOX_CMD_IDENTIFY)
            rc_code, payload = mbox.poll()
            if rc_code != 0:
                raise TopologyError(f"{dev.name}: IDENTIFY failed rc={rc_code}")
            ident = regs.parse_identify(payload)
            out.append({"memdev": dev.name, "serial": dev.serial,
                        **ident,
                        "health": dev.registers.status.raw()})
        return out

    def list_regions(self) -> List[Dict]:
        return [{"region": r.name, "base": r.hpa_base, "size": r.size,
                 "interleave_ways": r.program.ways,
                 "granularity": r.program.granularity,
                 "numa_node": r.numa_node, "mode": r.mode,
                 "online": self.map.nodes[r.numa_node].online}
                for r in self.map.regions]

    def online_memory(self, region_name: str, mode: str = "znuma") -> NumaNode:
        """Online a region: zNUMA (CPU-less node) or flat (merged w/ node 0).

        Flat mode models the paper's "rest of the CXL card goes into the
        same NUMA node as system memory" — the OS sees one big node.
        """
        if mode not in ("znuma", "flat"):
            raise TopologyError(f"unknown mode {mode!r}")
        for i, r in enumerate(self.map.regions):
            if r.name == region_name:
                node = self.map.nodes[r.numa_node]
                node.online = True
                if mode == "flat":
                    node.kind = "dram"       # OS-visible: same pool as DRAM
                    node.node_id = 0
                self.map.regions[i] = dataclasses.replace(r, mode=mode)
                return node
        raise TopologyError(f"no region {region_name!r}")

    def numastat(self) -> Dict[int, Dict]:
        stat: Dict[int, Dict] = {}
        for n in self.map.nodes:
            if not n.online:
                continue
            ent = stat.setdefault(n.node_id, {"bytes": 0, "cpuless": n.cpuless,
                                              "kind": n.kind})
            ent["bytes"] += n.size
        return stat


def build_default_system(dram_gib: int = 16, expander_gib: Sequence[int] = (16,),
                         n_cores: int = 4) -> Tuple[System, SystemMap, CxlCli]:
    """One-call convenience: system + enumeration + CLI (quickstart path)."""
    sys_ = System(dram_size=dram_gib * GiB, n_cores=n_cores)
    for i, g in enumerate(expander_gib):
        sys_.add_expander(f"mem{i}", g * GiB)
    sysmap = enumerate_system(sys_)
    return sys_, sysmap, CxlCli(sys_, sysmap)
