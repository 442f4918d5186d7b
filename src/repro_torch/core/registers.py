"""CXL configuration-space / component register model (paper Fig. 3).

Three register sets, exactly as the paper enumerates:

  Set 1 (Root Complex):  DVSEC GPF, DVSEC Flexbus Port, DVSEC Port,
                         DVSEC Register Locator.
  Set 2 (Host Bridge):   Link, RAS, SEC(urity), Component registers and
                         HDM decoder registers (address/size of CXL devices
                         beneath the bridge).
  Set 3 (Endpoint):      Mailbox + Memory-Device Status registers, with the
                         PCIe-style *doorbell* mechanism for user-space
                         interaction (CXL-CLI).

gem5 models these as memory-mapped byte arrays parsed by the Linux `cxl`
driver; this model keeps the *fields and state machines* — bind
preconditions, HDM decoder commit rules, doorbell busy/ready protocol — as
typed Python objects, and the enumeration pass in
:mod:`repro_torch.core.topology` plays the role of the driver.  Every invariant
the driver would enforce raises here instead of silently mis-binding.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from repro_torch.core import spec


class RegisterError(RuntimeError):
    """Driver-visible register programming error (bind would fail)."""


# ---------------------------------------------------------------------------
# Set 1 — Root Complex DVSECs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DvsecGPF:
    """Global Persistent Flush: timeout budgets for flush on power fail."""
    phase1_timeout_us: int = 100
    phase2_timeout_us: int = 100
    active: bool = False


@dataclasses.dataclass
class DvsecFlexbusPort:
    """Flex Bus negotiation result: which protocols trained on the link."""
    cache_capable: bool = False
    io_capable: bool = True           # CXL.io is mandatory
    mem_capable: bool = True
    cache_enabled: bool = False
    io_enabled: bool = True
    mem_enabled: bool = False         # set when link trains
    link_width: int = 16              # lanes
    link_gen: int = 5                 # PCIe generation

    def train(self) -> None:
        if not self.io_capable:
            raise RegisterError("CXL.io capability is mandatory")
        self.mem_enabled = self.mem_capable
        self.cache_enabled = self.cache_capable


@dataclasses.dataclass
class DvsecRegisterLocator:
    """Maps register blocks to BAR offsets: (block_id, bar, offset)."""
    entries: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)

    def add(self, block_id: int, bar: int, offset: int) -> None:
        if offset % 0x10000:
            raise RegisterError("register block must be 64K-aligned")
        self.entries.append((block_id, bar, offset))

    def locate(self, block_id: int) -> Tuple[int, int]:
        for bid, bar, off in self.entries:
            if bid == block_id:
                return bar, off
        raise RegisterError(f"register block {block_id:#x} not located")


@dataclasses.dataclass
class RootComplexRegisters:
    """Set 1: what the Linux driver needs to bind a CXL root complex."""
    gpf: DvsecGPF = dataclasses.field(default_factory=DvsecGPF)
    flexbus: DvsecFlexbusPort = dataclasses.field(default_factory=DvsecFlexbusPort)
    port_dvsec_present: bool = True
    locator: DvsecRegisterLocator = dataclasses.field(
        default_factory=DvsecRegisterLocator)

    def check_bind(self) -> None:
        """Preconditions for the `cxl_acpi`/`cxl_port` drivers to bind."""
        if not self.port_dvsec_present:
            raise RegisterError("missing CXL Port DVSEC — driver will not bind")
        if not self.flexbus.mem_enabled:
            raise RegisterError("Flex Bus link has not trained CXL.mem")
        self.locator.locate(spec.BLOCK_ID_COMPONENT)


# ---------------------------------------------------------------------------
# Set 2 — Host Bridge component registers (incl. HDM decoders)
# ---------------------------------------------------------------------------
class HdmState(enum.Enum):
    DISABLED = "disabled"
    PROGRAMMED = "programmed"   # base/size/ways written, not yet committed
    COMMITTED = "committed"     # lockout: live address decode


@dataclasses.dataclass
class HdmDecoder:
    """One HDM decoder: carves a host-physical window onto targets.

    Commit rules (CXL 2.0 §8.2.5.12): base/size 256MB-aligned, interleave
    ways in the legal set, granularity a power of two in [256B, 16KiB] (we
    allow up to 64KiB, matching later ECN), and decoders within a component
    must commit in order with non-overlapping, monotonically increasing
    ranges.
    """
    index: int
    base: int = 0
    size: int = 0
    ways: int = 1
    granularity: int = 256
    targets: Tuple[int, ...] = ()
    state: HdmState = HdmState.DISABLED

    ALIGN = 256 * 2**20  # 256 MiB

    def program(self, base: int, size: int, ways: int, granularity: int,
                targets: Tuple[int, ...]) -> None:
        if self.state is HdmState.COMMITTED:
            raise RegisterError(f"HDM decoder {self.index} is locked (committed)")
        if base % self.ALIGN or size % self.ALIGN:
            raise RegisterError("HDM base/size must be 256MiB-aligned")
        if ways not in spec.HDM_MAX_WAYS:
            raise RegisterError(f"illegal interleave ways {ways}")
        if granularity not in spec.HDM_GRANULARITY_BYTES:
            raise RegisterError(f"illegal interleave granularity {granularity}")
        if len(targets) != ways:
            raise RegisterError("target list length must equal interleave ways")
        self.base, self.size = base, size
        self.ways, self.granularity = ways, granularity
        self.targets = tuple(targets)
        self.state = HdmState.PROGRAMMED

    def commit(self, prior: Optional["HdmDecoder"]) -> None:
        if self.state is not HdmState.PROGRAMMED:
            raise RegisterError(f"decoder {self.index}: commit before program")
        if prior is not None:
            if prior.state is not HdmState.COMMITTED:
                raise RegisterError("decoders must commit in index order")
            if self.base < prior.base + prior.size:
                raise RegisterError("HDM ranges must be increasing & disjoint")
        self.state = HdmState.COMMITTED

    def contains(self, hpa: int) -> bool:
        return self.state is HdmState.COMMITTED and \
            self.base <= hpa < self.base + self.size


@dataclasses.dataclass
class HostBridgeRegisters:
    """Set 2: Link / RAS / SEC / Component caps + the HDM decoder file."""
    n_decoders: int = 4
    link_cap_present: bool = True
    ras_cap_present: bool = True
    sec_cap_present: bool = True
    decoders: List[HdmDecoder] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if not 1 <= self.n_decoders <= spec.HDM_DECODER_MAX:
            raise RegisterError("1..10 HDM decoders per component")
        if not self.decoders:
            self.decoders = [HdmDecoder(i) for i in range(self.n_decoders)]

    def capability_ids(self) -> List[int]:
        caps = [spec.CAP_ID_HDM_DECODER]
        if self.link_cap_present:
            caps.append(spec.CAP_ID_LINK)
        if self.ras_cap_present:
            caps.append(spec.CAP_ID_RAS)
        if self.sec_cap_present:
            caps.append(spec.CAP_ID_SECURITY)
        return caps

    def commit_decoder(self, index: int) -> None:
        prior = self.decoders[index - 1] if index > 0 else None
        self.decoders[index].commit(prior)

    def decode(self, hpa: int) -> Optional[HdmDecoder]:
        for d in self.decoders:
            if d.contains(hpa):
                return d
        return None


# ---------------------------------------------------------------------------
# Set 3 — Endpoint mailbox + status (doorbell mechanism)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MemDevStatus:
    fatal: bool = False
    fw_halt: bool = False
    media_ready: bool = True

    def raw(self) -> int:
        return (spec.MEMDEV_STATUS_FATAL * self.fatal
                | spec.MEMDEV_STATUS_FW_HALT * self.fw_halt
                | spec.MEMDEV_STATUS_MEDIA_READY * self.media_ready)


@dataclasses.dataclass
class Mailbox:
    """Primary mailbox with the doorbell protocol the paper implements:

      host: poll doorbell==0 -> write cmd+payload -> ring doorbell
      dev : execute -> clear doorbell, post return code + payload
      host: poll doorbell==0 -> read status/payload

    This is what lets *user space* (CXL-CLI / NDCTL) drive the device
    without kernel patches.
    """
    device: "object" = None           # backref supplied by the endpoint
    doorbell: bool = False
    command: int = 0
    payload_in: bytes = b""
    return_code: int = 0
    payload_out: bytes = b""
    background_pct: int = 100

    def submit(self, command: int, payload: bytes = b"") -> None:
        if self.doorbell:
            raise RegisterError("mailbox busy: doorbell already rung")
        if len(payload) > spec.MBOX_PAYLOAD_MAX:
            raise RegisterError("mailbox payload exceeds 1 MiB")
        self.command, self.payload_in = command, payload
        self.doorbell = True
        self._execute()

    def _execute(self) -> None:
        handler = getattr(self.device, "mbox_execute", None)
        if handler is None:
            self.return_code, self.payload_out = 0x15, b""  # unsupported
        else:
            self.return_code, self.payload_out = handler(
                self.command, self.payload_in)
        self.doorbell = False

    def poll(self) -> Tuple[int, bytes]:
        if self.doorbell:
            raise RegisterError("mailbox command still in flight")
        return self.return_code, self.payload_out


@dataclasses.dataclass
class EndpointRegisters:
    """Set 3 plus the endpoint's own HDM decoders & device capabilities."""
    status: MemDevStatus = dataclasses.field(default_factory=MemDevStatus)
    mailbox: Mailbox = dataclasses.field(default_factory=Mailbox)
    component: HostBridgeRegisters = dataclasses.field(
        default_factory=lambda: HostBridgeRegisters(n_decoders=2))
    locator: DvsecRegisterLocator = dataclasses.field(
        default_factory=DvsecRegisterLocator)

    def __post_init__(self) -> None:
        # standard layout: component block @BAR0+0, device block @BAR0+64K
        if not self.locator.entries:
            self.locator.add(spec.BLOCK_ID_COMPONENT, 0, 0x00000)
            self.locator.add(spec.BLOCK_ID_DEVICE, 0, 0x10000)

    def check_bind(self) -> None:
        if not self.status.media_ready:
            raise RegisterError("media not ready — cxl_pci will defer probe")
        if self.status.fatal or self.status.fw_halt:
            raise RegisterError("device in fatal/fw-halt state")
        self.locator.locate(spec.BLOCK_ID_DEVICE)
        self.locator.locate(spec.BLOCK_ID_COMPONENT)


def identify_payload(capacity_bytes: int, volatile_only: bool = True) -> bytes:
    """Encode the Identify-Memory-Device mailbox response (subset)."""
    total = capacity_bytes // (256 * 2**20)  # in 256MiB multiples, per spec
    vol = total if volatile_only else 0
    return total.to_bytes(8, "little") + vol.to_bytes(8, "little")


def parse_identify(payload: bytes) -> Dict[str, int]:
    total = int.from_bytes(payload[0:8], "little") * 256 * 2**20
    vol = int.from_bytes(payload[8:16], "little") * 256 * 2**20
    return {"capacity_bytes": total, "volatile_bytes": vol}
