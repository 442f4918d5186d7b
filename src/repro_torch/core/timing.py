"""Latency / bandwidth timing model for DRAM and CXL paths.

The paper "exposes the latency of the CXL packetization and de-packetization,
CXL buses, etc. at the Python-level in gem5, making it convenient for users
to calibrate these latencies with actual hardware" (§III-B.2) and notes that
"bandwidth-latency characteristics of CXL memory are highly vendor specific"
(§V).  This module is that calibration surface:

  * every pipeline stage (RC packetize -> link -> EP de-packetize -> device
    DRAM backend) is an explicit field of :class:`CXLTiming`;
  * loaded latency follows an M/D/1-style queueing curve on top of the idle
    pipeline, per direction, saturating at the payload bandwidth implied by
    the flit geometry of :mod:`repro_torch.core.spec`;
  * :func:`calibrate` fits stage latencies/service rates to measured
    (offered-load, latency) points from real hardware.

All math here is plain numpy/python — it prices memory accesses for the
vectorized machine model (:mod:`repro_torch.core.machine`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import packet, spec


# ---------------------------------------------------------------------------
# Counter-seeded jitter — the determinism primitive under latency
# distributions.  SplitMix64 is a stateless integer permutation: the
# jitter for sample ``j`` of target ``tid`` is a pure function of
# ``(seed, tid, j)`` and never of batch position, segment boundary or
# backend, so distribution rows stay bitwise-reproducible everywhere
# the integer stats are (see docs/fidelity.md).
# ---------------------------------------------------------------------------
_U64 = np.uint64
_SM64_GAMMA = _U64(0x9E3779B97F4A7C15)
_SM64_MIX1 = _U64(0xBF58476D1CE4E5B9)
_SM64_MIX2 = _U64(0x94D049BB133111EB)


def splitmix64(x) -> np.ndarray:
    """The SplitMix64 finalizer: uint64 -> uint64, vectorized."""
    with np.errstate(over="ignore"):
        z = (np.asarray(x, _U64) + _SM64_GAMMA)
        z = (z ^ (z >> _U64(30))) * _SM64_MIX1
        z = (z ^ (z >> _U64(27))) * _SM64_MIX2
        return z ^ (z >> _U64(31))


def jitter_u01(seed: int, tid: int, idx) -> np.ndarray:
    """Deterministic jitter in [0, 1) for counters ``idx`` of one target.

    The counter is ``splitmix64(seed) ^ splitmix64(tid) + idx`` — two
    finalizer applications decorrelate nearby (seed, tid) pairs before
    the per-sample walk; the top 53 bits of the final mix become the
    float64 mantissa.
    """
    with np.errstate(over="ignore"):
        base = splitmix64(_U64(seed)) ^ splitmix64((_U64(tid) + _U64(1)) << _U64(32))
        z = splitmix64(base + np.asarray(idx, _U64))
    return (z >> _U64(11)).astype(np.float64) * (2.0 ** -53)


@dataclasses.dataclass(frozen=True)
class LatencyDistribution:
    """Queueing-derived per-target latency *distribution* knob.

    The machine model's Picard fixed point resolves each target to a
    deterministic loaded latency ``lat`` above its idle floor ``idle``.
    With a ``LatencyDistribution`` attached, that point is widened into
    an M/M/1-shaped response-time distribution with the *same mean*:
    the queueing excess ``lat - idle`` becomes the scale of an
    exponential tail,

        latency_j = idle + (lat - idle) * x_j,   x_j ~ Exp(1)

    sampled by **stratified inversion**: sample ``j`` of ``n`` inverts
    u_j = (j + jitter_j)/n with ``jitter_j`` from counter-seeded
    SplitMix64 (:func:`jitter_u01`).  Strata are disjoint and ordered,
    so the sample vector is already sorted (percentile = index lookup,
    p50 <= p95 <= p99 by construction), the sample mean is within
    O(1/n) of the closed-form M/D/1 mean, and zero queueing excess
    collapses every sample to the deterministic fixed point — the
    legacy number, bitwise.
    """
    n_samples: int = 512
    seed: int = 0
    percentiles: Tuple[float, ...] = (0.50, 0.95, 0.99)

    def __post_init__(self):
        if self.n_samples < 2:
            raise ValueError("n_samples must be >= 2")
        if any(not 0.0 < p < 1.0 for p in self.percentiles):
            raise ValueError("percentiles must lie in (0, 1)")

    @property
    def label(self) -> str:
        return f"dist(n={self.n_samples},seed={self.seed})"

    def exp_strata(self, tid: int) -> np.ndarray:
        """Sorted stratified Exp(1) sample (n_samples,) for one target."""
        j = np.arange(self.n_samples, dtype=np.uint64)
        u = (j.astype(np.float64) + jitter_u01(self.seed, tid, j)) \
            / float(self.n_samples)
        return -np.log1p(-u)

    def quantile_factors(self, tid: int) -> np.ndarray:
        """Exp(1) factors at ``self.percentiles`` (already-sorted lookup)."""
        x = self.exp_strata(tid)
        idx = [min(int(np.ceil(p * self.n_samples)) - 1, self.n_samples - 1)
               for p in self.percentiles]
        return x[np.asarray(idx, np.int64)]

    def latency_percentiles(self, idle_ns: float, loaded_ns,
                            tid: int) -> np.ndarray:
        """Per-row latency percentiles, shape ``loaded.shape + (P,)``.

        ``loaded_ns`` may be a scalar or a batch vector of converged
        fixed-point latencies; the queueing excess is clamped at zero so
        a target resolved *at* its idle floor reports the floor for
        every percentile.
        """
        loaded = np.asarray(loaded_ns, np.float64)
        excess = np.maximum(loaded - idle_ns, 0.0)
        return idle_ns + excess[..., None] * self.quantile_factors(tid)

    def mean_latency_ns(self, idle_ns: float, loaded_ns, tid: int):
        """Sample-mean latency (the statistical-harness hook)."""
        loaded = np.asarray(loaded_ns, np.float64)
        excess = np.maximum(loaded - idle_ns, 0.0)
        return idle_ns + excess * float(self.exp_strata(tid).mean())


@dataclasses.dataclass(frozen=True)
class QueueModel:
    """M/D/1-flavoured loaded-latency curve.

    latency(rho) = idle + service * rho / (2 * (1 - rho))   for rho < rho_max

    `rho` is offered/peak utilization; the curve is clamped at `rho_max` to
    model admission control / back-pressure rather than divergence.
    """
    idle_ns: float
    service_ns: float
    rho_max: float = 0.98

    def latency_ns(self, rho) -> np.ndarray:
        rho = np.minimum(np.asarray(rho, np.float64), self.rho_max)
        rho = np.maximum(rho, 0.0)
        return self.idle_ns + self.service_ns * rho / (2.0 * (1.0 - rho))


@dataclasses.dataclass(frozen=True)
class DramTiming:
    """Local (host) DDR path."""
    idle_ns: float = spec.DRAM_IDLE_LATENCY_NS
    channels: int = 8
    channel_gbps: float = spec.DRAM_CHANNEL_GBPS
    service_ns: float = 18.0
    #: Outstanding-request (MSHR) limit; ``None`` = unlimited (legacy).
    #: When set, Little's law caps the sustainable bandwidth at
    #: ``mshr * CACHELINE_BYTES / latency`` inside the timing fixed
    #: point — latency growth under load throttles achievable bandwidth.
    mshr: Optional[int] = None

    @property
    def peak_gbps(self) -> float:
        return self.channels * self.channel_gbps

    def queue(self) -> QueueModel:
        return QueueModel(self.idle_ns, self.service_ns)

    def loaded_latency_ns(self, offered_gbps) -> np.ndarray:
        return self.queue().latency_ns(np.asarray(offered_gbps) / self.peak_gbps)


@dataclasses.dataclass(frozen=True)
class CXLTiming:
    """The full CXL.mem path, stage by stage (paper Fig. 4)."""
    packetize_ns: float = spec.CXL_PACKETIZE_NS      # RC: host req -> M2S flit
    link_prop_ns: float = spec.CXL_LINK_PROP_NS      # SERDES + wire + retimer
    depacketize_ns: float = spec.CXL_DEPACKETIZE_NS  # EP: flit -> mem request
    backend_ns: float = spec.CXL_BACKEND_NS          # device DDR access
    lanes: int = 8
    pcie_gen: int = 5
    version: spec.CXLVersion = spec.CXLVersion.CXL_2_0
    backend_gbps: float = 38.4                       # device DDR channel(s)
    service_ns: float = 30.0                         # queueing service quantum
    mshr: Optional[int] = None                       # see DramTiming.mshr

    # ---- idle latency --------------------------------------------------
    @property
    def idle_ns(self) -> float:
        """Load-to-use added path: traverses packetize+link twice (req+resp)
        plus one backend access.  ~255 ns with defaults — matching published
        expander measurements."""
        one_way = self.packetize_ns + self.link_prop_ns + self.depacketize_ns
        return 2.0 * one_way + self.backend_ns + spec.DRAM_IDLE_LATENCY_NS / 2

    # ---- bandwidth -----------------------------------------------------
    @property
    def wire_gbps(self) -> float:
        return self.lanes * spec.PCIE_GEN_GBPS_PER_LANE[self.pcie_gen]

    @property
    def payload_read_gbps(self) -> float:
        """Reads: S2M DRS carries data (5 slots / 64B); M2S Req is tiny."""
        per_line_wire = (packet.SLOTS_HEADER + packet.SLOTS_DATA) \
            * packet.SLOT_WIRE_BYTES
        eff = spec.CACHELINE_BYTES / per_line_wire
        return min(self.wire_gbps * eff, self.backend_gbps)

    @property
    def payload_write_gbps(self) -> float:
        """Writes: M2S RwD carries data; S2M NDR is tiny."""
        return self.payload_read_gbps  # symmetric slot cost (5 slots / line)

    def payload_gbps(self, read_frac: float = 1.0) -> float:
        return (read_frac * self.payload_read_gbps
                + (1 - read_frac) * self.payload_write_gbps)

    def queue(self) -> QueueModel:
        return QueueModel(self.idle_ns, self.service_ns)

    def loaded_latency_ns(self, offered_gbps, read_frac: float = 1.0):
        rho = np.asarray(offered_gbps) / self.payload_gbps(read_frac)
        return self.queue().latency_ns(rho)

    def stage_breakdown(self) -> Dict[str, float]:
        return {
            "rc_packetize_ns": self.packetize_ns,
            "link_prop_ns": self.link_prop_ns,
            "ep_depacketize_ns": self.depacketize_ns,
            "backend_ns": self.backend_ns,
            "round_trip_overhead_ns": self.idle_ns - self.backend_ns,
            "idle_total_ns": self.idle_ns,
        }


@dataclasses.dataclass(frozen=True)
class SSDTiming:
    """A CXL-SSD expander: flash media behind an internal DRAM cache.

    The flash-backed third tier of the memory hierarchy (cf. the
    CXL-SSD full-system simulation line in PAPERS.md): asymmetric
    read/write media latency, an internal DRAM cache that absorbs
    ``cache_hit_frac`` of accesses at near-expander speed, and media
    bandwidth far below the CXL link.  The *effective* idle latency per
    direction mixes the hit and miss paths —

        idle_read  = h * cache_hit_ns + (1 - h) * read_ns
        idle_write = h * cache_hit_ns + (1 - h) * write_ns

    — and the loaded curve is the same M/D/1 queue as the DRAM-backed
    targets, on top of that mixed floor, saturating at the (read-frac
    blended) media bandwidth.  The cache absorbs latency, not
    bandwidth: sustained throughput is media-bound.
    """
    read_ns: float = spec.SSD_READ_LATENCY_NS
    write_ns: float = spec.SSD_WRITE_LATENCY_NS
    cache_hit_ns: float = spec.SSD_CACHE_HIT_LATENCY_NS
    cache_hit_frac: float = spec.SSD_CACHE_HIT_FRAC
    read_gbps: float = spec.SSD_READ_GBPS
    write_gbps: float = spec.SSD_WRITE_GBPS
    service_ns: float = 400.0
    mshr: Optional[int] = None                       # see DramTiming.mshr

    def __post_init__(self):
        if not 0.0 <= self.cache_hit_frac <= 1.0:
            raise ValueError("cache_hit_frac must lie in [0, 1]")

    # ---- idle latency --------------------------------------------------
    @property
    def idle_read_ns(self) -> float:
        h = self.cache_hit_frac
        return h * self.cache_hit_ns + (1.0 - h) * self.read_ns

    @property
    def idle_write_ns(self) -> float:
        h = self.cache_hit_frac
        return h * self.cache_hit_ns + (1.0 - h) * self.write_ns

    @property
    def idle_ns(self) -> float:
        """Read-path effective idle (the zero-traffic floor)."""
        return self.idle_read_ns

    def idle_latency_ns(self, read_frac: float = 1.0) -> float:
        return (read_frac * self.idle_read_ns
                + (1.0 - read_frac) * self.idle_write_ns)

    # ---- bandwidth -----------------------------------------------------
    @property
    def payload_read_gbps(self) -> float:
        return self.read_gbps

    @property
    def payload_write_gbps(self) -> float:
        return self.write_gbps

    def payload_gbps(self, read_frac: float = 1.0) -> float:
        return (read_frac * self.read_gbps
                + (1.0 - read_frac) * self.write_gbps)

    def queue(self, read_frac: float = 1.0) -> QueueModel:
        return QueueModel(self.idle_latency_ns(read_frac), self.service_ns)

    def loaded_latency_ns(self, offered_gbps, read_frac: float = 1.0):
        rho = np.asarray(offered_gbps) / self.payload_gbps(read_frac)
        return self.queue(read_frac).latency_ns(rho)


@dataclasses.dataclass(frozen=True)
class TimingConfig:
    """Top-level timing: one DRAM path + one CXL path per region.

    This is the object users calibrate (paper §V) and everything downstream
    (machine model, tiering planner, roofline `cxl` term) consumes.
    """
    dram: DramTiming = dataclasses.field(default_factory=DramTiming)
    cxl: CXLTiming = dataclasses.field(default_factory=CXLTiming)
    ssd: SSDTiming = dataclasses.field(default_factory=SSDTiming)

    def idle_latency_ns(self, kind: str) -> float:
        if kind == "dram":
            return self.dram.idle_ns
        if kind == "cxl":
            return self.cxl.idle_ns
        if kind == "ssd":
            return self.ssd.idle_ns
        raise ValueError(kind)

    def peak_gbps(self, kind: str, read_frac: float = 1.0) -> float:
        if kind == "dram":
            return self.dram.peak_gbps
        if kind == "cxl":
            return self.cxl.payload_gbps(read_frac)
        if kind == "ssd":
            return self.ssd.payload_gbps(read_frac)
        raise ValueError(kind)

    def loaded_latency_ns(self, kind: str, offered_gbps,
                          read_frac: float = 1.0):
        if kind == "dram":
            return self.dram.loaded_latency_ns(offered_gbps)
        if kind == "cxl":
            return self.cxl.loaded_latency_ns(offered_gbps, read_frac)
        if kind == "ssd":
            return self.ssd.loaded_latency_ns(offered_gbps, read_frac)
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# Calibration — fit stage latencies to measured hardware points
# ---------------------------------------------------------------------------
def calibrate(points: Sequence[Tuple[float, float]],
              base: CXLTiming | None = None,
              peak_gbps_hint: float | None = None) -> CXLTiming:
    """Fit (idle_ns, service_ns, backend bw) to measured (gbps, latency_ns).

    Least squares on the M/D/1 curve: latency = idle + s * rho/(2(1-rho)).
    With x_i = rho_i/(2(1-rho_i)) this is linear in (idle, s).

    Args:
      points: measured (offered_gbps, loaded_latency_ns) pairs, e.g. from an
        Intel MLC sweep against the real expander card.
      base: starting timing (pipeline split ratios preserved).
      peak_gbps_hint: measured saturation bandwidth; defaults to 1.05x the
        max offered load seen.
    """
    base = base or CXLTiming()
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2 or len(pts) < 2:
        raise ValueError("need >=2 (gbps, latency_ns) points")
    peak = peak_gbps_hint or 1.05 * float(pts[:, 0].max())
    rho = np.clip(pts[:, 0] / peak, 0.0, 0.98)
    x = rho / (2.0 * (1.0 - rho))
    A = np.stack([np.ones_like(x), x], axis=1)
    (idle_fit, service_fit), *_ = np.linalg.lstsq(A, pts[:, 1], rcond=None)
    idle_fit = float(max(idle_fit, 1.0))
    service_fit = float(max(service_fit, 1.0))
    # distribute the fitted idle over the pipeline in the base's proportions
    base_overhead = base.idle_ns - spec.DRAM_IDLE_LATENCY_NS / 2
    scale = max(idle_fit - spec.DRAM_IDLE_LATENCY_NS / 2, 1.0) / base_overhead
    # back out backend bandwidth from the observed knee
    backend = max(peak, 1.0)
    return dataclasses.replace(
        base,
        packetize_ns=base.packetize_ns * scale,
        link_prop_ns=base.link_prop_ns * scale,
        depacketize_ns=base.depacketize_ns * scale,
        backend_ns=base.backend_ns * scale,
        service_ns=service_fit,
        backend_gbps=backend,
    )


def latency_bandwidth_curve(cfg: TimingConfig, kind: str,
                            n: int = 32, read_frac: float = 1.0
                            ) -> np.ndarray:
    """(n, 3) [offered_gbps, achieved_gbps, latency_ns] — the classic
    'banana curve' used for hardware calibration (cf. MESS benchmarking)."""
    peak = cfg.peak_gbps(kind, read_frac)
    offered = np.linspace(0.02, 1.25, n) * peak
    achieved = np.minimum(offered, peak * 0.98)
    lat = cfg.loaded_latency_ns(kind, offered) if kind == "dram" \
        else cfg.loaded_latency_ns(kind, offered, read_frac)
    return np.stack([offered, achieved, np.asarray(lat)], axis=1)
