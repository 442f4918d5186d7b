"""CXL switch modeling (the paper's v2.0 roadmap, implemented here).

A CXL 2.0 switch sits between a host-bridge root port and multiple
endpoints: one **upstream switch port (USP)** shares its link bandwidth
among N **downstream switch ports (DSPs)**.  Two effects matter at system
level and are modeled:

  * **latency**: each switch hop adds a store-and-forward + arbitration
    delay on both the request and response path (~2 x hop_ns);
  * **bandwidth contention**: the upstream link is the shared bottleneck —
    aggregate payload across all endpoints below the switch saturates at
    the USP's payload bandwidth, and the loaded-latency queue forms at the
    USP, not at each device.

:func:`fanout_timing` derives the effective per-endpoint
:class:`~repro_torch.core.timing.CXLTiming` seen through a switch, so everything
downstream (machine model, tiering planner, roofline `cxl` term) works
unchanged — pass the derived timing instead of the direct-attach one.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.timing import CXLTiming, QueueModel


@dataclasses.dataclass(frozen=True)
class SwitchConfig:
    """One-level CXL 2.0 switch below a root port."""
    n_downstream: int = 4          # endpoints below the switch
    hop_ns: float = 35.0           # per-traversal store&forward + arbitration
    usp_lanes: int = 16            # upstream link width
    usp_pcie_gen: int = 5
    service_ns: float = 40.0       # USP arbitration service quantum


def usp_payload_gbps(sw: SwitchConfig) -> float:
    """Payload bandwidth of the upstream switch port (wire-only: the USP
    has no media backend of its own) — the shared ceiling every consumer
    of the switch model prices contention against."""
    return CXLTiming(lanes=sw.usp_lanes, pcie_gen=sw.usp_pcie_gen,
                     backend_gbps=1e9).payload_read_gbps


def fanout_timing(base: CXLTiming, sw: SwitchConfig) -> CXLTiming:
    """Effective endpoint timing when attached through the switch.

    Latency: +2 hops (request + response traverse the switch).
    Bandwidth: min(device path, USP share). The share is the *fair* share
    at full contention (USP payload / N); burst access to an idle switch
    still reaches the device's own bandwidth — the queue model covers the
    region in between.
    """
    share = usp_payload_gbps(sw) / max(sw.n_downstream, 1)
    return dataclasses.replace(
        base,
        link_prop_ns=base.link_prop_ns + 2 * sw.hop_ns,
        backend_gbps=min(base.backend_gbps, share),
        service_ns=base.service_ns + sw.service_ns,
    )


def shared_usp_latency_ns(eff: CXLTiming, usp_payload: float,
                          aggregate_offered_gbps) -> np.ndarray:
    """Loaded latency of a switched endpoint at aggregate USP utilization.

    The shared USP queue sees the whole group's load: the endpoint's
    latency is its switched idle path plus the queue delay at
    `aggregate / usp_payload` utilization — the head-of-line coupling that
    makes switched pools slower than per-device curves suggest.  This is
    the single formula both :func:`usp_loaded_latency_ns` and the
    machine-model fixed point (`machine.time_batch`) price groups with.
    """
    rho = np.asarray(aggregate_offered_gbps, np.float64) / usp_payload
    q = QueueModel(idle_ns=eff.idle_ns, service_ns=eff.service_ns)
    return np.asarray(q.latency_ns(rho), np.float64)


def usp_loaded_latency_ns(base: CXLTiming, sw: SwitchConfig,
                          per_endpoint_gbps: List[float]) -> np.ndarray:
    """Loaded latency per endpoint when all of them offer load at once."""
    eff = fanout_timing(base, sw)
    total = float(np.sum(per_endpoint_gbps))
    lat = shared_usp_latency_ns(eff, usp_payload_gbps(sw), total)
    return np.asarray([float(lat)] * len(per_endpoint_gbps))


def pooled_capacity_per_node(capacities: List[int]) -> int:
    return int(np.sum(capacities))
