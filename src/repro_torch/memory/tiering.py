"""CXL-tier memory planner: price and place framework objects across
{HBM, host DRAM, CXL pool}.

This is the paper's technique operating as a first-class framework feature
(DESIGN.md §2): the same latency/bandwidth model users calibrate for the
simulator (:class:`repro_torch.core.timing.TimingConfig`) prices every byte the
training/serving runtime wants to keep off-HBM:

  * training: when (weights + grads + optimizer + activations) / device
    exceeds the HBM budget, optimizer moments spill — v first (touched once
    per step), then m — to host DRAM and then the CXL pool, exactly like the
    zNUMA/flat placement policies place pages in the simulator;
  * serving: KV-cache pages beyond the HBM budget live in the CXL pool; the
    planner bounds achievable tokens/s by the CXL read bandwidth and reports
    the max context servable at a target per-token latency.

The plan feeds the roofline's fourth (`cxl`) term and the offload schedule
(:mod:`repro_torch.memory.offload`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spec
from repro_torch.core.numa import PAGE_BYTES
from repro_torch.core.tiering_dyn import DynamicTiering
from repro_torch.core.timing import TimingConfig
from repro_torch.core.topology import GiB


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Per-host capacities/bandwidths below HBM — the one shared spec.

    Units are explicit and match :class:`repro_torch.core.timing.TimingConfig`
    throughout: every ``*_bytes`` field is **bytes**, every ``*_gbps``
    field is **GB/s** (= bytes/ns), never the raw bytes/s of the
    ``repro_torch.core.spec`` hardware constants (``H100_PCIE_GBPS`` et al.
    are bytes/s and get converted exactly once, here).  Both the static
    planner below and the dynamic tierer
    (:class:`repro_torch.core.tiering_dyn.DynamicTiering`, via
    :func:`dynamic_tiering`) draw their DRAM/CXL capacities from this
    spec instead of re-declaring constants.

    The default describes the card the port runs on, one H100 SXM per host
    (its data sheet's HBM and PCIe figures); the host's DRAM and CXL pool
    are the JAX package's.  :data:`TPU_V5E` is the JAX package's default,
    a TPU v5e host, field for field.
    """
    hbm_bytes_per_device: int = int(spec.H100_HBM_BYTES)
    hbm_reserved_frac: float = 0.10          # runtime/fragmentation reserve
    devices_per_host: int = 1                # one card
    host_dram_bytes: int = 128 * GiB         # bytes
    cxl_bytes: int = 512 * GiB               # bytes
    # chip<->host staging path, GB/s (spec constant is bytes/s)
    host_staging_gbps: float = spec.H100_PCIE_GBPS / 1e9

    @property
    def hbm_budget(self) -> int:
        return int(self.hbm_bytes_per_device * (1 - self.hbm_reserved_frac))

    @property
    def dram_pages(self) -> int:
        """Host-DRAM capacity in 4 KiB pages (the tierer's unit)."""
        return self.host_dram_bytes // PAGE_BYTES

    @property
    def cxl_pages(self) -> int:
        """CXL-pool capacity in 4 KiB pages."""
        return self.cxl_bytes // PAGE_BYTES


#: The JAX package's ``TierSpec()``: a TPU v5e host of four chips.
TPU_V5E = TierSpec(hbm_bytes_per_device=int(spec.TPU_V5E_HBM_BYTES),
                   devices_per_host=4,
                   host_staging_gbps=spec.TPU_V5E_PCIE_GBPS / 1e9)


def dynamic_tiering(tier: Optional[TierSpec] = None,
                    dram_share: float = 1.0, **knobs) -> DynamicTiering:
    """A :class:`~repro_torch.core.tiering_dyn.DynamicTiering` whose DRAM
    capacity comes from the shared :class:`TierSpec`.

    Parameters
    ----------
    tier : TierSpec, optional
        Capacity source (default :class:`TierSpec`).
    dram_share : float
        Fraction of the host's DRAM pages this workload may claim (other
        tenants own the rest).
    **knobs
        Forwarded to :class:`~repro_torch.core.tiering_dyn.DynamicTiering`
        (``epoch_len``, ``budget``, ``threshold``).

    Returns
    -------
    DynamicTiering
        With ``dram_capacity_pages = dram_share * tier.dram_pages``.
    """
    tier = tier or TierSpec()
    cap = max(int(tier.dram_pages * dram_share), 1)
    return DynamicTiering(dram_capacity_pages=cap, **knobs)


@dataclasses.dataclass
class Placement:
    name: str
    bytes: int
    tier: str                 # 'hbm' | 'host' | 'cxl'
    touches_per_step: float   # read+write traffic multiplier


@dataclasses.dataclass
class MemoryPlan:
    placements: List[Placement]
    hbm_bytes: int
    host_bytes: int
    cxl_bytes: int
    offload_read_bytes: float      # per step / per token
    offload_write_bytes: float
    cxl_seconds: float             # the roofline 'cxl' term
    note: str = ""

    def by_tier(self) -> Dict[str, int]:
        return {"hbm": self.hbm_bytes, "host": self.host_bytes,
                "cxl": self.cxl_bytes}


def _sizes_train(cfg: ModelConfig, n_devices: int, batch: int, seq: int,
                 zero_over: int) -> Dict[str, int]:
    """Per-device object sizes for one training step."""
    n = cfg.n_params()
    shard = max(n // n_devices, 1)                    # TP(+fsdp) sharded
    zshard = max(n // (n_devices if cfg.fsdp else zero_over), 1)
    tokens_dev = batch * seq // max(n_devices // 16, 1) // 16  # dp shard
    act = tokens_dev * cfg.d_model * 2 * 2            # remat'd: ~2 live layers
    return {
        "weights": shard * 2,                         # bf16
        "grads": shard * 2,
        "opt_m": zshard * 4,
        "opt_v": zshard * 4,
        "activations": act,
    }


def plan_training(cfg: ModelConfig, *, n_devices: int = 256,
                  batch: int = 256, seq: int = 4096,
                  tier: Optional[TierSpec] = None,
                  timing: Optional[TimingConfig] = None,
                  step_compute_s: Optional[float] = None) -> MemoryPlan:
    """Greedy spill plan for a training step."""
    tier = tier or TierSpec()
    timing = timing or TimingConfig()
    sizes = _sizes_train(cfg, n_devices, batch, seq, zero_over=16)
    # spill priority: coldest first. v and m are touched once per step;
    # weights/grads/activations stay in HBM (touched per layer per pass).
    order = ["activations", "weights", "grads", "opt_m", "opt_v"]
    touches = {"activations": 2.0, "weights": 3.0, "grads": 2.0,
               "opt_m": 2.0, "opt_v": 2.0}
    budget = tier.hbm_budget
    placements: List[Placement] = []
    hbm = host = cxl = 0
    # fill HBM in priority order; spill the rest
    spill: List[str] = []
    for name in order:
        b = sizes[name]
        if hbm + b <= budget or name in ("weights", "grads", "activations"):
            hbm += b
            placements.append(Placement(name, b, "hbm", touches[name]))
        else:
            spill.append(name)
    host_free = tier.host_dram_bytes // tier.devices_per_host
    rd = wr = 0.0
    for name in spill:
        b = sizes[name]
        dest = "host" if host + b <= host_free else "cxl"
        if dest == "host":
            host += b
        else:
            cxl += b
        placements.append(Placement(name, b, dest, touches[name]))
        rd += b                                        # read moments
        wr += b                                        # write back
    # price the offload traffic: chip<->host staging in series with the
    # host-side tier (DRAM or CXL), CXL priced by the calibrated path
    stage_s = (rd + wr) / (tier.host_staging_gbps * 1e9)
    cxl_bytes_traffic = sum(p.bytes * 2 for p in placements if p.tier == "cxl")
    cxl_s = cxl_bytes_traffic / (timing.cxl.payload_gbps(0.5) * 1e9)
    host_traffic = sum(p.bytes * 2 for p in placements if p.tier == "host")
    host_s = host_traffic / (timing.dram.peak_gbps * 1e9)
    serial_s = max(stage_s, cxl_s + host_s)
    note = ""
    if step_compute_s:
        overlapped = max(0.0, serial_s - step_compute_s)
        note = (f"offload {'fully overlapped' if overlapped == 0 else f'adds {overlapped:.3f}s'}"
                f" vs compute {step_compute_s:.3f}s")
    return MemoryPlan(placements=placements, hbm_bytes=hbm, host_bytes=host,
                      cxl_bytes=cxl, offload_read_bytes=rd,
                      offload_write_bytes=wr, cxl_seconds=serial_s, note=note)


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """KV-cache bytes per token per sequence (all layers, bf16)."""
    if not cfg.kv_tiering:
        return 0
    per_layer = 0
    for kind in cfg.layer_kinds():
        if kind not in ("attn", "moe"):
            continue
        if cfg.attn_kind == "mla":
            per_layer += (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2
        else:
            per_layer += 2 * cfg.n_kv_heads * cfg.head_dim * 2
    return per_layer


def plan_serving(cfg: ModelConfig, *, n_devices: int = 256,
                 batch: int = 128, context: int = 32768,
                 tier: Optional[TierSpec] = None,
                 timing: Optional[TimingConfig] = None,
                 target_tok_latency_s: float = 0.05) -> MemoryPlan:
    """KV-cache tier split + achievable decode rate under CXL spill."""
    tier = tier or TierSpec()
    timing = timing or TimingConfig()
    bpt = kv_bytes_per_token(cfg)
    if bpt == 0:
        return MemoryPlan([], 0, 0, 0, 0.0, 0.0, 0.0,
                          note="no KV cache (attention-free) — state+optimizer "
                               "tiering only")
    weights_dev = cfg.n_params() * 2 // n_devices
    kv_total = bpt * context * batch // n_devices
    budget = tier.hbm_budget - weights_dev
    hot = min(kv_total, max(budget, 0))
    cold = kv_total - hot
    placements = [Placement("weights", weights_dev, "hbm", 1.0),
                  Placement("kv_hot", hot, "hbm", 1.0)]
    if cold:
        placements.append(Placement("kv_cold", cold, "cxl", 1.0))
    # each decoded token reads the whole context's KV once
    rd = bpt * context * (cold / max(kv_total, 1))
    cxl_s = rd / (timing.cxl.payload_read_gbps * 1e9) if cold else 0.0
    note = ""
    if cold:
        max_ctx = int(target_tok_latency_s * timing.cxl.payload_read_gbps
                      * 1e9 / max(bpt, 1))
        note = (f"cold KV on CXL: +{cxl_s*1e3:.2f} ms/token; max context at "
                f"{target_tok_latency_s*1e3:.0f} ms/token ≈ {max_ctx:,} tok")
    return MemoryPlan(placements=placements, hbm_bytes=weights_dev + hot,
                      host_bytes=0, cxl_bytes=cold, offload_read_bytes=rd,
                      offload_write_bytes=bpt, cxl_seconds=cxl_s, note=note)
