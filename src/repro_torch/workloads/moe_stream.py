"""MoE expert-weight streaming workload.

Capacity-bound MoE serving keeps the full expert pool in CXL-expanded
memory and streams the routed experts' weights per token — the second LLM
use-case the paper motivates (DeepSeek-V3-class models whose expert pool
dwarfs HBM).  The generator takes its routing geometry
(``n_experts``/``top_k``) from a real config in :mod:`repro_torch.configs`
and scales the modeled expert size to the sweep footprint: the footprint
*is* the expert pool, and the page-placement policy decides which experts
sit in DRAM vs CXL — so sweeping policies sweeps the hot-expert pinning
ratio.

Per token, ``top_k`` experts are drawn by the seeded avalanche hash
(:func:`~repro_torch.workloads.base.mix32`) and each selected expert's
weight block is read sequentially (unit-stride within an expert, random
across experts) — bandwidth-bound like STREAM inside a block,
locality-poor across blocks like GUPS.  The torch form reduces the hash
modulo ``n_experts`` in int64 (the hash is already masked to 32 bits), so
the draws equal the uint32 remainder of the NumPy twin.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.workloads.base import (Workload, WorkloadTrace,
                                        lines_for_footprint, mix32,
                                        pages_for_lines)


@dataclasses.dataclass(frozen=True)
class MoEStream(Workload):
    """Top-k expert-weight streaming over a footprint-sized expert pool.

    Parameters
    ----------
    arch : str
        MoE architecture key (:func:`repro_torch.configs.get_config`); its
        ``MoEConfig`` supplies ``n_experts`` and ``top_k``.
    seed : int
        Router hash stream — which experts each token activates.
    sweeps : int
        Expected number of times the token stream covers the whole pool;
        the trace has ``ceil(sweeps * n_experts / top_k)`` tokens.
    """
    arch: str = "qwen3-moe-235b-a22b"
    seed: int = 2
    sweeps: int = 2

    name = "moe_stream"

    def _geometry(self, footprint_bytes: int):
        moe = get_config(self.arch).moe
        if moe is None:
            raise ValueError(f"{self.arch} has no MoE geometry")
        expert_lines = max(
            lines_for_footprint(footprint_bytes) // moe.n_experts, 1)
        tokens = max(self.sweeps * moe.n_experts // moe.top_k, 1)
        return moe.n_experts, moe.top_k, expert_lines, tokens

    def device_trace(self, footprint_bytes: int,
                     device=None) -> WorkloadTrace:
        n_experts, top_k, expert_lines, tokens = \
            self._geometry(footprint_bytes)
        draws = torch.arange(tokens * top_k, dtype=torch.int64,
                             device=device)
        expert = (mix32(draws, self.seed) % n_experts).to(torch.int32)
        addr = (expert[:, None] * expert_lines
                + torch.arange(expert_lines, dtype=torch.int32,
                               device=device)[None, :]).reshape(-1)
        return WorkloadTrace(
            addr=addr, is_write=torch.zeros_like(addr),
            n_pages=pages_for_lines(n_experts * expert_lines))

    def host_trace(self, footprint_bytes: int) -> WorkloadTrace:
        n_experts, top_k, expert_lines, tokens = \
            self._geometry(footprint_bytes)
        draws = np.arange(tokens * top_k, dtype=np.uint32)
        expert = (mix32(draws, self.seed)
                  % np.uint32(n_experts)).astype(np.int32)
        addr = (expert[:, None] * np.int32(expert_lines)
                + np.arange(expert_lines, dtype=np.int32)[None, :]
                ).reshape(-1)
        return WorkloadTrace(
            addr=addr, is_write=np.zeros(addr.shape[0], np.int32),
            n_pages=pages_for_lines(n_experts * expert_lines))
