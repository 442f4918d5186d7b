"""The plain PyTorch version of every kernel, under the JAX package's
oracle names and call forms (``repro.kernels.ref``).

Each function is the ``*_ref`` function of its kernel's module, which
tests hold the kernel against; this module only gives them the
reference's signatures, e.g. ``cache_sim(addr, n_sets, n_ways)`` with
positional geometry.  They run on the device of their inputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.cache_sim import cache_sim_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.paged_attention import paged_attention_ref
from repro_torch.kernels.stream_triad import stream_triad_ref


def cache_sim(addr: torch.Tensor, n_sets: int, n_ways: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """An LRU set-associative cache over a (N,) line-index trace:
    (hits (N,), tags (n_sets, n_ways) with -1 invalid, use clocks)."""
    return cache_sim_ref(torch.as_tensor(addr).to(torch.int32),
                         n_sets=n_sets, n_ways=n_ways)


def stream_triad(b: torch.Tensor, c: torch.Tensor, s) -> torch.Tensor:
    """``b + s * c``, with `s` rounded to ``b.dtype``."""
    return stream_triad_ref(b, c, s)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, S, D) heads, computed in f32, ends aligned."""
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               scale=scale)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    context_lens: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode attention over a paged KV pool (B, H, D)."""
    return paged_attention_ref(q, k_pages, v_pages, block_table,
                               context_lens, scale=scale)
