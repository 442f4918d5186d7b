"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

M-RoPE splits each head's rotary dims into (temporal, height, width)
sections with independent position streams; pure-text positions
replicate the temporal stream.
"""
from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x (B, S, N, H); positions (B, S) -> rotated x."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (H/2,)
    angle = positions.to(F32)[..., None] * freqs            # (B, S, H/2)
    cos = torch.cos(angle)[..., None, :]                    # (B, S, 1, H/2)
    sin = torch.sin(angle)[..., None, :]
    return _rotate(x, cos, sin)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL M-RoPE. x (B,S,N,H); positions (3,B,S); sections sum to H/2."""
    h = x.shape[-1]
    if sum(sections) != h // 2:
        raise ValueError(
            f"mrope sections must cover half dim: sum={sum(sections)} "
            f"h//2={h // 2}")
    freqs = rope_freqs(h, theta, x.device)                  # (H/2,)
    stream = torch.cat([torch.full((s,), i, dtype=torch.long,
                                   device=x.device)
                        for i, s in enumerate(sections)])
    angle_all = positions.to(F32)[..., None] * freqs        # (3, B, S, H/2)
    # frequency slot j takes position stream stream[j]
    angle = angle_all[stream, ..., torch.arange(h // 2, device=x.device)]
    angle = torch.movedim(angle, 0, -1)                     # (B, S, H/2)
    cos = torch.cos(angle)[..., None, :]
    sin = torch.sin(angle)[..., None, :]
    return _rotate(x, cos, sin)


def text_mrope_positions(b: int, s: int, offset: int = 0, device=None
                         ) -> torch.Tensor:
    """Pure-text M-RoPE positions: all three streams identical."""
    p = torch.arange(offset, offset + s, dtype=torch.int32,
                     device=device)[None, :].repeat(b, 1)
    return torch.stack([p, p, p], dim=0)
