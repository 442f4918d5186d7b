"""Rotary position embeddings: standard RoPE (optionally YaRN-scaled) and
Qwen2-VL M-RoPE.

M-RoPE splits each head's rotary dims into (temporal, height, width)
sections with independent position streams; pure-text positions
replicate the temporal stream.

YaRN (DeepSeek-V3's ``rope_scaling``), as DeepSeek-V3's own inference code
(``inference/model.py``, ``precompute_freqs_cis``) computes it: the
inverse frequencies of the rotary pairs between ``floor(corr(beta_fast))``
and ``ceil(corr(beta_slow))`` blend linearly from ``theta``'s to
``theta``'s divided by ``factor`` (pairs below keep theirs, pairs above
are divided), with ``corr(n) = dim * ln(original / (2 pi n)) / (2 ln
theta)``; cos and sin are scaled by ``mscale(factor, mscale) /
mscale(factor, mscale_all_dim)``, and the attention's softmax scale by
:func:`yarn_softmax_factor`.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

F32 = torch.float32


def yarn_mscale(factor: float, mscale: float) -> float:
    """``0.1 * mscale * ln(factor) + 1`` (1 where ``factor <= 1``)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_softmax_factor(scaling) -> float:
    """The factor on an attention's softmax scale: ``mscale(factor,
    mscale_all_dim) ** 2``, 1 without scaling."""
    if scaling is None:
        return 1.0
    return yarn_mscale(scaling.factor, scaling.mscale_all_dim) ** 2


def yarn_ramp(head_dim: int, theta: float, scaling) -> Tuple[int, int]:
    """(first, last) rotary pair of YaRN's blend: ``floor(corr(beta_fast))``
    and ``ceil(corr(beta_slow))``, clamped to [0, head_dim - 1]."""
    def corr(n):
        return head_dim * math.log(scaling.original_max_position
                                   / (n * 2 * math.pi)) / (2 * math.log(theta))
    return (max(math.floor(corr(scaling.beta_fast)), 0),
            min(math.ceil(corr(scaling.beta_slow)), head_dim - 1))


def rope_freqs(head_dim: int, theta: float, device=None,
               scaling=None) -> torch.Tensor:
    """Inverse frequencies (head_dim / 2,) of the rotary pairs, YaRN-blended
    under `scaling`."""
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    freqs = 1.0 / (theta ** exps)
    if scaling is None:
        return freqs
    lo, hi = yarn_ramp(head_dim, theta, scaling)
    ramp = ((torch.arange(head_dim // 2, dtype=F32, device=device) - lo)
            / max(hi - lo, 0.001)).clamp(0.0, 1.0)
    return freqs / scaling.factor * ramp + freqs * (1.0 - ramp)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin,
                      x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling=None) -> torch.Tensor:
    """x (B, S, N, H); positions (B, S) -> rotated x (YaRN under
    `scaling`, a :class:`~repro_torch.configs.base.YarnConfig`)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device, scaling)   # (H/2,)
    angle = positions.to(F32)[..., None] * freqs            # (B, S, H/2)
    cos = torch.cos(angle)[..., None, :]                    # (B, S, 1, H/2)
    sin = torch.sin(angle)[..., None, :]
    if scaling is not None:
        amp = (yarn_mscale(scaling.factor, scaling.mscale)
               / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        if amp != 1.0:
            cos, sin = cos * amp, sin * amp
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
