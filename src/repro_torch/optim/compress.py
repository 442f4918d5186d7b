"""Gradient compression with error feedback (int8 + per-tensor scale).

The port of ``repro.optim.compress``: quantize each gradient tensor to
int8 with a per-tensor absmax scale and carry the quantization residual
forward (error feedback).  ``torch.round`` rounds half to even, as
``jnp.round`` does, so in f32 the payload, the scales and the residuals
equal the reference's bit for bit.

    comp, ef_state = compress(grads, ef_state)   # int8 payload + residuals
    grads = decompress(comp, like=grads)
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_mod

F32 = torch.float32


class Compressed(NamedTuple):
    q: Any          # int8 tree
    scale: Any      # f32 per-tensor scales


def init_error_feedback(grads) -> Any:
    return tree_mod.tree_map(
        lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads)


def _quantize(g: torch.Tensor, err: torch.Tensor):
    corrected = g.to(F32) + err
    scale = torch.clamp(corrected.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_err = corrected - q.to(F32) * scale
    return q, scale, new_err


def compress(grads, ef_state) -> Tuple[Compressed, Any]:
    """-> (Compressed payload, new error-feedback state)."""
    out = [_quantize(g, e) for g, e in zip(tree_mod.leaves(grads),
                                           tree_mod.leaves(ef_state))]
    return (Compressed(tree_mod.unflatten(grads, [o[0] for o in out]),
                       tree_mod.unflatten(grads, [o[1] for o in out])),
            tree_mod.unflatten(grads, [o[2] for o in out]))


def decompress(comp: Compressed, like=None) -> Any:
    out = tree_mod.tree_map(lambda q, s: q.to(F32) * s, comp.q, comp.scale)
    if like is not None:
        out = tree_mod.tree_map(lambda o, l: o.to(l.dtype), out, like)
    return out


def wire_bytes(grads) -> Tuple[int, int]:
    """(uncompressed f32 bytes, compressed int8+scale bytes)."""
    leaves = tree_mod.leaves(grads)
    return (sum(g.numel() * 4 for g in leaves),
            sum(g.numel() + 4 for g in leaves))
