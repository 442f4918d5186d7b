"""Shared layers: norms, MLPs, embeddings, init helpers.

Parameters are plain nested dicts of tensors (bf16 by default) under the
JAX package's names (``wiu``, ``wo``, ``scale``, ``table``, ``w``), so a
parameter tree maps one to one; every layer is a function
``f(params, x, ...) -> y``.  Matmuls accumulate in f32 and return
``x.dtype``; norms compute in f32.

Initializers take an explicit ``torch.Generator`` and draw from the same
distributions as the reference (truncated normal on [-2, 2] scaled by
``fan_in ** -0.5``; normal x 0.02 for embeddings), in f32 on the
generator's device, then cast.  They do not reproduce ``jax.random``'s
bits: tests carry the JAX weights over with :func:`repro_torch.convert.
model_params`.  Given a :class:`ShapeOnly` in place of the generator they
lay the same leaves out on the meta device and draw nothing
(:func:`repro_torch.models.transformer.param_shapes`).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import BATCH, MODEL, shard

F32 = torch.float32


class ShapeOnly:
    """Stands in for the initializers' generator: every leaf is made on
    the meta device (its shape and dtype, no storage) and nothing is
    drawn, so a full-width tree costs no memory."""
    device = torch.device("meta")


def randn(gen, shape) -> torch.Tensor:
    """A standard normal f32 draw of `shape` on the generator's device."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(tuple(shape), dtype=F32, device=gen.device)
    return torch.randn(tuple(shape), generator=gen, dtype=F32,
                       device=gen.device)


def pdtype(cfg) -> torch.dtype:
    """The parameter dtype named by ``cfg.dtype`` ("bfloat16", "float32")."""
    return getattr(torch, cfg.dtype)


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.bfloat16) -> torch.Tensor:
    """LeCun-normal fan-in init, on the generator's device (drawn and
    scaled in place in f32: one f32 copy of the leaf at a time, 30 GB for
    deepseek-v3-671b's (256, 7168, 4096) experts)."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    w = torch.empty(tuple(shape), dtype=F32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(fan_in ** -0.5).to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, reduce_dtype=None
           ) -> torch.Tensor:
    """x @ w with f32 accumulation, result in x.dtype.

    `reduce_dtype` is accepted for the reference's signature and has no
    effect: in the JAX package it sets the wire format of a cross-shard
    partial-sum all-reduce, and on one card there is no such reduction —
    the product is the same f32-accumulated sum rounded to ``x.dtype``.
    """
    return torch.matmul(x, w.to(x.dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, device=None) -> Dict:
    return {"scale": torch.ones((d,), dtype=F32, device=device)}


def rmsnorm(params: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d: int, f: int,
             dtype=torch.bfloat16) -> Dict:
    return {
        # fused gate+up, as the reference
        "wiu": dense_init(gen, (d, 2 * f), dtype=dtype),
        "wo": dense_init(gen, (f, d), dtype=dtype),      # down
    }


def mlp(params: Dict, x: torch.Tensor, act: str = "silu",
        reduce_bf16: bool = False) -> torch.Tensor:
    f = params["wo"].shape[0]
    gu = matmul(x, params["wiu"])
    g, u = gu[..., :f], gu[..., f:]
    g = shard(g, BATCH, None, MODEL)
    fn = F.silu if act == "silu" else (lambda t: F.gelu(t, approximate="tanh"))
    h = fn(g.to(F32)).to(x.dtype) * u
    out = matmul(h, params["wo"],
                 reduce_dtype=x.dtype if reduce_bf16 else None)
    return shard(out, BATCH, None, None)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def embed_init(gen: torch.Generator, vocab: int, d: int,
               n_codebooks: int = 1, dtype=torch.bfloat16) -> Dict:
    shape = (vocab, d) if n_codebooks == 1 else (n_codebooks, vocab, d)
    if isinstance(gen, ShapeOnly):
        return {"table": torch.empty(shape, dtype=dtype, device=gen.device)}
    t = torch.empty(shape, dtype=F32, device=gen.device)
    torch.nn.init.normal_(t, 0.0, 1.0, generator=gen)
    return {"table": (t * 0.02).to(dtype)}


def embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D); or (B, C, S) with per-codebook tables
    summed (multi-stream input)."""
    table = params["table"]
    if table.ndim == 2:
        return table[tokens]
    out = torch.zeros(tokens.shape[:1] + tokens.shape[2:] + table.shape[-1:],
                      dtype=table.dtype, device=table.device)
    for c in range(table.shape[0]):
        out = out + table[c][tokens[:, c]]
    return out


def head_init(gen: torch.Generator, d: int, vocab: int,
              n_codebooks: int = 1, dtype=torch.bfloat16) -> Dict:
    shape = (d, vocab) if n_codebooks == 1 else (n_codebooks, d, vocab)
    return {"w": dense_init(gen, shape, in_axis=-2, dtype=dtype)}


def lm_head(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) -> logits (B,S,V) or (B,S,C,V) for multi-codebook heads."""
    w = params["w"].to(x.dtype)
    if w.ndim == 2:
        return shard(torch.matmul(x, w), BATCH, None, MODEL)
    logits = torch.einsum("bsd,cdv->bscv", x, w)
    return shard(logits, BATCH, None, None, MODEL)


def sinusoidal_positions(seq: int, d: int, offset=0, device=None
                         ) -> torch.Tensor:
    """MusicGen-style sinusoidal position embedding (f32)."""
    pos = (torch.arange(seq, dtype=F32, device=device) + offset)[:, None]
    dim = torch.arange(0, d, 2, dtype=F32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10_000.0, device=device), dim / d)
    pe = torch.zeros((seq, d), dtype=F32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe
