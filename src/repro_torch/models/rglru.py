"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU.

The port of ``repro.models.rglru``, the Real-Gated Linear Recurrent Unit
(arXiv:2402.19427):

    i_t = sigmoid(W_i x_t + b_i)            (input gate)
    r_t = sigmoid(W_r x_t + b_r)            (recurrence gate)
    a_t = exp(-c * softplus(L) * r_t)       (data-dependent decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Over a sequence the diagonal linear recurrence is a log-depth scan
(:func:`_associative_scan`), the even/odd recursion of
``jax.lax.associative_scan`` that the reference calls, written in tensor
ops so that autograd flows through it; decode takes one explicit step.
The surrounding block is Griffin's: branch gate (GeLU, tanh form, as
``jax.nn.gelu``'s default) x [linear -> causal depthwise conv (width 4)
-> RG-LRU] -> output projection.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, pdtype, randn

F32 = torch.float32
C_DECAY = 8.0


def rglru_init(gen: torch.Generator, cfg) -> Dict:
    d, w = cfg.d_model, cfg.lru_width
    dt = pdtype(cfg)
    dev = gen.device
    conv = randn(gen, (cfg.conv_width, w))
    return {
        "wx": dense_init(gen, (d, w), dtype=dt),          # recurrent branch
        "wgate": dense_init(gen, (d, w), dtype=dt),       # GeLU gate branch
        "conv_w": conv * (cfg.conv_width * w) ** -0.5,
        "conv_b": torch.zeros((w,), dtype=F32, device=dev),
        "wi": dense_init(gen, (w, w), dtype=dt),          # input gate
        "bi": torch.zeros((w,), dtype=F32, device=dev),
        "wr": dense_init(gen, (w, w), dtype=dt),          # recurrence gate
        "br": torch.zeros((w,), dtype=F32, device=dev),
        "lam": torch.full((w,), 2.0, dtype=F32, device=dev),  # softplus(L)>0
        "wo": dense_init(gen, (w, d), dtype=dt),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 hist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time via shifted adds.

    x (B,T,W); w (cw, W); hist (B, cw-1, W) carries the previous tokens.
    Returns (y (B,T,W), new hist: the last cw - 1 rows of hist and x)."""
    cw = w.shape[0]
    xf = x.to(F32)
    ext = torch.cat([hist.to(F32), xf], dim=1)              # (B, T+cw-1, W)
    t = x.shape[1]
    y = torch.zeros_like(xf)
    for j in range(cw):
        y = y + ext[:, j:j + t] * w[j]
    return (y + b).to(x.dtype), ext[:, -(cw - 1):].to(x.dtype)


def _rglru_gates(p: Dict, u: torch.Tensor):
    uf = u.to(F32)
    i = torch.sigmoid((u @ p["wi"]).to(F32) + p["bi"])
    r = torch.sigmoid((u @ p["wr"]).to(F32) + p["br"])
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    log_a = -C_DECAY * softplus * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * uf)
    return a, b


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along dim 1; len(a) is len(b) or one
    more."""
    n = b.shape[1]
    out = torch.stack([a[:, :n], b], dim=2).reshape(
        a.shape[0], 2 * n, *a.shape[2:])
    return torch.cat([out, a[:, n:]], dim=1) if a.shape[1] > n else out


def _associative_scan(combine: Callable, elems: Tuple[torch.Tensor, ...]
                      ) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of `elems` along dim 1 under the associative
    `combine`, by ``jax.lax.associative_scan``'s recursion: combine
    adjacent pairs, scan the pairs (the odd positions), then combine each
    odd result with the next even element.  log2(T) levels, a few tensor
    ops each, the same combines in the same order as the reference."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = combine(tuple(e[:, 0:n - 1:2] for e in elems),
                      tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine(tuple(e[:, :-1] for e in odd),
                       tuple(e[:, 2::2] for e in elems))
    else:
        even = combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def rglru_scan(p: Dict, u: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence form. u (B,T,W); h0 (B,W) -> (h (B,T,W), h_last (f32))."""
    a, b = _rglru_gates(p, u)
    # fold h0 into the first step: b_0 += a_0 * h0
    b = torch.cat([(b[:, 0] + a[:, 0] * h0.to(F32))[:, None], b[:, 1:]],
                  dim=1)
    _, h = _associative_scan(_combine, (a, b))
    return h.to(u.dtype), h[:, -1]


def rglru_step(p: Dict, u: torch.Tensor, h_prev: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. u (B,W); h_prev (B,W)."""
    a, b = _rglru_gates(p, u[:, None, :])
    h = a[:, 0] * h_prev.to(F32) + b[:, 0]
    return h.to(u.dtype), h


def recurrent_block(p: Dict, x: torch.Tensor, state: Dict, cfg
                    ) -> Tuple[torch.Tensor, Dict]:
    """Griffin recurrent block over a sequence. state {h: (B,W) f32,
    conv: (B,cw-1,W)}."""
    gate = _gelu((x @ p["wgate"]).to(F32))
    u = x @ p["wx"]
    u, conv_hist = _causal_conv(u, p["conv_w"], p["conv_b"], state["conv"])
    h, h_last = rglru_scan(p, u, state["h"])
    y = (gate.to(x.dtype) * h) @ p["wo"]
    return y, {"h": h_last, "conv": conv_hist}


def recurrent_block_step(p: Dict, x: torch.Tensor, state: Dict, cfg
                         ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x (B,1,D)."""
    gate = _gelu((x[:, 0] @ p["wgate"]).to(F32))
    u = x[:, 0] @ p["wx"]
    # conv over (hist, u)
    ext = torch.cat([state["conv"].to(F32), u.to(F32)[:, None, :]],
                    dim=1)                                  # (B,cw,W)
    uc = torch.einsum("bcw,cw->bw", ext, p["conv_w"]) + p["conv_b"]
    h, h_new = rglru_step(p, uc.to(u.dtype), state["h"])
    y = ((gate.to(x.dtype) * h) @ p["wo"])[:, None, :]
    return y, {"h": h_new, "conv": ext[:, 1:].to(x.dtype)}


def rglru_state_init(cfg, batch: int, device=None) -> Dict:
    w = cfg.lru_width
    return {"h": torch.zeros((batch, w), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                dtype=pdtype(cfg), device=device)}
