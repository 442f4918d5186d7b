"""RWKV6 "Finch" blocks: data-dependent-decay time-mix + channel-mix.

The port of ``repro.models.rwkv`` (arXiv:2404.05892):

  time-mix: token-shift ddlerp (5-way LoRA-modulated mixing), projections
  r/k/v/gate, a **data-dependent per-channel decay** w_t = exp(-exp(w0 +
  lora(x))), bonus u, and the WKV6 recurrence per head (hd x hd state):

      y_t[j] = sum_i r_i (S[i,j] + u_i k_i v_j)
      S'     = diag(w_t) S + k_t v_t^T

  channel-mix: token-shifted squared-ReLU FFN gated by sigmoid(r).

The recurrence runs as a loop of steps over time, or, when ``cfg.
rwkv_chunk`` divides a longer sequence, as the reference's chunk-parallel
form (:func:`_wkv_chunked`, the state's update looped over chunks).  The reference has
no kernel for either (``lax.scan`` and jnp), so neither has one here.
Decode carries ``{tm_shift, cm_shift, S}`` explicitly; no KV cache exists.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, pdtype, randn,
                                       rmsnorm_init)

F32 = torch.float32
LORA_MIX = 32
LORA_DECAY = 64


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return randn(gen, shape) * std


def timemix_init(gen: torch.Generator, cfg) -> Dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    dt = pdtype(cfg)
    dev = gen.device
    return {
        "mu_x": torch.zeros((d,), dtype=F32, device=dev),
        "mu": torch.zeros((5, d), dtype=F32, device=dev),
        "mix_a": dense_init(gen, (d, 5 * LORA_MIX), dtype=F32),
        "mix_b": _normal(gen, (5, LORA_MIX, d), 0.01),
        "w0": torch.full((d,), -6.0, dtype=F32, device=dev),
        "decay_a": dense_init(gen, (d, LORA_DECAY), dtype=F32),
        "decay_b": _normal(gen, (LORA_DECAY, d), 0.01),
        "u": torch.zeros((h, hd), dtype=F32, device=dev),
        "wr": dense_init(gen, (d, d), dtype=dt),
        "wk": dense_init(gen, (d, d), dtype=dt),
        "wv": dense_init(gen, (d, d), dtype=dt),
        "wg": dense_init(gen, (d, d), dtype=dt),
        "wo": dense_init(gen, (d, d), dtype=dt),
        "ln_x": rmsnorm_init(d, dev),   # per-head group norm, as RMS
    }


def channelmix_init(gen: torch.Generator, cfg) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = pdtype(cfg)
    dev = gen.device
    return {
        "mu_k": torch.zeros((d,), dtype=F32, device=dev),
        "mu_r": torch.zeros((d,), dtype=F32, device=dev),
        "wk": dense_init(gen, (d, f), dtype=dt),
        "wv": dense_init(gen, (f, d), dtype=dt),
        "wr": dense_init(gen, (d, d), dtype=dt),
    }


def _ddlerp(p: Dict, x: torch.Tensor, x_prev: torch.Tensor
            ) -> Tuple[torch.Tensor, ...]:
    """Data-dependent token-shift interpolation -> 5 mixed streams, each
    computed in f32 and cast to ``x.dtype``."""
    xf, pf = x.to(F32), x_prev.to(F32)
    xx = pf - xf
    base = xf + xx * p["mu_x"]
    lora = torch.tanh(base @ p["mix_a"])                  # (..., 5*32)
    lora = lora.reshape(*lora.shape[:-1], 5, LORA_MIX)
    delta = torch.einsum("...nl,nld->...nd", lora, p["mix_b"])  # (...,5,D)
    mixed = xf[..., None, :] + xx[..., None, :] * (p["mu"] + delta)
    return tuple(mixed[..., i, :].to(x.dtype) for i in range(5))


def _wkv_step(S: torch.Tensor, r, k, v, w, u
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One WKV6 step. S (B,H,hd,hd); r/k/v/w (B,H,hd); u (B,H,hd)."""
    # y_j = sum_i r_i (S_ij + u_i k_i v_j)
    y = torch.einsum("bhi,bhij->bhj", r, S) \
        + torch.einsum("bhi,bhi,bhi,bhj->bhj", r, u, k, v)
    S = S * w[..., None] + k[..., None] * v[..., None, :]
    return S, y


def timemix(p: Dict, x: torch.Tensor, x_prev_last: torch.Tensor,
            S0: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Time-mix over a sequence. x (B,T,D); x_prev_last (B,D) shift-in
    state; S0 (B,H,hd,hd). Returns (y, new shift state, new S (f32))."""
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    x_prev = torch.cat([x_prev_last[:, None, :].to(x.dtype), x[:, :-1]],
                       dim=1)
    mw, mk, mv, mr, mg = _ddlerp(p, x, x_prev)
    r = (mr @ p["wr"]).reshape(b, t, h, hd).to(F32)
    k = (mk @ p["wk"]).reshape(b, t, h, hd).to(F32)
    v = (mv @ p["wv"]).reshape(b, t, h, hd).to(F32)
    g = F.silu((mg @ p["wg"]).to(F32))
    w = torch.exp(-torch.exp(
        p["w0"] + torch.tanh(mw.to(F32) @ p["decay_a"]) @ p["decay_b"]))
    w = w.reshape(b, t, h, hd)
    u = p["u"].expand(b, h, hd)

    chunk = cfg.rwkv_chunk
    if chunk and t > chunk and t % chunk == 0:
        y, S = _wkv_chunked(r, k, v, w, u, S0.to(F32), chunk)
    else:
        S = S0.to(F32)
        ys = []
        for i in range(t):
            S, y_i = _wkv_step(S, r[:, i], k[:, i], v[:, i], w[:, i], u)
            ys.append(y_i)
        y = torch.stack(ys, dim=1)                          # (B,T,H,hd)
    # per-head norm (grouped RMS) then gate
    yh = y.reshape(b, t, h, hd)
    var = torch.mean(yh * yh, dim=-1, keepdim=True)
    yh = yh * torch.rsqrt(var + cfg.norm_eps)
    y = (yh.reshape(b, t, d) * p["ln_x"]["scale"] * g).to(x.dtype)
    out = (y @ p["wo"]).to(x.dtype)
    return out, x[:, -1], S


def channelmix(p: Dict, x: torch.Tensor, x_prev_last: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-mix. x (B,T,D) -> (y, new shift state)."""
    xf = x.to(F32)
    x_prev = torch.cat([x_prev_last[:, None, :].to(F32), xf[:, :-1]], dim=1)
    xx = x_prev - xf
    xk = (xf + xx * p["mu_k"]).to(x.dtype)
    xr = (xf + xx * p["mu_r"]).to(x.dtype)
    k = torch.square(F.relu((xk @ p["wk"]).to(F32))).to(x.dtype)
    kv = k @ p["wv"]
    out = torch.sigmoid((xr @ p["wr"]).to(F32)).to(x.dtype) * kv
    return out, x[:, -1]


def _wkv_chunked(r, k, v, w, u, S0, chunk: int):
    """Chunk-parallel WKV6: the carried state takes one step per chunk of
    `chunk` tokens.

    The chunked linear-attention decomposition with per-channel decay
    products p_t = prod_{s<t} w_s inside each chunk:

        y_t = (r_t p_t) S_chunk + sum_{s<t} (r_t p_t / (p_s w_s)) k_s v_s^T
              + (r_t u k_t) v_t                       [diag bonus]
        S'  = diag(p_C) S + (k p_C/(p w))^T v

    The reference's expressions, with every term that does not read the
    carried state computed for all chunks at once; the loop over chunks
    is then only the state's update (a Python loop of ~20 operations a
    chunk would cost some 10^5 launches a 4096-token training step).
    r, k, v, w (B,T,H,hd) f32; u (B,H,hd); S0 (B,H,hd,hd) f32.  Equals the
    step scan up to rounding.
    """
    b, t, h, hd = r.shape
    if t % chunk != 0:
        raise ValueError(f"seq len {t} must be a multiple of chunk {chunk}")
    nc = t // chunk
    rs, ks, vs = (x.reshape(b, nc, chunk, h, hd) for x in (r, k, v))
    lw = torch.log(torch.clamp(w, min=1e-12)).reshape(b, nc, chunk, h, hd)
    cum = torch.cumsum(lw, dim=2)
    p = torch.exp(cum - lw)                     # exclusive prod_{s<t} w_s
    p_end = torch.exp(cum[:, :, -1])            # (B,nc,H,hd)
    rp = rs * p
    inv = torch.exp(-cum)                       # 1 / (p*w)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=F32, device=r.device),
                     diagonal=-1)
    att = torch.einsum("bnchi,bndhi->bnhcd", rp, ks * inv) * tri
    intra = torch.einsum("bnhcd,bndhj->bnchj", att, vs)
    diag = torch.einsum("bnchi,bnchi->bnch", rs * u[:, None, None], ks)
    kv = torch.einsum("bnchi,bnchj->bnhij",
                      ks * (p_end[:, :, None] * inv), vs)
    states = []                                 # S entering each chunk
    S = S0
    for n in range(nc):
        states.append(S)
        S = S * p_end[:, n, ..., None] + kv[:, n]
    inter = torch.einsum("bnchi,bnhij->bnchj", rp, torch.stack(states, 1))
    y = inter + intra + diag[..., None] * vs
    return y.reshape(b, t, h, hd), S


def rwkv_state_init(cfg, batch: int, device=None) -> Dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    dt = pdtype(cfg)
    return {
        "tm_shift": torch.zeros((batch, d), dtype=dt, device=device),
        "cm_shift": torch.zeros((batch, d), dtype=dt, device=device),
        "S": torch.zeros((batch, h, hd, hd), dtype=F32, device=device),
    }
