"""Attention variants: GQA (full / sliding-window) and MLA.

The port of the JAX package's ``models/attention.py``.
:func:`blockwise_attention` is the same online-softmax loop over KV chunks
in plain PyTorch (the reference computes it outside any Pallas kernel), and
:func:`decode_attention` the one-token softmax against a dense cache.  A
GQA prefill on the card runs its attention on K5 instead
(:func:`prefill_attention`, :func:`gqa_flash_attention`) where the inputs
are what K5's tensor-core kernel takes; training, the dry run's fake
tensors and every other type or width keep the loop.  Multi-head latent
attention (DeepSeek-V3's MLA) expands its latent to per-head K/V for
training and prefill, and decodes in the absorbed form (q pre-multiplied
by W_uk) against the latent cache.

Caches:
  GQA: ``{k, v: (B, S, K, hd)}``, with S = window for SWA, rolled so slot
       ``p mod window`` holds token p.
  MLA: ``{ckv: (B, S, r), krope: (B, S, p)}``, the latent cache.
:func:`attention_decode` and :func:`mla_decode` write the new token into
the cache tensors in place and return the same dict — the reference's
``dynamic_update_slice`` returns a copy; the values agree.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import (dense_init, matmul, pdtype, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.sharding import BATCH, MODEL, shard

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Blockwise attention (prefill), GQA-aware
# ---------------------------------------------------------------------------
def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        kv_chunk: int = 1024, scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Online-softmax attention. q (B,Sq,N,hd); k,v (B,Skv,K,hd) -> like q.

    Positions are end-aligned (query i sits at ``i + Skv - Sq``); a ragged
    last chunk is zero-padded and masked.  Logits and the value sum
    accumulate in f32 from products of the working type, as the
    reference's ``preferred_element_type=f32`` einsums.  The logits are
    scaled by `scale` (default ``hd ** -0.5``).
    """
    b, sq, n, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    g = n // kh
    scale = hd ** -0.5 if scale is None else scale
    kv_chunk = min(kv_chunk, skv)
    skv_pad = -(-skv // kv_chunk) * kv_chunk
    if skv_pad != skv:                      # pad + mask the tail chunk
        pad = (0, 0, 0, 0, 0, skv_pad - skv)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    qg = torch.movedim(q.reshape(b, sq, kh, g, hd), 1, 3)  # (B,K,G,Sq,hd)
    qg = (qg.to(F32) * scale).to(q.dtype).to(F32)
    dev = q.device
    qpos = torch.arange(sq, dtype=torch.int32, device=dev) + (skv - sq)

    n_chunks = skv_pad // kv_chunk
    kc = k.reshape(b, n_chunks, kv_chunk, kh, hd)
    vc = v.reshape(b, n_chunks, kv_chunk, kh, hd_v)
    m = torch.full((b, kh, g, sq), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros((b, kh, g, sq), dtype=F32, device=dev)
    acc = torch.zeros((b, kh, g, sq, hd_v), dtype=F32, device=dev)
    for j in range(n_chunks):
        kpos = j * kv_chunk + torch.arange(kv_chunk, dtype=torch.int32,
                                           device=dev)
        s = torch.einsum("bkgqd,btkd->bkgqt", qg, kc[:, j].to(F32))
        mask = (kpos < skv)[None, :]                        # pad tail
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        upd = torch.einsum("bkgqt,btkd->bkgqd", p.to(q.dtype).to(F32),
                           vc[:, j].to(F32))
        acc = acc * alpha[..., None] + upd
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = (acc / safe_l[..., None]).to(q.dtype)             # (B,K,G,Sq,hd_v)
    return torch.movedim(out, 3, 1).reshape(b, sq, n, hd_v)


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: Optional[int] = None) -> torch.Tensor:
    """Causal self-attention through K5 (:func:`fa.flash_attention`).

    q (B,S,N,hd); k,v (B,S,K,hd) -> (B,S,N,hd).  K5 takes heads
    pre-broadcast, (B, N, S, hd): query head n reads KV head n // (N // K),
    :func:`blockwise_attention`'s grouping.  K5 wants S to be a multiple of
    min(128, S), so a longer S that is not is padded at the tail with zeros
    and the output cut back: row r < S sees keys j <= r only, so no padded
    key is ever live, under the causal mask and a window alike.
    """
    s, n = q.shape[1], q.shape[2]
    g = n // k.shape[2]
    pad = -s % fa.TILE if s > fa.TILE else 0

    def heads(x: torch.Tensor, rep: int) -> torch.Tensor:
        x = torch.movedim(x, 2, 1)
        if rep > 1:
            x = x.repeat_interleave(rep, dim=1)
        return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x

    out = fa.flash_attention(heads(q, 1), heads(k, g), heads(v, g),
                             causal=True, window=window)
    return torch.movedim(out[:, :, :s], 1, 2)


def _on_card(*xs: torch.Tensor) -> bool:
    """Real CUDA tensors: not the dry run's fake ones, not meta."""
    from torch._subclasses.fake_tensor import is_fake
    return all(x.is_cuda and not is_fake(x) for x in xs)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, window: Optional[int] = None,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Causal prefill attention, q (B,S,N,hd); k,v (B,S,K,hd) -> like q.

    :func:`gqa_flash_attention` on K5 where its tensor-core kernel takes
    the inputs: real CUDA tensors needing no gradient (K5 has no
    backward), bf16 with hd % 8 == 0, hd <= 128 and v as wide as q and k;
    else :func:`blockwise_attention` with `kv_chunk`."""
    hd = q.shape[-1]
    if (_on_card(q, k, v)
            and not (q.requires_grad or k.requires_grad or v.requires_grad)
            and q.dtype == k.dtype == v.dtype
            and fa.variant(q.dtype, hd) == "tensor_cores"
            and hd <= fa.MAX_HEAD_DIM and v.shape[-1] == hd):
        return gqa_flash_attention(q, k, v, window=window)
    return blockwise_attention(q, k, v, causal=True, window=window,
                               kv_chunk=kv_chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, ctx_len) -> torch.Tensor:
    """One-token attention against a dense cache.

    q (B,N,hd); k/v_cache (B,S,K,hd); ctx_len a 0-d or a (B,) tensor of
    valid slots (or an int) -> (B,N,hd).
    """
    b, n, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = n // kh
    scale = hd ** -0.5
    qg = q.reshape(b, kh, g, hd).to(F32) * scale
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(F32))
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    valid = pos[None, :] < torch.as_tensor(ctx_len,
                                           device=q.device).reshape(-1, 1)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.to(F32))
    return out.reshape(b, n, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg) -> Dict:
    d, n, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = pdtype(cfg)
    p = {
        # fused QKV, as the reference
        "wqkv": dense_init(gen, (d, (n + 2 * kh) * hd), dtype=dt),
        "wo": dense_init(gen, (n * hd, d), dtype=dt),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(hd, gen.device)
        p["knorm"] = rmsnorm_init(hd, gen.device)
    return p


def _qkv(params: Dict, x: torch.Tensor, cfg):
    b, s, _ = x.shape
    n, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = matmul(x, params["wqkv"])
    q = qkv[..., :n * hd].reshape(b, s, n, hd)
    k = qkv[..., n * hd:(n + kh) * hd].reshape(b, s, kh, hd)
    v = qkv[..., (n + kh) * hd:].reshape(b, s, kh, hd)
    return q, k, v


def _apply_positional(x: torch.Tensor, positions, cfg) -> torch.Tensor:
    if cfg.rope == "rope":
        return rope_mod.apply_rope(x, positions, cfg.rope_theta,
                                   cfg.rope_scaling)
    if cfg.rope == "mrope":
        return rope_mod.apply_mrope(x, positions, cfg.rope_theta,
                                    cfg.mrope_sections)
    return x  # 'none': sinusoidal added at the embedding


def _reduce(x: torch.Tensor, cfg):
    return x.dtype if cfg.tp_reduce_bf16 else None


def projected_qkv(params: Dict, x: torch.Tensor, cfg, positions,
                  seq_shard: bool):
    """The attention's q (B, S, H, D), k and v (B, S, K, D) of the
    normalised input `x`: projected, qk-normed, with positions applied."""
    q, k, v = _qkv(params, x, cfg)
    if cfg.qk_norm:
        q = rmsnorm(params["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(params["knorm"], k, cfg.norm_eps)
    q = _apply_positional(q, positions, cfg)
    k = _apply_positional(k, positions, cfg)
    q = (shard(q, BATCH, MODEL, None, None) if seq_shard
         else shard(q, BATCH, None, MODEL, None))
    return q, k, v


def attention(params: Dict, x: torch.Tensor, cfg, positions,
              *, window: Optional[int] = None,
              seq_shard: bool = False) -> torch.Tensor:
    """Full/SWA attention over a whole sequence."""
    b, s, _ = x.shape
    q, k, v = projected_qkv(params, x, cfg, positions, seq_shard)
    win = window if window is not None else cfg.window
    o = blockwise_attention(q, k, v, causal=True, window=win)
    o = o.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return shard(matmul(o, params["wo"], reduce_dtype=_reduce(x, cfg)),
                 BATCH, None, None)


def attention_prefill(params: Dict, x: torch.Tensor, cfg, positions,
                      *, window: Optional[int] = None,
                      seq_shard: bool = False
                      ) -> Tuple[torch.Tensor, Dict]:
    """Like :func:`attention` but also returns the decode cache; the
    attention is :func:`prefill_attention`'s (on K5 where it takes the
    inputs).

    For SWA the cache holds the last `window` tokens, rolled so slot
    (p mod window) carries token p — the invariant :func:`attention_decode`
    maintains."""
    b, s, _ = x.shape
    q, k, v = projected_qkv(params, x, cfg, positions, seq_shard)
    win = window if window is not None else cfg.window
    o = prefill_attention(q, k, v, window=win, kv_chunk=cfg.kv_chunk)
    y = shard(matmul(o.reshape(b, s, cfg.n_heads * cfg.head_dim),
                     params["wo"], reduce_dtype=_reduce(x, cfg)),
              BATCH, None, None)
    if win is not None and s >= win:
        k_c = torch.roll(k[:, -win:], shifts=s % win, dims=1)
        v_c = torch.roll(v[:, -win:], shifts=s % win, dims=1)
    else:
        k_c, v_c = k, v
    cache = {"k": shard(k_c.contiguous(), BATCH, MODEL, None, None),
             "v": shard(v_c.contiguous(), BATCH, MODEL, None, None)}
    return y, cache


def context_length(length, device) -> torch.Tensor:
    """A decode step's context length as the 0-d tensor the decode path
    takes: a tensor as it is, an int filled in on `device` (no upload)."""
    if isinstance(length, torch.Tensor):
        return length
    return torch.full((), length, dtype=torch.int64, device=device)


def attention_decode(params: Dict, x: torch.Tensor, cfg, cache: Dict,
                     ctx_len, *, window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x (B,1,D); cache {k,v: (B,S,K,hd)}; `ctx_len` the
    tokens already cached (:func:`context_length`).  Returns (y (B,1,D),
    cache), the cache updated in place; SWA caches roll modulo the window.
    Nothing is read back to the host, so the step can be captured into a
    CUDA graph and replayed for another length."""
    b, _, d = x.shape
    n, hd = cfg.n_heads, cfg.head_dim
    s_cache = cache["k"].shape[1]
    ctx_len = context_length(ctx_len, x.device)
    q, k, v = _qkv(params, x, cfg)
    if cfg.qk_norm:
        q = rmsnorm(params["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(params["knorm"], k, cfg.norm_eps)
    pos = ctx_len.to(torch.int32).expand(b, 1)
    if cfg.rope == "mrope":
        q = rope_mod.apply_mrope(q, torch.stack([pos] * 3), cfg.rope_theta,
                                 cfg.mrope_sections)
        k = rope_mod.apply_mrope(k, torch.stack([pos] * 3), cfg.rope_theta,
                                 cfg.mrope_sections)
    elif cfg.rope == "rope":
        q = rope_mod.apply_rope(q, pos, cfg.rope_theta, cfg.rope_scaling)
        k = rope_mod.apply_rope(k, pos, cfg.rope_theta, cfg.rope_scaling)
    win = window if window is not None else cfg.window
    slot = ctx_len.long() % s_cache if win is not None else ctx_len.long()
    # dynamic_update_slice clamps the start so the slice fits
    slot = slot.clamp(0, s_cache - 1).reshape(1)
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    valid = torch.clamp(ctx_len + 1, max=s_cache)
    o = decode_attention(q[:, 0], cache["k"], cache["v"], valid)
    y = matmul(o.reshape(b, n * hd), params["wo"],
               reduce_dtype=_reduce(x, cfg)).reshape(b, 1, d)
    return shard(y, BATCH, None, None), cache


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V3)
# ---------------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg) -> Dict:
    m = cfg.mla
    d, n = cfg.d_model, cfg.n_heads
    dt = pdtype(cfg)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), dtype=dt),
        "q_norm": rmsnorm_init(m.q_lora_rank, gen.device),
        "wq_b": dense_init(gen, (m.q_lora_rank, n * qk), dtype=dt),
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype=dt),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, gen.device),
        "wkv_b": dense_init(gen, (m.kv_lora_rank,
                                  n * (m.qk_nope_head_dim + m.v_head_dim)),
                            dtype=dt),
        "wo": dense_init(gen, (n * m.v_head_dim, d), dtype=dt),
    }


def mla_softmax_scale(cfg) -> float:
    """The MLA softmax scale: ``(nope + rope) ** -0.5``, times YaRN's
    ``mscale ** 2`` under rope scaling (DeepSeek-V3's ``softmax_scale``)."""
    m = cfg.mla
    return ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
            * rope_mod.yarn_softmax_factor(cfg.rope_scaling))


def pool_rows(entry: Dict, n: int
              ) -> Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The paged KV pool's (keys, values) from the first `n` slots of a
    block's prefill cache `entry` (batch 1): GQA's ``k`` rows as both, as
    the reference does; MLA's latent ``[ckv | krope]``, one row a token,
    as keys only (values are its first columns, :func:`pool_kernel_kwargs`);
    None for a block with no K/V cache (rwkv, rec)."""
    if "k" in entry:
        k = entry["k"][0, :n]
        return k, k
    if "ckv" in entry:
        return torch.cat([entry["ckv"][0, :n], entry["krope"][0, :n]],
                         dim=-1)[:, None], None
    return None


def pool_kernel_kwargs(cfg) -> Dict:
    """K4's keywords over `cfg`'s KV pool: none for GQA; MLA's softmax
    scale and its latent rows' value columns, ``kv_lora_rank``."""
    if cfg.attn_kind != "mla":
        return {}
    return {"scale": mla_softmax_scale(cfg), "v_dim": cfg.mla.kv_lora_rank}


def _mla_qkv(params: Dict, x: torch.Tensor, cfg, positions):
    """Shared projections. Returns q_nope, q_rope, ckv (normed), k_rope."""
    m = cfg.mla
    b, s, _ = x.shape
    n = cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = matmul(rmsnorm(params["q_norm"], matmul(x, params["wq_a"]),
                       cfg.norm_eps), params["wq_b"]).reshape(b, s, n, qk)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = rope_mod.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                                 cfg.rope_theta, cfg.rope_scaling)
    kv = matmul(x, params["wkv_a"])
    ckv = rmsnorm(params["kv_norm"], kv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = rope_mod.apply_rope(
        kv[..., m.kv_lora_rank:][:, :, None, :], positions,
        cfg.rope_theta, cfg.rope_scaling)[:, :, 0, :]       # shared head
    return q_nope, q_rope, ckv, k_rope


def _mla_expand(params: Dict, x: torch.Tensor, cfg, positions):
    """q (B,S,N,nope+rope), k (B,S,N,nope+rope), v (B,S,N,v) from the
    latent, with f32-accumulated expansions (the reference's
    ``preferred_element_type=F32``), and the latent cache's ckv, k_rope."""
    m = cfg.mla
    b, s, _ = x.shape
    n = cfg.n_heads
    q_nope, q_rope, ckv, k_rope = _mla_qkv(params, x, cfg, positions)
    wkv_b = params["wkv_b"].reshape(m.kv_lora_rank, n,
                                    m.qk_nope_head_dim + m.v_head_dim)
    ckv_f = ckv.to(F32)
    k_nope = torch.einsum("bsr,rnd->bsnd", ckv_f,
                          wkv_b[..., :m.qk_nope_head_dim].to(F32)
                          ).to(x.dtype)
    v = torch.einsum("bsr,rnd->bsnd", ckv_f,
                     wkv_b[..., m.qk_nope_head_dim:].to(F32)).to(x.dtype)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, n, m.qk_rope_head_dim)], dim=-1)
    return shard(q, BATCH, None, MODEL, None), k, v, ckv, k_rope


def mla_attention(params: Dict, x: torch.Tensor, cfg, positions
                  ) -> torch.Tensor:
    """Train/prefill MLA: expand the latent to per-head K/V.  The
    attention takes blockwise_attention's default KV chunk, as the
    reference's does."""
    b, s, _ = x.shape
    q, k, v, _, _ = _mla_expand(params, x, cfg, positions)
    o = blockwise_attention(q, k, v, causal=True,
                            scale=mla_softmax_scale(cfg))
    o = o.reshape(b, s, cfg.n_heads * cfg.mla.v_head_dim)
    return shard(matmul(o, params["wo"], reduce_dtype=_reduce(x, cfg)),
                 BATCH, None, None)


def mla_prefill(params: Dict, x: torch.Tensor, cfg, positions
                ) -> Tuple[torch.Tensor, Dict]:
    """MLA prefill: returns output and the latent {ckv, krope} cache (the
    attention with ``cfg.kv_chunk``, as the reference's prefill)."""
    b, s, _ = x.shape
    q, k, v, ckv, k_rope = _mla_expand(params, x, cfg, positions)
    o = blockwise_attention(q, k, v, causal=True, kv_chunk=cfg.kv_chunk,
                            scale=mla_softmax_scale(cfg))
    y = shard(matmul(o.reshape(b, s, cfg.n_heads * cfg.mla.v_head_dim),
                     params["wo"], reduce_dtype=_reduce(x, cfg)),
              BATCH, None, None)
    cache = {"ckv": shard(ckv.contiguous(), BATCH, MODEL, None),
             "krope": shard(k_rope.contiguous(), BATCH, MODEL, None)}
    return y, cache


def mla_decode(params: Dict, x: torch.Tensor, cfg, cache: Dict,
               ctx_len) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-decode MLA over the latent cache {ckv: (B,S,r), krope:
    (B,S,p)}, updated in place; the einsums run in f32 and scale by
    :func:`mla_softmax_scale`; `ctx_len` as in :func:`attention_decode`."""
    m = cfg.mla
    b, _, d = x.shape
    n = cfg.n_heads
    ctx_len = context_length(ctx_len, x.device)
    pos = ctx_len.to(torch.int32).expand(b, 1)
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv(params, x, cfg, pos)
    s_len = cache["ckv"].shape[1]
    # dynamic_update_slice clamps the start so the slice fits
    idx = ctx_len.long().clamp(0, s_len - 1).reshape(1)
    cache["ckv"].index_copy_(1, idx, ckv_new.to(cache["ckv"].dtype))
    cache["krope"].index_copy_(1, idx, krope_new.to(cache["krope"].dtype))
    ckv_c = cache["ckv"].to(F32)
    wkv_b = params["wkv_b"].reshape(m.kv_lora_rank, n,
                                    m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[..., :m.qk_nope_head_dim].to(F32)          # (r, n, nope)
    w_uv = wkv_b[..., m.qk_nope_head_dim:].to(F32)          # (r, n, v)
    scale = mla_softmax_scale(cfg)
    q_eff = torch.einsum("bnd,rnd->bnr", q_nope[:, 0].to(F32), w_uk)
    logits = (torch.einsum("bnr,bsr->bns", q_eff, ckv_c)
              + torch.einsum("bnp,bsp->bns", q_rope[:, 0].to(F32),
                             cache["krope"].to(F32))) * scale
    valid = torch.arange(s_len, device=x.device) < ctx_len + 1
    logits = torch.where(valid[None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bns,bsr->bnr", probs, ckv_c)
    o = torch.einsum("bnr,rnv->bnv", o_lat, w_uv).to(x.dtype)
    # no reduce_dtype here, as in the reference's decode
    y = matmul(o.reshape(b, n * m.v_head_dim), params["wo"]).reshape(b, 1, d)
    return shard(y, BATCH, None, None), cache
