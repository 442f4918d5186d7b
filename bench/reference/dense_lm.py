"""Plain PyTorch reference of a served dense decoder LM (Llama-style, GQA,
sliding window) and of the serving loop's paged KV accounting.

Imports nothing of the program.  The weights are the benchmark's own tensors
(:func:`make_params` draws them), handed to the program and to this file
alike; the reference reads them layer by layer in float32.

The model, from the configuration file:

    x = embed[tokens]
    per layer:  h = rmsnorm(x) * ln1;  q, k, v = split(h @ wqkv)
                q, k = rope(q), rope(k)           (half rotation, theta)
                x += softmax(q k^T / sqrt(hd), causal, window) v @ wo
                h = rmsnorm(x) * ln2;  g, u = split(h @ wiu)
                x += (silu(g) * u) @ wo_mlp
    logits = (rmsnorm(x) * final_norm) @ head

`precision` selects how the matrix products' operands are held: "f32"
(TF32 off) or "fp8", each operand rounded to float8 e4m3 with one scale per
tensor and the product accumulated in float32 — the control's precision.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

F32 = torch.float32
FP8_MAX = 448.0


# ---------------------------------------------------------------------------
# Weights (the benchmark's, drawn on the device from the seed)
# ---------------------------------------------------------------------------
def leaf_shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every matrix, in the order they are laid
    out in one flat buffer; the scale is 1/sqrt(fan in) (0.02 for the
    embedding)."""
    d, f, v = m["d_model"], m["d_ff"], m["vocab_size"]
    n, k, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    out = [("embed", (v, d), 0.02)]
    for i in range(m["n_layers"]):
        out += [(f"l{i}.wqkv", (d, (n + 2 * k) * hd), d ** -0.5),
                (f"l{i}.wo", (n * hd, d), (n * hd) ** -0.5),
                (f"l{i}.wiu", (d, 2 * f), d ** -0.5),
                (f"l{i}.wo_mlp", (f, d), f ** -0.5)]
    out.append(("head", (d, v), d ** -0.5))
    return out


def make_params(m: Dict, seed: int, device, norm_noise: float
                ) -> Dict[str, torch.Tensor]:
    """Every weight from `seed`, on `device`, in two draws: the matrices
    from one normal draw in the served dtype, each scaled in place; the
    norm scales (float32) as 1 + `norm_noise` x a normal draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, m["dtype"])
    shapes = leaf_shapes(m)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=gen, dtype=dt, device=device)
    out, at = {}, 0
    for name, shape, scale in shapes:
        n_el = math.prod(shape)
        out[name] = flat[at:at + n_el].view(shape).mul_(scale)
        at += n_el
    d, nl = m["d_model"], m["n_layers"]
    norms = torch.randn((2 * nl + 1) * d, generator=gen, dtype=F32,
                        device=device).mul_(norm_noise).add_(1.0)
    for i in range(nl):
        out[f"l{i}.ln1"] = norms[2 * i * d:(2 * i + 1) * d]
        out[f"l{i}.ln2"] = norms[(2 * i + 1) * d:(2 * i + 2) * d]
    out["final_norm"] = norms[2 * nl * d:]
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3 under one per-tensor scale, back in f32."""
    amax = x.abs().amax().clamp(min=1e-30)
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(F32) / s


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    w = w.to(F32)
    if precision == "fp8":
        x, w = round_fp8(x), round_fp8(w)
    return x @ w


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                       device=x.device) / hd)
    ang = pos.to(F32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def forward(m: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            positions: Sequence[int], precision: str = "f32"
            ) -> torch.Tensor:
    """Logits (len(positions), V) at `positions` of one sequence `tokens`
    (S,), in float32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _forward(m, params, tokens, positions, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _forward(m, params, tokens, positions, precision) -> torch.Tensor:
    n, k, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps, f = m["norm_eps"], m["d_ff"]
    s = tokens.shape[0]
    dev = tokens.device
    pos = torch.arange(s, device=dev)
    allowed = pos[None, :] <= pos[:, None]
    if m.get("window"):
        allowed &= pos[None, :] > pos[:, None] - m["window"]
    x = params["embed"][tokens.long()].to(F32)
    for i in range(m["n_layers"]):
        h = _rmsnorm(x, params[f"l{i}.ln1"], eps)
        qkv = _mm(h, params[f"l{i}.wqkv"], precision)
        q = qkv[:, :n * hd].view(s, n, hd)
        kk = qkv[:, n * hd:(n + k) * hd].view(s, k, hd)
        vv = qkv[:, (n + k) * hd:].view(s, k, hd)
        q, kk = _rope(q, pos, m["rope_theta"]), _rope(kk, pos, m["rope_theta"])
        g = n // k
        kq = kk.repeat_interleave(g, dim=1)
        vq = vv.repeat_interleave(g, dim=1)
        if precision == "fp8":
            q, kq, vq = round_fp8(q), round_fp8(kq), round_fp8(vq)
        att = torch.einsum("qhd,khd->hqk", q, kq) * hd ** -0.5
        att = att.masked_fill(~allowed[None], -math.inf).softmax(-1)
        o = torch.einsum("hqk,khd->qhd", att, vq).reshape(s, n * hd)
        x = x + _mm(o, params[f"l{i}.wo"], precision)
        h = _rmsnorm(x, params[f"l{i}.ln2"], eps)
        gu = _mm(h, params[f"l{i}.wiu"], precision)
        x = x + _mm(torch.nn.functional.silu(gu[:, :f]) * gu[:, f:],
                    params[f"l{i}.wo_mlp"], precision)
    idx = torch.as_tensor(list(positions), device=dev)
    xs = _rmsnorm(x[idx], params["final_norm"], eps)
    return _mm(xs, params["head"], precision)


# ---------------------------------------------------------------------------
# Paged attention over the serving loop's pool
# ---------------------------------------------------------------------------
def layer0_keys(m: Dict, params: Dict[str, torch.Tensor],
                tokens: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """Layer 0's keys (S, K, hd) after rope, in float32."""
    n, k, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens.long()].to(F32)
    h = _rmsnorm(x, params["l0.ln1"], m["norm_eps"])
    w = params["l0.wqkv"][:, n * hd:(n + k) * hd]
    kk = _mm(h, w, precision).view(-1, k, hd)
    return _rope(kk, pos, m["rope_theta"])


def paged_attention(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                    n_ctx: int) -> torch.Tensor:
    """One decode query per sequence against its first `n_ctx` cached
    positions.  q (B, H, hd); keys, values (B, S, K, hd) -> (B, H, hd),
    softmax(q k^T / sqrt(hd)) v in float32, query head h on kv head
    h // (H / K)."""
    b, h, hd = q.shape
    kh = keys.shape[2]
    kq = keys[:, :n_ctx].to(F32).repeat_interleave(h // kh, dim=2)
    vq = values[:, :n_ctx].to(F32).repeat_interleave(h // kh, dim=2)
    att = torch.einsum("bhd,bshd->bhs", q.to(F32), kq) * hd ** -0.5
    return torch.einsum("bhs,bshd->bhd", att.softmax(-1), vq)


# ---------------------------------------------------------------------------
# Paged KV accounting (pages, tiers, LRU, simulated CXL seconds)
# ---------------------------------------------------------------------------
def kv_accounting(requests: int, prefill: int, decode: int, page: int,
                  hbm_pages: int, page_bytes: int, read_gbps: float,
                  write_gbps: float) -> Dict[str, float]:
    """The counters of one serving call's page pool.

    The pool holds ``requests * max_blocks + 8`` pages, ``max_blocks =
    (prefill + decode) // page + 2``, and hands out the highest free page
    first.  A new page starts in HBM; while more than `hbm_pages` pages in
    use are in HBM, the least recently used one (first in request order,
    then block order, on a tie) is demoted to CXL.  Every append and every
    decode step's gather ticks the clock; a gather touches every page of
    every sequence in order and fetches a CXL page (promoting it back to
    HBM while HBM has room).  Each crossing moves one page of K and V for
    one layer, at the CXL path's read or write payload rate.

    Each request first appends its `prefill` tokens; each decode step then
    gathers all sequences and appends one token to each.
    """
    max_blocks = (prefill + decode) // page + 2
    n_pages = requests * max_blocks + 8
    free = list(range(n_pages))
    tier = [0] * n_pages
    last = [0] * n_pages
    tables: Dict[int, List[int]] = {}
    lens: Dict[int, int] = {}
    st = {"allocs": 0, "hbm_hits": 0, "cxl_fetches": 0, "promotions": 0,
          "demotions": 0, "cxl_bytes": 0, "sim_seconds": 0.0}
    clock = [0]

    def in_hbm() -> List[int]:
        return [p for t in tables.values() for p in t if tier[p] == 0]

    def append(sid: int, n_tok: int) -> None:
        clock[0] += 1
        table = tables[sid]
        for j in range(lens[sid], lens[sid] + n_tok):
            if j // page >= len(table):
                pg = free.pop()
                table.append(pg)
                tier[pg] = 0
                st["allocs"] += 1
                while len(in_hbm()) > hbm_pages:
                    used = in_hbm()
                    victim = min(used, key=lambda p: last[p])
                    tier[victim] = 1
                    st["demotions"] += 1
                    st["cxl_bytes"] += page_bytes
                    st["sim_seconds"] += page_bytes / (write_gbps * 1e9)
            last[table[j // page]] = clock[0]
        lens[sid] += n_tok

    def gather(sids: Sequence[int]) -> None:
        clock[0] += 1
        for sid in sids:
            for pg in tables[sid][:max_blocks]:
                last[pg] = clock[0]
                if tier[pg] == 1:
                    st["cxl_fetches"] += 1
                    st["cxl_bytes"] += page_bytes
                    st["sim_seconds"] += page_bytes / (read_gbps * 1e9)
                    if len(in_hbm()) < hbm_pages:
                        tier[pg] = 0
                        st["promotions"] += 1
                else:
                    st["hbm_hits"] += 1

    for sid in range(requests):
        tables[sid], lens[sid] = [], 0
        append(sid, prefill)
    for _ in range(decode):
        gather(range(requests))
        for sid in range(requests):
            append(sid, 1)
    return st


# ---------------------------------------------------------------------------
# The serving loop's inputs
# ---------------------------------------------------------------------------
def serve_inputs(requests: int, prefill: int, decode: int, vocab: int,
                 n_heads: int, head_dim: int, rng_seed: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(prompts (requests, prefill) int, queries (decode, requests, H, hd)
    f32): the prompts, then one query per sequence and step, drawn from
    ``numpy.random.default_rng(rng_seed)`` in that order."""
    rng = np.random.default_rng(rng_seed)
    prompts = np.stack([rng.integers(0, vocab, (1, prefill))[0]
                        for _ in range(requests)])
    queries = np.stack([rng.standard_normal((requests, n_heads, head_dim))
                        .astype(np.float32) for _ in range(decode)])
    return prompts, queries


def cxl_payload_gbps(cxl: Dict) -> Tuple[float, float]:
    """(read, write) payload GB/s of the CXL.mem path: a line takes a
    header slot and four data slots of 17 B on the wire, and the device
    DDR caps it."""
    wire = cxl["lanes"] * cxl["lane_gbps"]
    per_line = (cxl["slots_header"] + cxl["slots_data"]) * cxl["slot_wire_bytes"]
    pay = min(wire * (cxl["line_bytes"] / per_line), cxl["backend_gbps"])
    return pay, pay


def greedy_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """Widest gap by which a chosen token's logit lies below the reference's
    best at its position: ref_logits (P, V), tokens (P,)."""
    best = ref_logits.max(dim=-1).values
    chosen = ref_logits.gather(1, tokens.long()[:, None])[:, 0]
    return float((best - chosen).max())


def max_rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| / max |ref|; infinite when `x` holds a NaN or an
    infinity."""
    err = float((x.to(F32) - ref).abs().max() / ref.abs().max())
    return err if math.isfinite(err) else math.inf

