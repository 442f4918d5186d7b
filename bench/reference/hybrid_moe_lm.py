"""Plain PyTorch reference of MiMo-V2-Flash as one expert-parallel rank holds
it, and of the serving loop's two-kind KV pool and its accounting.

Imports nothing of the program.  The weights are the benchmark's own tensors
(:func:`make_params` draws them), handed to the program and to this file
alike; the reference reads them layer by layer in float32, with TF32 off
for matrix products and cuDNN.  The configuration's keys are those of the
model's ``config.json``; ``n_routed_experts`` counts the experts held here,
``expert_parallel`` names the router's width and the first held expert.

The model (MiMo-V2-Flash's ``config.json``; layer i is a window layer where
``hybrid_layer_pattern[i]`` is 1, a full one where it is 0):

    x = embed[tokens]
    per layer:  h = rmsnorm(x) * ln1
                q | k | v = h @ wqkv        q: 64 heads x 192, k: K x 192,
                                            v: K x 128, K = 4 (full) or 8
                v = attention_value_scale * v
                q, k: RoPE on the leading int(192 x 0.334) = 64 dims, at
                      rope_theta (full) or swa_rope_theta (window)
                s_j = q . k_j / sqrt(192) over the keys j <= the query, and
                      for a window layer j > the query - sliding_window
                o = sum_j e^(s_j) v_j / (sum_j e^(s_j) + e^(sink)), the
                    sink a logit per head of a window layer (none in a full
                    layer: the plain softmax)
                x += o @ wo
                h = rmsnorm(x) * ln2
                layer 0 (moe_layer_freq 0):  x += (silu(g) * u) @ wo_mlp,
                                             g | u = h @ wiu
                MoE layers:  x += sum over the held experts e chosen for the
                             token: w_e (silu(g_e) * u_e) @ wo_e
    logits = (rmsnorm(x) * final_norm) @ head

The gate (``scoring_func`` sigmoid, ``topk_method`` noaux_tc, one group):
scores = sigmoid(h @ router) over all ``router_experts``; the top
``num_experts_per_tok`` of scores + the score-correction bias are the
token's experts; their weights are their unbiased scores over the scores'
sum (``norm_topk_prob``), times ``routed_scaling_factor`` (null: 1).  Only
the held experts' part is computed: what the absent experts would add lies
on other ranks.

Departures from the published description, each also the program's: the 64
rotated dims are the leading ones, rotated as halves (with random weights a
permutation of ``wqkv``'s q and k columns against any other pairing);
``attention_value_scale`` is read as a scale on v, the same as a scale on
the attention's output; ``attention_chunk_size`` (128) is read as the
published kernels' tiling, not as a mask; the 3 MTP layers are left out;
the weights are bf16 random draws (the deployment's are fp8), the
score-correction bias and the sink logits drawn from the seed.  The
attention is computed in blocks of 16 heads, so that a 4k-token sequence
fits.

`precision` selects how the matrix products' operands are held: "f32";
"fp8", each operand rounded to float8 e4m3 with one scale per tensor and
the product accumulated in float32 — the control's precision; or "bf16",
each operand rounded to bfloat16 and the product accumulated in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the references beside this file: the CXL path's rates, the comparison's
# measures, the float products and the held routes' count
from reference import dense_lm as _DENSE
from reference import mla_moe_lm as _MLA

F32 = torch.float32
HEAD_BLOCK = 16

cxl_payload_gbps = _DENSE.cxl_payload_gbps
greedy_gap = _DENSE.greedy_gap
max_rel_err = _DENSE.max_rel_err
round_fp8 = _DENSE.round_fp8
held = _MLA.held
router_experts = _MLA.router_experts
held_mismatch = _MLA.held_mismatch
_round, _mm, _rmsnorm, _swiglu = (_MLA._round, _MLA._mm, _MLA._rmsnorm,
                                  _MLA._swiglu)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
def is_window(m: Dict, i: int) -> bool:
    return m["hybrid_layer_pattern"][i] == 1


def is_moe(m: Dict, i: int) -> bool:
    return m["moe_layer_freq"][i] == 1


def kv_heads(m: Dict, i: int) -> int:
    return (m["swa_num_key_value_heads"] if is_window(m, i)
            else m["num_key_value_heads"])


def has_sinks(m: Dict, i: int) -> bool:
    return bool(m["add_swa_attention_sink_bias"] if is_window(m, i)
                else m["add_full_attention_sink_bias"])


def rope_theta(m: Dict, i: int) -> float:
    return float(m["swa_rope_theta"] if is_window(m, i) else m["rope_theta"])


def rotary_dims(m: Dict) -> int:
    """The leading dims of a q or k head that RoPE rotates."""
    return int(m["head_dim"] * m["partial_rotary_factor"])


def leaf_shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every bf16 matrix, in the order they are laid
    out in one flat buffer; the scale is 1/sqrt(fan in) (0.02 for the
    embedding)."""
    d, v, n = m["hidden_size"], m["vocab_size"], m["num_attention_heads"]
    hd, hv = m["head_dim"], m["v_head_dim"]
    f, fe = m["intermediate_size"], m["moe_intermediate_size"]
    _, e = held(m)
    out = [("embed", (v, d), 0.02)]
    for i in range(m["num_hidden_layers"]):
        kh = kv_heads(m, i)
        out += [(f"l{i}.wqkv", (d, (n + kh) * hd + kh * hv), d ** -0.5),
                (f"l{i}.wo", (n * hv, d), (n * hv) ** -0.5)]
        if is_moe(m, i):
            out += [(f"l{i}.experts_wiu", (e, d, 2 * fe), d ** -0.5),
                    (f"l{i}.experts_wo", (e, fe, d), fe ** -0.5)]
        else:
            out += [(f"l{i}.wiu", (d, 2 * f), d ** -0.5),
                    (f"l{i}.wo_mlp", (f, d), f ** -0.5)]
    out.append(("head", (d, v), d ** -0.5))
    return out


def f32_shapes(m: Dict) -> List[Tuple[str, int]]:
    """(name, length) of every float32 vector and router, in draw order:
    the norm scales, the sink logits, the routers (flattened (d,
    router_experts)) and the score-correction biases."""
    d, n, layers = (m["hidden_size"], m["num_attention_heads"],
                    m["num_hidden_layers"])
    out = []
    for i in range(layers):
        out += [(f"l{i}.ln1", d), (f"l{i}.ln2", d)]
    out.append(("final_norm", d))
    out += [(f"l{i}.sinks", n) for i in range(layers) if has_sinks(m, i)]
    routers = [i for i in range(layers) if is_moe(m, i)]
    out += [(f"l{i}.router", d * router_experts(m)) for i in routers]
    out += [(f"l{i}.bias", router_experts(m)) for i in routers]
    return out


def make_params(m: Dict, seed: int, device, norm_noise: float
                ) -> Dict[str, torch.Tensor]:
    """Every weight from `seed`, on `device`, in two draws: the matrices
    from one normal draw in the served dtype, each scaled in place; the
    float32 vectors from one normal draw: norm scales 1 + `norm_noise` x,
    sink logits ``weights.sink_mean`` + ``weights.sink_std`` x, routers
    scaled by 1/sqrt(d), biases ``weights.score_bias_std`` x."""
    wt = m["weights"]
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
    vec = f32_shapes(m)
    flat = torch.randn(sum(n for _, n in vec), generator=gen, dtype=F32,
                       device=device)
    d, at = m["hidden_size"], 0
    for name, n in vec:
        x = flat[at:at + n]
        at += n
        if name.endswith(".router"):
            out[name] = x.view(d, router_experts(m)).mul_(d ** -0.5)
        elif name.endswith(".bias"):
            out[name] = x.mul_(wt["score_bias_std"])
        elif name.endswith(".sinks"):
            out[name] = x.mul_(wt["sink_std"]).add_(wt["sink_mean"])
        else:
            out[name] = x.mul_(norm_noise).add_(1.0)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _rope(x: torch.Tensor, pos: torch.Tensor, m: Dict, theta: float
          ) -> torch.Tensor:
    """x (S, H, head_dim) with its leading rotary dims rotated by halves at
    positions `pos` (S,)."""
    r = rotary_dims(m)
    inv = 1.0 / theta ** (torch.arange(0, r, 2, dtype=F32, device=x.device)
                          / r)
    ang = pos.to(F32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2, rest = x[..., :r // 2], x[..., r // 2:r], x[..., r:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, rest],
                     dim=-1)


def layer_kv(m: Dict, p: Dict[str, torch.Tensor], i: int, h: torch.Tensor,
             pos: torch.Tensor, precision: str = "f32"):
    """Layer i's q (S, n, hd), k (S, K, hd) (both roped) and v (S, K, hv)
    (scaled) of its normed input `h` (S, d)."""
    n, hd, hv = m["num_attention_heads"], m["head_dim"], m["v_head_dim"]
    kh, s = kv_heads(m, i), h.shape[0]
    qkv = _mm(h, p[f"l{i}.wqkv"], precision)
    q = qkv[:, :n * hd].view(s, n, hd)
    k = qkv[:, n * hd:(n + kh) * hd].view(s, kh, hd)
    v = qkv[:, (n + kh) * hd:].view(s, kh, hv) * m["attention_value_scale"]
    theta = rope_theta(m, i)
    return _rope(q, pos, m, theta), _rope(k, pos, m, theta), v


def _attention(m, p, i, h, pos, precision) -> torch.Tensor:
    n, hd, hv = m["num_attention_heads"], m["head_dim"], m["v_head_dim"]
    q, k, v = (_round(t, precision)
               for t in layer_kv(m, p, i, h, pos, precision))
    kh, s = k.shape[1], h.shape[0]
    g = n // kh
    allowed = pos[None, :] <= pos[:, None]
    if is_window(m, i):
        allowed &= pos[None, :] > pos[:, None] - m["sliding_window"]
    sinks = p.get(f"l{i}.sinks")
    o = torch.empty((s, n, hv), dtype=F32, device=h.device)
    for h0 in range(0, n, HEAD_BLOCK):            # heads in blocks
        sl = slice(h0, h0 + HEAD_BLOCK)
        kv = torch.arange(h0, min(h0 + HEAD_BLOCK, n), device=h.device) // g
        att = torch.einsum("qhd,khd->hqk", q[:, sl], k[:, kv]) * hd ** -0.5
        att = att.masked_fill(~allowed[None], -math.inf)
        if sinks is not None and has_sinks(m, i):
            col = sinks[sl][:, None, None].expand(-1, s, 1)
            att = torch.cat([att, col], dim=-1).softmax(-1)[..., :s]
        else:
            att = att.softmax(-1)
        o[:, sl] = torch.einsum("hqk,khd->qhd", att, v[:, kv])
    return _mm(o.reshape(s, n * hv), p[f"l{i}.wo"], precision)


def gate(m: Dict, scores: torch.Tensor, bias: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sigmoid gate on `scores` (T, E): (weights (T, k), experts (T,
    k)); one group, so the group limit keeps every expert."""
    experts = (scores + bias).topk(m["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, experts)
    if m["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    return w * (m["routed_scaling_factor"] or 1.0), experts


def _moe(m, p, i, h, precision, routes) -> torch.Tensor:
    scores = torch.sigmoid(_mm(h, p[f"l{i}.router"], precision))
    w, experts = gate(m, scores, p[f"l{i}.bias"])
    if routes is not None:
        routes.append(experts)
    first, n_held = held(m)
    y = torch.zeros_like(h)
    for j in range(n_held):
        tok, slot = torch.nonzero(experts == first + j, as_tuple=True)
        if tok.numel():
            out = _swiglu(h[tok], p[f"l{i}.experts_wiu"][j],
                          p[f"l{i}.experts_wo"][j], precision)
            y = y.index_add(0, tok, out * w[tok, slot][:, None])
    return y


def forward(m: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            positions: Sequence[int], precision: str = "f32",
            routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Logits (len(positions), V) at `positions` of one sequence `tokens`
    (S,), in float32; each MoE layer's experts (S, k) appended to `routes`
    when given."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(m, params, tokens, positions, precision, routes)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _forward(m, p, tokens, positions, precision, routes) -> torch.Tensor:
    eps = m["layernorm_epsilon"]
    dev = tokens.device
    pos = torch.arange(tokens.shape[0], device=dev)
    x = p["embed"][tokens.long()].to(F32)
    for i in range(m["num_hidden_layers"]):
        h = _rmsnorm(x, p[f"l{i}.ln1"], eps)
        x = x + _attention(m, p, i, h, pos, precision)
        h = _rmsnorm(x, p[f"l{i}.ln2"], eps)
        if is_moe(m, i):
            x = x + _moe(m, p, i, h, precision, routes)
        else:
            x = x + _swiglu(h, p[f"l{i}.wiu"], p[f"l{i}.wo_mlp"], precision)
    idx = torch.as_tensor(list(positions), device=dev)
    xs = _rmsnorm(x[idx], p["final_norm"], eps)
    return _mm(xs, p["head"], precision)


# ---------------------------------------------------------------------------
# The two-kind pool: its layers, rows, attention and accounting
# ---------------------------------------------------------------------------
def pool_layers(m: Dict) -> Tuple[int, int]:
    """(first full layer, first window layer): the layers whose rows the
    pool's full and window kinds hold."""
    kinds = m["hybrid_layer_pattern"][:m["num_hidden_layers"]]
    return kinds.index(0), kinds.index(1)


def ring_pages(m: Dict, page: int) -> int:
    """A window sequence's ring of pages: a window's worth."""
    return m["sliding_window"] // page


def page_bytes(m: Dict, page: int, window: bool) -> int:
    """A page of the full or window kind: `page` tokens' K (head_dim) and V
    (v_head_dim) rows of each of the kind's KV heads, 2 B an element."""
    kh = m["swa_num_key_value_heads" if window else "num_key_value_heads"]
    return page * kh * (m["head_dim"] + m["v_head_dim"]) * 2


def pool_rows(m: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
              layer: int, precision: str = "f32"):
    """Layer `layer`'s keys (S, K, hd) after RoPE and values (S, K, hv) of
    a prompt `tokens` (S,), in float32: the pool rows of its kind."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens.long()].to(F32)
    for i in range(layer):
        h = _rmsnorm(x, params[f"l{i}.ln1"], m["layernorm_epsilon"])
        x = x + _attention(m, params, i, h, pos, precision)
        h = _rmsnorm(x, params[f"l{i}.ln2"], m["layernorm_epsilon"])
        x = x + (_moe(m, params, i, h, precision, None) if is_moe(m, i)
                 else _swiglu(h, params[f"l{i}.wiu"], params[f"l{i}.wo_mlp"],
                              precision))
    h = _rmsnorm(x, params[f"l{layer}.ln1"], m["layernorm_epsilon"])
    _, k, v = layer_kv(m, params, layer, h, pos, precision)
    return k, v


def pool_attention(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
                   n_ctx: int, window: Optional[int] = None,
                   sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode query per sequence against its cached positions: the
    first `n_ctx`, or with `window` the last ``min(n_ctx, window)`` of
    them (what a ring of a window's slots holds).  q (B, H, hd); keys (B,
    S, K, hd), values (B, S, K, hv) -> (B, H, hv), softmax(q k^T /
    sqrt(hd)) v in float32, with a sink logit per head where given; query
    head h on kv head h // (H / K)."""
    b, h, hd = q.shape
    kh = keys.shape[2]
    lo = 0 if window is None else max(n_ctx - window, 0)
    kq = keys[:, lo:n_ctx].to(F32).repeat_interleave(h // kh, dim=2)
    vq = values[:, lo:n_ctx].to(F32).repeat_interleave(h // kh, dim=2)
    att = torch.einsum("bhd,bshd->bhs", q.to(F32), kq) * hd ** -0.5
    if sinks is not None:
        col = sinks.to(F32)[None, :, None].expand(b, h, 1)
        probs = torch.cat([att, col], dim=-1).softmax(-1)[..., :-1]
    else:
        probs = att.softmax(-1)
    return torch.einsum("bhs,bshd->bhd", probs, vq)


def serve_inputs(requests: int, prefill: int, decode: int, vocab: int,
                 n_heads: int, widths: Sequence[int], rng_seed: int
                 ) -> Tuple[np.ndarray, List[List[np.ndarray]]]:
    """(prompts (requests, prefill) int, queries[step][kind] (requests, H,
    width) f32): the prompts, then at each step one query per sequence for
    each kind in turn, drawn from ``numpy.random.default_rng(rng_seed)``
    in that order."""
    rng = np.random.default_rng(rng_seed)
    prompts = np.stack([rng.integers(0, vocab, (1, prefill))[0]
                        for _ in range(requests)])
    queries = [[rng.standard_normal((requests, n_heads, w))
                .astype(np.float32) for w in widths]
               for _ in range(decode)]
    return prompts, queries


_FIELDS = ("allocs", "hbm_hits", "cxl_fetches", "promotions", "demotions",
           "cxl_bytes", "sim_seconds")


def kv_accounting(requests: int, prefill: int, decode: int, page: int,
                  hbm_pages: int, kinds: Sequence[Dict], read_gbps: float,
                  write_gbps: float) -> Dict:
    """The counters of one serving call's two-kind page pool:
    ``{"total": counters, "kinds": [counters + "pages" per kind]}``.

    `kinds` lists each kind's ``page_bytes`` and ``ring`` (pages a sequence
    holds at most, None for pages that grow), the full kind first.  A kind
    holds ``requests * (ring or max_blocks) + 8`` pages, ``max_blocks =
    (prefill + decode) // page + 2``, and hands out its highest free page
    first.  A new page starts in HBM; while more than `hbm_pages` pages of
    either kind are in HBM, the least recently used one is demoted to CXL,
    a tie going to the first request, then the full kind before the
    window kind, then the first block.  Every append and every gather ticks
    the clock; a gather touches every page of one kind of every sequence in
    order and fetches a CXL page (promoting it back to HBM while HBM has
    room).  A window sequence's token p lies in block (p mod (ring x page))
    // page of its ring.  Each crossing moves one page of its kind at the
    CXL path's read or write payload rate.

    Each request first appends its `prefill` tokens to each kind in turn;
    each decode step then gathers all sequences for each kind in turn and
    appends one token to each sequence's kinds in turn.
    """
    max_blocks = (prefill + decode) // page + 2
    pages: List[Tuple[int, int]] = []            # (kind, index) by page id
    free: List[List[int]] = []
    for j, kind in enumerate(kinds):
        n = requests * (kind["ring"] or max_blocks) + 8
        free.append(list(range(len(pages), len(pages) + n)))
        pages += [(j, 0)] * n
    tier = [0] * len(pages)
    last = [0] * len(pages)
    owner = [-1] * len(pages)
    block = [0] * len(pages)
    tables: List[Dict[int, List[int]]] = [{} for _ in kinds]
    lens: Dict[int, int] = {}
    total = dict.fromkeys(_FIELDS, 0)
    total["sim_seconds"] = 0.0
    per = [dict(total) for _ in kinds]
    clock, hbm = [0], [0]             # the tick; pages in use on HBM

    def in_hbm() -> List[int]:
        return [p for t in tables for pgs in t.values() for p in pgs
                if tier[p] == 0]

    def count(j: int, field: str, nbytes: int = 0, gbps: float = 0.0):
        for st in (total, per[j]):
            st[field] += 1
            if nbytes:
                st["cxl_bytes"] += nbytes
                st["sim_seconds"] += nbytes / (gbps * 1e9)

    def append(j: int, sid: int, n_tok: int) -> None:
        clock[0] += 1
        table, ring = tables[j][sid], kinds[j]["ring"]
        for t in range(lens[sid], lens[sid] + n_tok):
            blk = (t % (ring * page) if ring else t) // page
            if blk >= len(table):
                pg = free[j].pop()
                table.append(pg)
                tier[pg], owner[pg], block[pg] = 0, sid, blk
                hbm[0] += 1
                count(j, "allocs")
                while hbm[0] > hbm_pages:
                    victim = min(in_hbm(), key=lambda p: (
                        last[p], owner[p], pages[p][0], block[p]))
                    tier[victim] = 1
                    hbm[0] -= 1
                    count(pages[victim][0], "demotions",
                          kinds[pages[victim][0]]["page_bytes"], write_gbps)
            last[table[blk]] = clock[0]

    def gather(j: int, sids: Sequence[int]) -> None:
        clock[0] += 1
        blocks = kinds[j]["ring"] or max_blocks
        for sid in sids:
            for pg in tables[j][sid][:blocks]:
                last[pg] = clock[0]
                if tier[pg] == 1:
                    count(j, "cxl_fetches", kinds[j]["page_bytes"],
                          read_gbps)
                    if hbm[0] < hbm_pages:
                        tier[pg] = 0
                        hbm[0] += 1
                        count(j, "promotions")
                else:
                    count(j, "hbm_hits")

    for sid in range(requests):
        lens[sid] = 0
        for j in range(len(kinds)):
            tables[j][sid] = []
            append(j, sid, prefill)
        lens[sid] += prefill
    for _ in range(decode):
        for j in range(len(kinds)):
            gather(j, range(requests))
        for sid in range(requests):
            for j in range(len(kinds)):
                append(j, sid, 1)
            lens[sid] += 1
    for j, st in enumerate(per):
        st["pages"] = sum(len(t) for t in tables[j].values())
    return {"total": total, "kinds": per}
