"""Mixture-of-Experts: capacity-based gather dispatch over every expert,
or an expert-parallel share dispatched without drops.

The port of ``repro.models.moe`` (``MoEConfig.held`` None):

  1. router top-k per token (f32);
  2. an (E, C) token-index table built by scatter: token t's rank within
     expert e (a running count over the T*k assignment list) gives its
     capacity slot, and an assignment whose rank reaches C is dropped;
  3. gather tokens into (E, C, D);
  4. the grouped expert FFN (two batched products over the experts);
  5. a weighted scatter-add combine back to (T, D), in ``x.dtype``.

Dispatch is global, as the reference's is outside a mesh.  The expert
products take f32 operands and give f32 results, as the reference's
``preferred_element_type=F32`` does (the down product in ``x.dtype``
under ``tp_reduce_bf16``).  The combine adds in ``x.dtype``; on the card
its bf16 atomics make the sum's order, and so its last bit, vary from
run to run.

A layer told which experts it holds (``MoEConfig.held = (first, count)``,
one rank of an expert-parallel deployment) routes every token over all
``n_experts`` with :func:`gate`, then computes, without drops, only the
assignments that land on its own experts: sorted by expert, one SwiGLU
product pair per held expert in the working dtype (f32 accumulation), and
a weighted f32 combine.  The shared expert is added once.  What the absent
experts would add is left out (on one card there is no exchange), so the
shares' outputs, each with its held experts only and the shared expert
counted once, sum to the whole layer's.  The sort's expert sizes are read
back to the host once per call.  Under a profiler the gate and sort are
the span ``moe.route``, the products and combine ``moe.experts``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, mlp, mlp_init, pdtype
from repro_torch.runtime.trace import span

F32 = torch.float32


def moe_init(gen: torch.Generator, cfg) -> Dict:
    m = cfg.moe
    d = cfg.d_model
    dt = pdtype(cfg)
    e, f = m.n_experts, m.expert_d_ff
    p = {
        "router": dense_init(gen, (d, e), dtype=F32),
        "wiu": dense_init(gen, (m.n_held, d, 2 * f), in_axis=-2, dtype=dt),
        "wo": dense_init(gen, (m.n_held, f, d), in_axis=-2, dtype=dt),
    }
    if m.score_bias:
        p["bias"] = torch.zeros((e,), dtype=F32, device=gen.device)
    if m.n_shared:
        sh = m.shared_d_ff or m.expert_d_ff
        p["shared"] = mlp_init(gen, d, m.n_shared * sh, dtype=dt)
    return p


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for `n_tokens` tokens: the capacity factor's share,
    at least 1, rounded up to a multiple of 8 (the reference's
    MXU-aligned C)."""
    m = cfg.moe
    c = max(int(m.capacity_factor * n_tokens * m.top_k / m.n_experts), 1)
    return -(-c // 8) * 8


def _dispatch_tables(expert_idx: torch.Tensor, weights: torch.Tensor,
                     n_experts: int, capacity: int, n_tokens: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build (E, C) token-index and weight tables from top-k assignments.

    expert_idx, weights: (T, k).  Returns (table (E, C) int32 with
    sentinel T for empty slots, wtable (E, C) f32).  Overflowing
    assignments all write slot C, which is sliced away (any of them may
    win there)."""
    t, k = expert_idx.shape
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1).long()                   # (T*k,)
    flat_w = weights.reshape(-1)
    # rank of each assignment within its expert: count of equal experts
    # strictly before it in flat order (an exclusive running count)
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)    # (T*k, E)
    ranks_all = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    rank = torch.gather(ranks_all, 1, flat_e[:, None])[:, 0]
    keep = rank < capacity
    slot = torch.where(keep, rank, capacity).long()          # overflow -> C
    token_of = torch.arange(t, dtype=torch.int32,
                            device=dev).repeat_interleave(k)
    table = torch.full((n_experts, capacity + 1), n_tokens,
                       dtype=torch.int32, device=dev)
    table = table.index_put((flat_e, slot),
                            torch.where(keep, token_of, n_tokens))
    wtable = torch.zeros((n_experts, capacity + 1), dtype=F32, device=dev)
    wtable = wtable.index_put((flat_e, slot),
                              torch.where(keep, flat_w, 0.0))
    return table[:, :capacity], wtable[:, :capacity]


_CHUNK = 8      # experts per f32 product: 0.4 GB of f32 weights at qwen3-moe


class _F32Bmm(torch.autograd.Function):
    """a (E, C, K) @ b (E, K, N) with an f32 result, as the reference's
    ``preferred_element_type=F32`` products: f32 operands, `_CHUNK`
    experts at a time so that only one chunk of the weights is ever held
    in f32.  The gradients are f32 products rounded to the operands'
    types, as JAX transposes a product with an f32 result."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = torch.empty(a.shape[:2] + b.shape[2:], dtype=F32,
                          device=a.device)
        for i in range(0, a.shape[0], _CHUNK):
            sl = slice(i, i + _CHUNK)
            torch.bmm(a[sl].to(F32), b[sl].to(F32), out=out[sl])
        return out

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga, gb = torch.empty_like(a), torch.empty_like(b)
        for i in range(0, a.shape[0], _CHUNK):
            sl = slice(i, i + _CHUNK)
            ga[sl] = torch.bmm(g[sl], b[sl].to(F32).mT)
            gb[sl] = torch.bmm(a[sl].to(F32).mT, g[sl])
        return ga, gb


_bmm_f32 = _F32Bmm.apply


def gate(params: Dict, xt: torch.Tensor, cfg
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route tokens xt (T, D) over all ``n_experts``: (weights (T, k) f32,
    experts (T, k) int64), as DeepSeek-V3's ``Gate``.

    Scores are the softmax or sigmoid of ``xt @ router`` in f32; the
    choice adds the score bias where the layer has one.  With groups, a
    group's score is its best choice (without a bias) or the sum of its two
    best (with one); the ``topk_group`` best groups are kept and the rest
    masked; then the top ``top_k`` choices.  The weights are the chosen
    experts' unbiased scores, divided by their sum for sigmoid scores,
    times ``routed_scale``."""
    m = cfg.moe
    t = xt.shape[0]
    logits = xt.to(F32) @ params["router"]
    scores = (torch.sigmoid(logits) if m.scoring == "sigmoid"
              else torch.softmax(logits, dim=-1))
    choice = scores + params["bias"] if "bias" in params else scores
    if m.n_group > 1:
        grouped = choice.view(t, m.n_group, -1)
        g_score = (grouped.topk(2, dim=-1).values.sum(-1) if "bias" in params
                   else grouped.amax(dim=-1))
        keep = g_score.topk(m.topk_group, dim=-1).indices
        drop = torch.ones((t, m.n_group), dtype=torch.bool,
                          device=xt.device).scatter_(1, keep, False)
        choice = grouped.masked_fill(drop[..., None], -torch.inf).flatten(1)
    experts = choice.topk(m.top_k, dim=-1).indices
    weights = scores.gather(1, experts)
    if m.scoring == "sigmoid":
        weights = weights / weights.sum(-1, keepdim=True)
    return weights * m.routed_scale, experts


def _held_ffn(params: Dict, xt: torch.Tensor, cfg, every_held: bool = False
              ) -> torch.Tensor:
    """The held experts' part of the routed output, (T, D) f32.

    The assignments to held experts are sorted by expert and each held
    expert runs on its own tokens, which the host reads back to size the
    products.  With `every_held` (a decode step's few tokens) every held
    expert runs on every token instead, and the products are weighted by
    the gate's weights, zero where a token is not routed to the expert:
    static shapes and nothing read back, so the host does not wait on the
    card."""
    m = cfg.moe
    first, n = m.held
    t, d = xt.shape
    f_ = m.expert_d_ff
    with span("moe.route"):
        weights, experts = gate(params, xt, cfg)
        local = experts - first
        held = (local >= 0) & (local < n)
        if every_held:
            w_held = torch.zeros((t, n), dtype=F32, device=xt.device
                                 ).scatter_add_(1, torch.where(held, local, 0),
                                                torch.where(held, weights, 0.0))
        else:
            bucket = torch.where(held, local, n).reshape(-1)
            order = torch.argsort(bucket, stable=True)
            sizes = torch.bincount(bucket, minlength=n + 1)[:n]
    with span("moe.experts"):
        if every_held:
            gu = torch.matmul(xt, params["wiu"])                # (n, T, 2F)
            h = F.silu(gu[..., :f_].to(F32)).to(xt.dtype) * gu[..., f_:]
            out = torch.bmm(h, params["wo"])                     # (n, T, D)
            return (out.to(F32) * w_held.T[..., None]).sum(0)
        sizes = sizes.tolist()
        mine = order[:sum(sizes)]
        tok = mine // m.top_k
        xs = xt[tok]
        out = torch.empty((mine.numel(), d), dtype=xt.dtype,
                          device=xt.device)
        at = 0
        for e, c in enumerate(sizes):
            if c:
                gu = xs[at:at + c] @ params["wiu"][e]
                h = F.silu(gu[:, :f_].to(F32)).to(xt.dtype) * gu[:, f_:]
                out[at:at + c] = h @ params["wo"][e]
                at += c
        w = weights.reshape(-1)[mine]
        return torch.zeros((t, d), dtype=F32, device=xt.device).index_add_(
            0, tok, out.to(F32) * w[:, None])


def moe_ffn(params: Dict, x: torch.Tensor, cfg, decode: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward. x (B, S, D) -> (y (B, S, D), aux_loss ()).

    Dispatch is global: the reference groups tokens by its data shards
    (a (G, E, C, D) dispatch), which is one group on one card.  A layer
    that holds a share of the experts (``MoEConfig.held``) computes its
    share without drops and has no aux loss; in a `decode` step every held
    expert runs on the step's tokens (:func:`_held_ffn`)."""
    m = cfg.moe
    b, s, d = x.shape
    if m.held is not None:
        y = _held_ffn(params, x.reshape(b * s, d), cfg, every_held=decode)
        y = y.to(x.dtype).reshape(b, s, d)
        if "shared" in params:
            y = y + mlp(params["shared"], x, cfg.act,
                        reduce_bf16=cfg.tp_reduce_bf16)
        return y, torch.zeros((), dtype=F32, device=x.device)
    t = b * s
    xt = x.reshape(t, d)

    # ---- router (f32) ----
    logits = xt.to(F32) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, m.top_k, dim=-1)        # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balancing aux loss (Switch-style) ----
    me = probs.mean(dim=0)                                   # (E,)
    flat_e = top_e.reshape(-1)
    # 1/(t*k) added once per assignment, as the reference's scatter-add
    ce = torch.zeros((m.n_experts,), dtype=F32, device=x.device).index_add_(
        0, flat_e, torch.full(flat_e.shape, 1.0 / (t * m.top_k), dtype=F32,
                              device=x.device))
    aux = m.n_experts * torch.sum(me * ce) * m.router_aux_weight

    # ---- dispatch tables and gather ----
    table, wtable = _dispatch_tables(top_e, top_w, m.n_experts,
                                     capacity(cfg, t), t)   # (E, C) each
    idx = table.long()
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])           # (T+1, D)
    xe = xt_pad[idx]                                         # (E, C, D)

    # ---- expert FFN (f32 products, as preferred_element_type=F32) ----
    f_ = m.expert_d_ff
    gu = _bmm_f32(xe, params["wiu"])
    g_, u = gu[..., :f_], gu[..., f_:]
    h = (F.silu(g_) * u).to(x.dtype)
    if cfg.tp_reduce_bf16:
        ye = torch.bmm(h, params["wo"].to(h.dtype))          # (E, C, D)
    else:
        ye = _bmm_f32(h, params["wo"])

    # ---- combine (weighted scatter-add, in x.dtype) ----
    ye = (ye.to(F32) * wtable[..., None]).to(x.dtype)
    y = xt.new_zeros((t + 1, d)).index_add_(
        0, idx.reshape(-1), ye.reshape(-1, d))[:t].reshape(b, s, d)

    if "shared" in params:
        y = y + mlp(params["shared"], x, cfg.act,
                    reduce_bf16=cfg.tp_reduce_bf16)
    return y, aux
