"""Plain PyTorch reference of DeepSeek-V3 as one expert-parallel rank holds
it, and of the serving loop's latent KV pool and its accounting.

Imports nothing of the program.  The weights are the benchmark's own tensors
(:func:`make_params` draws them), handed to the program and to this file
alike; the reference reads them layer by layer in float32, with TF32 off
for matrix products and cuDNN.  The configuration's keys are those of the
model's ``config.json``; ``n_routed_experts`` counts the experts held here,
``expert_parallel`` names the router's width and the first held expert.

The model (DeepSeek-V3's ``inference/model.py``, in its non-absorbed form):

    x = embed[tokens]
    per layer:  h = rmsnorm(x) * ln1
                q = (rmsnorm(h @ wq_a) * q_norm) @ wq_b        -> nope | rope
                c = h @ wkv_a;  ckv = rmsnorm(c[:kv_lora]) * kv_norm
                k_rope = yarn_rope(c[kv_lora:])                 (one head)
                k_nope | v = ckv @ wkv_b
                x += softmax((q . [k_nope | k_rope]) * scale, causal) v @ wo
                h = rmsnorm(x) * ln2
                dense layers:  x += (silu(g) * u) @ wo_mlp,  g | u = h @ wiu
                MoE layers:    x += sum over the held experts e chosen for
                               the token: w_e (silu(g_e) * u_e) @ wo_e
                               + the shared expert
    logits = (rmsnorm(x) * final_norm) @ head

The gate (DeepSeek-V3's ``Gate``, sigmoid scoring, ``noaux_tc``): scores
= sigmoid(h @ router) over all ``router_experts``; the choice adds the
score-correction bias; a group's score is the sum of its two best choices,
the ``topk_group`` best of ``n_group`` groups are kept; the top
``num_experts_per_tok`` choices are the token's experts; their weights are
their unbiased scores over the scores' sum, times
``routed_scaling_factor``.  Only the held experts' part is computed: what
the absent experts would add lies on other ranks.

YaRN (``rope_scaling``): the inverse frequencies of the rotary pairs
between floor(corr(beta_fast)) and ceil(corr(beta_slow)), corr(n) = dim
ln(original / (2 pi n)) / (2 ln theta), blend linearly from theta's to
theta's over ``factor``; cos and sin are scaled by mscale(factor, mscale) /
mscale(factor, mscale_all_dim); the softmax scale is (nope + rope) ** -0.5
times mscale(factor, mscale_all_dim) ** 2, mscale(f, m) = 0.1 m ln f + 1.

Departures from the published description, each also the program's:
the rotary pairs are the halves of the rope dims (the published code pairs
neighbouring dims: with random weights a permutation of ``wq_b``'s and
``wkv_a``'s columns); the multi-token-prediction layer is left out; the
weights are bf16 random draws (the deployment's are fp8 blocks); the
score-correction bias is drawn from the seed.

`precision` selects how the matrix products' operands are held: "f32";
"fp8", each operand rounded to float8 e4m3 with one scale per tensor and
the product accumulated in float32 — the control's precision; or "bf16",
each operand rounded to bfloat16 and the product accumulated in float32 —
the served dtype's rounding, a witness to what the program's readings
owe to it (the comparison never runs it).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# the dense reference beside this file: the CXL path's rates, the pool's
# accounting, the inputs and the comparison's measures
from reference import dense_lm as _DENSE

F32 = torch.float32

kv_accounting = _DENSE.kv_accounting
cxl_payload_gbps = _DENSE.cxl_payload_gbps
serve_inputs = _DENSE.serve_inputs
greedy_gap = _DENSE.greedy_gap
max_rel_err = _DENSE.max_rel_err
round_fp8 = _DENSE.round_fp8


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
def held(m: Dict) -> Tuple[int, int]:
    """(first held expert, experts held)."""
    return m["expert_parallel"]["first_held_expert"], m["n_routed_experts"]


def router_experts(m: Dict) -> int:
    return m["expert_parallel"]["router_experts"]


def latent_width(m: Dict) -> int:
    """One token's row of the latent pool: the latent and the rope key."""
    return m["kv_lora_rank"] + m["qk_rope_head_dim"]


def is_moe(m: Dict, i: int) -> bool:
    return i >= m["first_k_dense_replace"]


def leaf_shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every bf16 matrix, in the order they are laid
    out in one flat buffer; the scale is 1/sqrt(fan in) (0.02 for the
    embedding)."""
    d, v, n = m["hidden_size"], m["vocab_size"], m["num_attention_heads"]
    ql, kvl = m["q_lora_rank"], m["kv_lora_rank"]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    f, fe = m["intermediate_size"], m["moe_intermediate_size"]
    fs = fe * m["n_shared_experts"]
    _, e = held(m)
    out = [("embed", (v, d), 0.02)]
    for i in range(m["num_hidden_layers"]):
        out += [(f"l{i}.wq_a", (d, ql), d ** -0.5),
                (f"l{i}.wq_b", (ql, n * (nope + rope)), ql ** -0.5),
                (f"l{i}.wkv_a", (d, kvl + rope), d ** -0.5),
                (f"l{i}.wkv_b", (kvl, n * (nope + vd)), kvl ** -0.5),
                (f"l{i}.wo", (n * vd, d), (n * vd) ** -0.5)]
        if is_moe(m, i):
            out += [(f"l{i}.experts_wiu", (e, d, 2 * fe), d ** -0.5),
                    (f"l{i}.experts_wo", (e, fe, d), fe ** -0.5),
                    (f"l{i}.shared_wiu", (d, 2 * fs), d ** -0.5),
                    (f"l{i}.shared_wo", (fs, d), fs ** -0.5)]
        else:
            out += [(f"l{i}.wiu", (d, 2 * f), d ** -0.5),
                    (f"l{i}.wo_mlp", (f, d), f ** -0.5)]
    out.append(("head", (d, v), d ** -0.5))
    return out


def f32_shapes(m: Dict) -> List[Tuple[str, int]]:
    """(name, length) of every float32 vector and router, in draw order:
    the norm scales, the routers (flattened (d, router_experts)) and the
    score-correction biases."""
    d, ql, kvl = m["hidden_size"], m["q_lora_rank"], m["kv_lora_rank"]
    out = []
    for i in range(m["num_hidden_layers"]):
        out += [(f"l{i}.ln1", d), (f"l{i}.q_norm", ql),
                (f"l{i}.kv_norm", kvl), (f"l{i}.ln2", d)]
    out.append(("final_norm", d))
    routers = [i for i in range(m["num_hidden_layers"]) if is_moe(m, i)]
    out += [(f"l{i}.router", d * router_experts(m)) for i in routers]
    out += [(f"l{i}.bias", router_experts(m)) for i in routers]
    return out


def make_params(m: Dict, seed: int, device, norm_noise: float
                ) -> Dict[str, torch.Tensor]:
    """Every weight from `seed`, on `device`, in two draws: the matrices
    from one normal draw in the served dtype, each scaled in place; the
    float32 vectors from one normal draw: norm scales 1 + `norm_noise` x,
    routers scaled by 1/sqrt(d), biases ``weights.score_bias_std`` x."""
    bias_std = m["weights"]["score_bias_std"]
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
            out[name] = x.mul_(bias_std)
        else:
            out[name] = x.mul_(norm_noise).add_(1.0)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` (float32) as `precision` holds it, back in float32."""
    if precision == "fp8":
        return round_fp8(x)
    if precision == "bf16":
        return x.to(torch.bfloat16).to(F32)
    return x


def _mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    return _round(x, precision) @ _round(w.to(F32), precision)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(m: Dict) -> float:
    """(nope + rope) ** -0.5, times YaRN's mscale ** 2."""
    ys = m["rope_scaling"]
    return ((m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
            * _mscale(ys["factor"], ys["mscale_all_dim"]) ** 2)


def yarn_inv_freq(m: Dict, device) -> torch.Tensor:
    """The rope pairs' inverse frequencies under YaRN (rope dims / 2,)."""
    dim, theta = m["qk_rope_head_dim"], m["rope_theta"]
    ys = m["rope_scaling"]
    base = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=F32,
                                        device=device) / dim)

    def corr(n):
        return dim * math.log(ys["original_max_position_embeddings"]
                              / (n * 2 * math.pi)) / (2 * math.log(theta))
    lo = max(math.floor(corr(ys["beta_fast"])), 0)
    hi = min(math.ceil(corr(ys["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=F32, device=device) - lo)
            / max(hi - lo, 0.001)).clamp(0, 1)
    return base / ys["factor"] * ramp + base * (1 - ramp)


def _rope(x: torch.Tensor, pos: torch.Tensor, m: Dict) -> torch.Tensor:
    """x (S, H, rope) rotated by halves at positions `pos` (S,)."""
    ys = m["rope_scaling"]
    amp = (_mscale(ys["factor"], ys["mscale"])
           / _mscale(ys["factor"], ys["mscale_all_dim"]))
    ang = pos.to(F32)[:, None] * yarn_inv_freq(m, x.device)[None, :]
    cos = (torch.cos(ang) * amp)[:, None, :]
    sin = (torch.sin(ang) * amp)[:, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _latent(m, p, i, h, pos, precision):
    """Layer i's normed latent (S, kv_lora) and roped rope key (S, rope)."""
    kvl = m["kv_lora_rank"]
    c = _mm(h, p[f"l{i}.wkv_a"], precision)
    ckv = _rmsnorm(c[:, :kvl], p[f"l{i}.kv_norm"], m["rms_norm_eps"])
    return ckv, _rope(c[:, None, kvl:], pos, m)[:, 0]


def _attention(m, p, i, h, pos, precision) -> torch.Tensor:
    n, s = m["num_attention_heads"], h.shape[0]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    eps = m["rms_norm_eps"]
    q = _mm(_rmsnorm(_mm(h, p[f"l{i}.wq_a"], precision), p[f"l{i}.q_norm"],
                     eps), p[f"l{i}.wq_b"], precision).view(s, n, nope + rope)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], pos, m)], dim=-1)
    ckv, k_rope = _latent(m, p, i, h, pos, precision)
    kv = _mm(ckv, p[f"l{i}.wkv_b"], precision).view(s, n, nope + vd)
    k = torch.cat([kv[..., :nope], k_rope[:, None, :].expand(s, n, rope)],
                  dim=-1)
    v = kv[..., nope:]
    q, k, v = (_round(t, precision) for t in (q, k, v))
    allowed = pos[None, :] <= pos[:, None]
    o = torch.empty((s, n, vd), dtype=F32, device=h.device)
    for h0 in range(0, n, 32):                    # heads in blocks
        sl = slice(h0, h0 + 32)
        att = torch.einsum("qhd,khd->hqk", q[:, sl], k[:, sl]) \
            * softmax_scale(m)
        att = att.masked_fill(~allowed[None], -math.inf).softmax(-1)
        o[:, sl] = torch.einsum("hqk,khd->qhd", att, v[:, sl])
    return _mm(o.reshape(s, n * vd), p[f"l{i}.wo"], precision)


def _swiglu(h, wiu, wo, precision):
    gu = _mm(h, wiu, precision)
    f = gu.shape[-1] // 2
    return _mm(torch.nn.functional.silu(gu[:, :f]) * gu[:, f:], wo,
               precision)


def gate(m: Dict, scores: torch.Tensor, bias: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's sigmoid gate on `scores` (T, E): (weights (T, k),
    experts (T, k))."""
    t, e = scores.shape
    g = m["n_group"]
    choice = (scores + bias).view(t, g, e // g)
    best = choice.topk(2, dim=-1).values.sum(-1)              # (T, G)
    keep = best.topk(m["topk_group"], dim=-1).indices
    masked = torch.full_like(choice, -math.inf)
    idx = keep[..., None].expand(t, m["topk_group"], e // g)
    masked.scatter_(1, idx, choice.gather(1, idx))
    experts = masked.view(t, e).topk(m["num_experts_per_tok"],
                                     dim=-1).indices
    w = scores.gather(1, experts)
    return w / w.sum(-1, keepdim=True) * m["routed_scaling_factor"], experts


def _moe(m, p, i, h, precision, routes) -> torch.Tensor:
    scores = torch.sigmoid(_mm(h, p[f"l{i}.router"], precision))
    w, experts = gate(m, scores, p[f"l{i}.bias"])
    if routes is not None:
        routes.append(experts)
    first, n_held = held(m)
    y = _swiglu(h, p[f"l{i}.shared_wiu"], p[f"l{i}.shared_wo"], precision)
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
    eps = m["rms_norm_eps"]
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
# The latent pool
# ---------------------------------------------------------------------------
def layer0_latent(m: Dict, params: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, precision: str = "f32"
                  ) -> torch.Tensor:
    """Layer 0's pool rows (S, 1, kv_lora + rope): the normed latent, then
    the roped rope key, in float32."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens.long()].to(F32)
    h = _rmsnorm(x, params["l0.ln1"], m["rms_norm_eps"])
    ckv, k_rope = _latent(m, params, 0, h, pos, precision)
    return torch.cat([ckv, k_rope], dim=-1)[:, None, :]


def latent_attention(q: torch.Tensor, rows: torch.Tensor, n_ctx: int,
                     scale: float, v_dim: int) -> torch.Tensor:
    """The absorbed decode's attention over the pool: q (B, H, W) against
    each sequence's first `n_ctx` rows (B, S, 1, W) as keys, their first
    `v_dim` columns as values -> (B, H, v_dim), in float32."""
    r = rows[:, :n_ctx, 0].to(F32)
    att = torch.einsum("bhw,bsw->bhs", q.to(F32), r) * scale
    return torch.einsum("bhs,bsv->bhv", att.softmax(-1), r[..., :v_dim])


def latent_page_bytes(m: Dict, page: int) -> int:
    """A page of the latent pool: `page` rows of the latent and the rope
    key, at the served dtype's size."""
    item = torch.tensor([], dtype=getattr(torch, m["dtype"])).element_size()
    return page * latent_width(m) * item


def held_mismatch(got: torch.Tensor, want: torch.Tensor, m: Dict) -> int:
    """Held assignments in one and not the other of two routings (S, k) of
    the same positions."""
    first, n = held(m)

    def one_hot(experts):
        local = experts.long() - first
        mine = (local >= 0) & (local < n)
        out = torch.zeros((experts.shape[0], n + 1), dtype=torch.bool,
                          device=experts.device)
        return out.scatter_(1, torch.where(mine, local, n), True)[:, :n]
    return int((one_hot(got) != one_hot(want)).sum())
