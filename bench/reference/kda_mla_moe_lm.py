"""Plain PyTorch reference of Kimi-Linear-48B-A3B as one expert-parallel rank
holds it, of its first KDA layer's recurrent state, and of the serving
loop's pool (latent pages beside a state slot a sequence) and its
accounting.

Imports nothing of the program.  The weights are the benchmark's own tensors
(:func:`make_params` draws them), handed to the program and to this file
alike; the reference reads them layer by layer in float32, with TF32 off
for matrix products and cuDNN.  The configuration's keys are those of the
model's ``config.json``; ``num_experts`` counts the experts held here,
``expert_parallel`` names the router's width and the first held expert.

The model (Kimi-Linear's ``config.json`` and the Kimi Linear report; layer
i is a KDA layer where ``linear_attn_config.kda_layers``, 1-indexed, holds
i + 1, an MLA layer where ``full_attn_layers`` does):

    x = embed[tokens]
    per layer:  h = rmsnorm(x) * ln1
      KDA:      q | k | v = silu(causal depthwise conv_4(h @ wqkv)), per
                    channel, the conv's taps oldest first
                q = l2norm(q) / sqrt(128);  k = l2norm(k)     (32 heads)
                g_t = -exp(A_log_h) * softplus(h_t @ wf_a @ wf_b + dt_bias)
                beta_t = sigmoid(h_t @ wb)
                S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1}
                      + beta_t k_t v_t^T,   S_0 = 0      (S: 128 x 128)
                o_t = S_t^T q_t
                x += (rmsnorm_128(o) * o_norm * sigmoid(h @ wg_a @ wg_b))
                     @ wo
      MLA:      q = h @ wq                    32 heads x (nope 128 | rope 64)
                c = h @ wkv_a;  ckv = rmsnorm(c[:512]) * kv_norm
                k_rope = c[512:]              (one head; ``mla_use_nope``:
                                               no rotary anywhere)
                k_nope | v = ckv @ wkv_b
                x += softmax(q . [k_nope | k_rope] / sqrt(192), causal) v
                     @ wo
                h = rmsnorm(x) * ln2
      layer 0 (``first_k_dense_replace``):  x += (silu(g) * u) @ wo_mlp,
                                             g | u = h @ wiu
      the others:  x += sum over the held experts e chosen for the token:
                   w_e (silu(g_e) * u_e) @ wo_e + the shared expert
    logits = (rmsnorm(x) * final_norm) @ head

The KDA recurrence runs in its chunkwise form (:func:`kda_scan`, chunks of
``kda_chunk`` positions; within a chunk the WY form ``(I + A) U =
diag(beta) (V - (K exp G) S)`` with every decayed product taken pair by
pair, ``exp(G_t - G_s)``, G the decay summed within the chunk; between
chunks the state carried), so that 16k positions fit; :func:`kda_recurrent`
is the step-by-step recurrence that a CPU test holds it to.

The gate (``moe_router_activation_func`` sigmoid, one group, ``noaux``):
scores = sigmoid(h @ router) over all ``router_experts``; the top
``num_experts_per_token`` of scores + the score-correction bias are the
token's experts; their weights are their unbiased scores over the scores'
sum (``moe_renormalize``), times ``routed_scaling_factor``.  Only the held
experts' part is computed: what the absent experts would add lies on other
ranks.

Departures from the published description, each also the program's: the
weights are bf16 random draws, the score-correction bias, ``A_log`` (log of
U(1, 16), one per head), ``dt_bias`` (softplus^-1 of a log-uniform step in
[0.001, 0.1], one per key channel) drawn from the seed; the decay's and the
output gate's low-rank projections are 128 wide (``head_dim``); the
convolution's window is kept in bf16 by the program.

`precision` selects how the matrix products' operands are held: "f32";
"fp8", each operand rounded to float8 e4m3 with one scale per tensor and
the product accumulated in float32 — the control's precision (the KDA
recurrence's q, k and v rounded alike); or "bf16".
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# the references beside this file: the CXL path's rates, the comparison's
# measures, the float products, the latent attention and the pool's
# accounting
from reference import dense_lm as _DENSE
from reference import hybrid_moe_lm as _HYBRID
from reference import mla_moe_lm as _MLA

F32 = torch.float32
QUERY_BLOCK = 1024
L2_EPS = 1e-6

cxl_payload_gbps = _DENSE.cxl_payload_gbps
serve_inputs = _DENSE.serve_inputs
greedy_gap = _DENSE.greedy_gap
max_rel_err = _DENSE.max_rel_err
round_fp8 = _DENSE.round_fp8
latent_attention = _MLA.latent_attention
kv_accounting = _HYBRID.kv_accounting
_round, _mm, _rmsnorm, _swiglu = (_MLA._round, _MLA._mm, _MLA._rmsnorm,
                                  _MLA._swiglu)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
def held(m: Dict) -> Tuple[int, int]:
    """(first held expert, experts held)."""
    return m["expert_parallel"]["first_held_expert"], m["num_experts"]


def router_experts(m: Dict) -> int:
    return m["expert_parallel"]["router_experts"]


def is_kda(m: Dict, i: int) -> bool:
    return i + 1 in m["linear_attn_config"]["kda_layers"]


def is_moe(m: Dict, i: int) -> bool:
    return i >= m["first_k_dense_replace"]


def kda_dims(m: Dict) -> Tuple[int, int, int]:
    """(heads, head width, convolution taps) of a KDA layer."""
    la = m["linear_attn_config"]
    return la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]


def latent_width(m: Dict) -> int:
    """One token's row of the latent pool: the latent and the rope key."""
    return m["kv_lora_rank"] + m["qk_rope_head_dim"]


def leaf_shapes(m: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every bf16 matrix, in the order they are laid
    out in one flat buffer; the scale is 1/sqrt(fan in) (0.02 for the
    embedding)."""
    d, v, n = m["hidden_size"], m["vocab_size"], m["num_attention_heads"]
    kvl, nope, rope, vd = (m["kv_lora_rank"], m["qk_nope_head_dim"],
                           m["qk_rope_head_dim"], m["v_head_dim"])
    f, fe = m["intermediate_size"], m["moe_intermediate_size"]
    fs = fe * m["num_shared_experts"]
    h, dk, cw = kda_dims(m)
    w, r = h * dk, dk
    _, e = held(m)
    out = [("embed", (v, d), 0.02)]
    for i in range(m["num_hidden_layers"]):
        if is_kda(m, i):
            out += [(f"l{i}.wqkv", (d, 3 * w), d ** -0.5),
                    (f"l{i}.conv", (3 * w, cw), cw ** -0.5),
                    (f"l{i}.wf_a", (d, r), d ** -0.5),
                    (f"l{i}.wf_b", (r, w), r ** -0.5),
                    (f"l{i}.wb", (d, h), d ** -0.5),
                    (f"l{i}.wg_a", (d, r), d ** -0.5),
                    (f"l{i}.wg_b", (r, w), r ** -0.5),
                    (f"l{i}.wo", (w, d), w ** -0.5)]
        else:
            out += [(f"l{i}.wq", (d, n * (nope + rope)), d ** -0.5),
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
    """(name, length) of every float32 vector and router drawn normal, in
    draw order: the norm scales (the MLA layers' latent norm and the KDA
    layers' output norm among them), the routers (flattened (d,
    router_experts)) and the score-correction biases."""
    d, layers = m["hidden_size"], m["num_hidden_layers"]
    _, dk, _ = kda_dims(m)
    out = []
    for i in range(layers):
        norm = ((f"l{i}.o_norm", dk) if is_kda(m, i)
                else (f"l{i}.kv_norm", m["kv_lora_rank"]))
        out += [(f"l{i}.ln1", d), norm, (f"l{i}.ln2", d)]
    out.append(("final_norm", d))
    routers = [i for i in range(layers) if is_moe(m, i)]
    out += [(f"l{i}.router", d * router_experts(m)) for i in routers]
    out += [(f"l{i}.bias", router_experts(m)) for i in routers]
    return out


def make_params(m: Dict, seed: int, device, norm_noise: float
                ) -> Dict[str, torch.Tensor]:
    """Every weight from `seed`, on `device`, in three draws: the matrices
    from one normal draw in the served dtype, each scaled in place; the
    float32 vectors from one normal draw: norm scales 1 + `norm_noise` x,
    routers scaled by 1/sqrt(d), biases ``weights.score_bias_std`` x; the
    KDA layers' ``A_log`` = log(1 + 15 u) per head and ``dt_bias`` =
    softplus^-1(exp(ln 0.001 + u ln 100)) per key channel from one uniform
    draw u."""
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
    h, dk, _ = kda_dims(m)
    kda = [i for i in range(m["num_hidden_layers"]) if is_kda(m, i)]
    u = torch.rand(len(kda) * (h + h * dk), generator=gen, dtype=F32,
                   device=device)
    for j, i in enumerate(kda):
        at = j * (h + h * dk)
        out[f"l{i}.A_log"] = torch.log1p(15.0 * u[at:at + h])
        step = torch.exp(math.log(1e-3) + math.log(100.0)
                         * u[at + h:at + h + h * dk])
        out[f"l{i}.dt_bias"] = step + torch.log(-torch.expm1(-step))
    return out


# ---------------------------------------------------------------------------
# KDA
# ---------------------------------------------------------------------------
def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + L2_EPS)


def kda_inputs(m: Dict, p: Dict[str, torch.Tensor], i: int, h: torch.Tensor,
               precision: str = "f32",
               window: Optional[torch.Tensor] = None):
    """Layer i's q, k (S, H, dk), v (S, H, dv), g (S, H, dk), beta (S, H)
    of its normed input `h` (S, d) after the convolution's `window` (the
    last taps - 1 projections before h, zeros at the start), and the last
    taps - 1 projections (the next window)."""
    heads, dk, cw = kda_dims(m)
    s = h.shape[0]
    proj = _mm(h, p[f"l{i}.wqkv"], precision)                  # (S, 3 w)
    prev = (torch.zeros((cw - 1, proj.shape[1]), dtype=F32, device=h.device)
            if window is None else window.to(F32))
    seq = torch.cat([prev, proj])
    taps = p[f"l{i}.conv"].to(F32)
    mixed = sum(seq[j:j + s] * taps[:, j] for j in range(cw))
    q, k, v = F.silu(mixed).view(s, 3, heads, dk).unbind(1)
    q = _l2norm(q) * dk ** -0.5
    k = _l2norm(k)
    f = _mm(_mm(h, p[f"l{i}.wf_a"], precision), p[f"l{i}.wf_b"], precision)
    g = -torch.exp(p[f"l{i}.A_log"]).repeat_interleave(dk) * F.softplus(
        f + p[f"l{i}.dt_bias"])
    beta = torch.sigmoid(_mm(h, p[f"l{i}.wb"], precision))
    q, k, v = (_round(t, precision) for t in (q, k, v))
    return q, k, v, g.view(s, heads, dk), beta, seq[-(cw - 1):]


def kda_recurrent(q, k, v, g, beta, state=None):
    """The recurrence token by token: q, k, g (S, H, dk), v (S, H, dv),
    beta (S, H) -> (o (S, H, dv), the final state (H, dk, dv))."""
    s, heads, dk = k.shape
    st = (torch.zeros((heads, dk, v.shape[-1]), dtype=F32, device=k.device)
          if state is None else state.clone())
    out = []
    for t in range(s):
        st = st * torch.exp(g[t])[..., None]
        st = st + beta[t][:, None, None] * k[t][..., None] * (
            v[t] - torch.einsum("hk,hkv->hv", k[t], st))[:, None, :]
        out.append(torch.einsum("hk,hkv->hv", q[t], st))
    return torch.stack(out), st


def kda_scan(q, k, v, g, beta, chunk: int = 64, state=None):
    """:func:`kda_recurrent` in chunks of `chunk` positions."""
    s, heads, dk = k.shape
    dv = v.shape[-1]
    st = (torch.zeros((heads, dk, dv), dtype=F32, device=k.device)
          if state is None else state.clone())
    out = torch.empty((s, heads, dv), dtype=F32, device=k.device)
    for t0 in range(0, s, chunk):
        qc, kc, vc, gc = (x[t0:t0 + chunk].transpose(0, 1)
                          for x in (q, k, v, g))          # (H, c, .)
        bc = beta[t0:t0 + chunk].transpose(0, 1)          # (H, c)
        c = kc.shape[1]
        G = gc.cumsum(1)
        on_or_below = torch.ones((c, c), dtype=torch.bool,
                                 device=k.device).tril()
        decay = torch.exp((G[:, :, None, :] - G[:, None, :, :]).masked_fill(
            ~on_or_below[:, :, None], -math.inf))          # (H, c, c, dk)
        kk = torch.einsum("htd,hsd,htsd->hts", kc, kc, decay).tril(-1)
        eye = torch.eye(c, dtype=F32, device=k.device)
        rhs = bc[..., None] * (vc - (kc * torch.exp(G)) @ st)
        u = torch.linalg.solve_triangular(eye + bc[..., None] * kk, rhs,
                                          upper=False, unitriangular=True)
        qk = torch.einsum("htd,hsd,htsd->hts", qc, kc, decay)
        out[t0:t0 + chunk] = ((qc * torch.exp(G)) @ st
                              + qk @ u).transpose(0, 1)
        st = (torch.exp(G[:, -1])[..., None] * st
              + (kc * torch.exp(G[:, -1:] - G)).transpose(1, 2) @ u)
    return out, st


def _kda(m, p, i, h, precision) -> torch.Tensor:
    heads, dk, _ = kda_dims(m)
    s = h.shape[0]
    q, k, v, g, beta, _ = kda_inputs(m, p, i, h, precision)
    o, _ = kda_scan(q, k, v, g, beta, m["kda_chunk"])
    gate = _mm(_mm(h, p[f"l{i}.wg_a"], precision), p[f"l{i}.wg_b"],
               precision).view(s, heads, dk)
    o = _rmsnorm(o, p[f"l{i}.o_norm"], m["rms_norm_eps"]) * torch.sigmoid(
        gate)
    return _mm(o.reshape(s, heads * dk), p[f"l{i}.wo"], precision)


# ---------------------------------------------------------------------------
# MLA, the experts, the forward
# ---------------------------------------------------------------------------
def softmax_scale(m: Dict) -> float:
    """(nope + rope) ** -0.5: no rotary, so no YaRN factor."""
    return (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5


def _latent(m, p, i, h, precision):
    """Layer i's normed latent (S, kv_lora) and rope key (S, rope), as
    projected: ``mla_use_nope``."""
    kvl = m["kv_lora_rank"]
    c = _mm(h, p[f"l{i}.wkv_a"], precision)
    return _rmsnorm(c[:, :kvl], p[f"l{i}.kv_norm"], m["rms_norm_eps"]), \
        c[:, kvl:]


def _mla(m, p, i, h, precision) -> torch.Tensor:
    n, s = m["num_attention_heads"], h.shape[0]
    nope, rope, vd = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    q = _mm(h, p[f"l{i}.wq"], precision).view(s, n, nope + rope)
    ckv, k_rope = _latent(m, p, i, h, precision)
    kv = _mm(ckv, p[f"l{i}.wkv_b"], precision).view(s, n, nope + vd)
    k = torch.cat([kv[..., :nope], k_rope[:, None, :].expand(s, n, rope)],
                  dim=-1)
    q, k, v = (_round(t, precision) for t in (q, k, kv[..., nope:]))
    o = torch.empty((s, n, vd), dtype=F32, device=h.device)
    pos = torch.arange(s, device=h.device)
    for q0 in range(0, s, QUERY_BLOCK):                # queries in blocks
        sl = slice(q0, q0 + QUERY_BLOCK)
        att = torch.einsum("qhd,khd->hqk", q[sl], k) * softmax_scale(m)
        att = att.masked_fill(pos[None, None, :] > pos[sl][None, :, None],
                              -math.inf).softmax(-1)
        o[sl] = torch.einsum("hqk,khd->qhd", att, v)
    return _mm(o.reshape(s, n * vd), p[f"l{i}.wo"], precision)


def gate(m: Dict, scores: torch.Tensor, bias: torch.Tensor,
         experts: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sigmoid gate on `scores` (T, E): (weights (T, k), experts (T,
    k)); one group, so the group limit keeps every expert.  Given
    `experts`, a route chosen elsewhere, their weights alone."""
    if experts is None:
        experts = (scores + bias).topk(m["num_experts_per_token"],
                                       dim=-1).indices
    experts = experts.long()
    w = scores.gather(1, experts)
    if m["moe_renormalize"]:
        w = w / w.sum(-1, keepdim=True)
    return w * m["routed_scaling_factor"], experts


def _moe(m, p, i, h, precision, routes, forced=None) -> torch.Tensor:
    scores = torch.sigmoid(_mm(h, p[f"l{i}.router"], precision))
    w, experts = gate(m, scores, p[f"l{i}.bias"], forced)
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


def _layer(m, p, i, x, precision, routes, force) -> torch.Tensor:
    eps = m["rms_norm_eps"]
    h = _rmsnorm(x, p[f"l{i}.ln1"], eps)
    x = x + (_kda if is_kda(m, i) else _mla)(m, p, i, h, precision)
    h = _rmsnorm(x, p[f"l{i}.ln2"], eps)
    if is_moe(m, i):
        forced = (None if force is None
                  else force[i - m["first_k_dense_replace"]][:h.shape[0]])
        return x + _moe(m, p, i, h, precision, routes, forced)
    return x + _swiglu(h, p[f"l{i}.wiu"], p[f"l{i}.wo_mlp"], precision)


class _NoTF32:
    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def forward(m: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            positions: Sequence[int], precision: str = "f32",
            routes: Optional[List[torch.Tensor]] = None,
            force: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Logits (len(positions), V) at `positions` of one sequence `tokens`
    (S,), in float32; each MoE layer's experts (S, k) appended to `routes`
    when given.  With `force` (per MoE layer, the experts (S, k) another
    run chose), each MoE layer takes those routes in place of its gate's
    choice, weighted by its own scores: the reference along another run's
    discrete path."""
    with _NoTF32():
        x = params["embed"][tokens.long()].to(F32)
        for i in range(m["num_hidden_layers"]):
            x = _layer(m, params, i, x, precision, routes, force)
        idx = torch.as_tensor(list(positions), device=tokens.device)
        xs = _rmsnorm(x[idx], params["final_norm"], m["rms_norm_eps"])
        return _mm(xs, params["head"], precision)


# ---------------------------------------------------------------------------
# The pool: the latent rows, the state slot, the accounting
# ---------------------------------------------------------------------------
def pool_layers(m: Dict) -> Tuple[int, int]:
    """(first MLA layer, first KDA layer): the layers whose latent rows the
    pool's pages hold and whose state the slots hold."""
    kinds = [is_kda(m, i) for i in range(m["num_hidden_layers"])]
    return kinds.index(False), kinds.index(True)


def pool_latent(m: Dict, params: Dict[str, torch.Tensor],
                tokens: torch.Tensor, precision: str = "f32",
                force: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """The first MLA layer's pool rows (S, 1, kv_lora + rope) of a prompt
    `tokens` (S,): the normed latent, then the rope key, in float32; the
    MoE layers before it along `force`'s routes when given (as
    :func:`forward`)."""
    layer, _ = pool_layers(m)
    with _NoTF32():
        x = params["embed"][tokens.long()].to(F32)
        for i in range(layer):
            x = _layer(m, params, i, x, precision, None, force)
        h = _rmsnorm(x, params[f"l{layer}.ln1"], m["rms_norm_eps"])
        ckv, k_rope = _latent(m, params, layer, h, precision)
    return torch.cat([ckv, k_rope], dim=-1)[:, None, :]


def layer_state(m: Dict, params: Dict[str, torch.Tensor],
                tokens: torch.Tensor, precision: str = "f32",
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """The first KDA layer's cache after `tokens` (S,), continuing from
    `state` (the cache after the tokens before them) or from zeros:
    ``{"S": (H, dk, dv), "conv": (taps - 1, 3 H dk)}`` in float32.  The
    first KDA layer is layer 0: its input is the embedding alone."""
    _, layer = pool_layers(m)
    if layer != 0:
        raise ValueError("the state kind's layer must be the first")
    with _NoTF32():
        x = params["embed"][tokens.long()].to(F32)
        h = _rmsnorm(x, params["l0.ln1"], m["rms_norm_eps"])
        q, k, v, g, beta, window = kda_inputs(
            m, params, 0, h, precision,
            None if state is None else state["conv"])
        _, s = kda_scan(q, k, v, g, beta, m["kda_chunk"],
                        None if state is None else state["S"])
    return {"S": s, "conv": window}


def latent_page_bytes(m: Dict, page: int) -> int:
    """A page of the latent kind: `page` rows of the latent and the rope
    key, 2 B an element, as the pool prices a page whatever it holds."""
    return page * latent_width(m) * 2


def slot_bytes(m: Dict) -> int:
    """A state slot: the float32 state of every head and the convolution's
    window of q | k | v projections at the served dtype's size."""
    heads, dk, cw = kda_dims(m)
    item = torch.tensor([], dtype=getattr(torch, m["dtype"])).element_size()
    return heads * dk * dk * 4 + (cw - 1) * 3 * heads * dk * item


def state_accounting(m: Dict, requests: int, decode: int) -> Dict[str, int]:
    """The state kind's counters after one serving call: a slot held by
    each request, written once by its prefill, then read and written back
    at each decode step."""
    b = slot_bytes(m)
    return {"slots": requests, "slot_bytes": b, "held_bytes": requests * b,
            "reads": requests * decode, "writes": requests * (1 + decode),
            "read_bytes": requests * decode * b,
            "written_bytes": requests * (1 + decode) * b}


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
