"""Kimi Delta Attention (KDA): Kimi-Linear's gated delta-rule linear
attention.

Per head h and token t, keys and values ``head_dim`` (dk, dv) wide:

    q | k | v = SiLU(causal depthwise conv(x @ wqkv))    (``conv`` taps)
    q = l2norm(q) / sqrt(dk);  k = l2norm(k)
    g_t = -exp(A_log_h) * softplus(x_t @ wf_a @ wf_b + dt_bias)  (a decay
          per key channel, <= 0)
    beta_t = sigmoid(x_t @ wb)
    S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t
    y = (rmsnorm_dv(o) * o_norm * sigmoid(x @ wg_a @ wg_b)) @ wo

The projections run in the working dtype with f32 accumulation; the
convolution, the norms, the gates and the recurrence in f32.

A prefill runs the chunkwise form (:func:`chunk_scan`, in chunks of
``KDAConfig.chunk`` positions): within a chunk the WY form of the delta
rule, ``U = (I + A)^-1 diag(beta) (V - K~ S)``, with every decayed product
``sum_d a_c[d] b_i[d] exp(G_c[d] - G_i[d])`` taken through a reference
position between c and i, so that no exponent is positive (G the decay
summed within the chunk); between chunks the state is carried,
``S' = F S + B``, one product a chunk.  A decode step runs one recurrent
step (:func:`kda_decode`) that updates the state and the convolution's
window in place, with static shapes, so that it is captured into a CUDA
graph with the rest of the step.

Cache entry: ``{"S": (B, H, dk, dv) f32, "conv": (B, conv - 1, 3 H dk)}``,
the state and the convolution's last ``conv - 1`` inputs (the q | k | v
projections, in the working dtype).  Under a profiler a prefill's chunk
loop is the span ``kda.scan``, a decode step's ``kda.step``;
``LAUNCHES["kda_chunks"]`` counts the chunks scanned and
``LAUNCHES["kda_steps"]`` the decode steps run (eagerly or captured; a
replay counts none).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import LAUNCHES
from repro_torch.models.layers import ShapeOnly, dense_init, matmul, pdtype
from repro_torch.runtime.trace import span

F32 = torch.float32
_GROUP = 1 << 27    # elements of the largest within-chunk temporary
NORM_EPS = 1e-6     # the l2 norm of q and k


def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=F32, device=gen.device)
    return torch.rand(shape, generator=gen, dtype=F32,
                      device=gen.device) * (hi - lo) + lo


def kda_init(gen: torch.Generator, cfg) -> Dict:
    """A KDA layer of `cfg`: the fused q | k | v projection and its
    convolution, the decay's and the output gate's low-rank projections
    (through a head's width),
    beta's, the output projection; ``A_log`` per head (log of U(1, 16)),
    ``dt_bias`` per key channel (softplus of it log-uniform in [0.001,
    0.1]) and the output norm's scale, f32."""
    a = cfg.kda
    d, w, r = cfg.d_model, a.n_heads * a.head_dim, a.head_dim
    dt = pdtype(cfg)
    step = torch.exp(_uniform(gen, (w,), math.log(1e-3), math.log(0.1)))
    return {
        "wqkv": dense_init(gen, (d, 3 * w), dtype=dt),
        "conv": dense_init(gen, (3 * w, a.conv), in_axis=-1, dtype=dt),
        "wf_a": dense_init(gen, (d, r), dtype=dt),
        "wf_b": dense_init(gen, (r, w), dtype=dt),
        "wb": dense_init(gen, (d, a.n_heads), dtype=dt),
        "wg_a": dense_init(gen, (d, r), dtype=dt),
        "wg_b": dense_init(gen, (r, w), dtype=dt),
        "wo": dense_init(gen, (w, d), dtype=dt),
        "A_log": torch.log(_uniform(gen, (a.n_heads,), 1.0, 16.0)),
        "dt_bias": step + torch.log(-torch.expm1(-step)),
        "o_norm": {"scale": torch.ones((a.head_dim,), dtype=F32,
                                       device=gen.device)},
    }


def state_shapes(cfg) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """One sequence's cache entry, leaf by leaf: (shape, dtype)."""
    a = cfg.kda
    return {"S": ((a.n_heads, a.head_dim, a.head_dim), F32),
            "conv": ((a.conv - 1, 3 * a.n_heads * a.head_dim), pdtype(cfg))}


def state_bytes(cfg) -> int:
    """One sequence's cache entry in bytes: its state and window."""
    return sum(math.prod(shape) * dt.itemsize
               for shape, dt in state_shapes(cfg).values())


def kda_state_init(cfg, batch: int, device) -> Dict:
    """Zero caches for `batch` sequences."""
    return {name: torch.zeros((batch,) + shape, dtype=dt, device=device)
            for name, (shape, dt) in state_shapes(cfg).items()}


# ---------------------------------------------------------------------------
# Inputs of the recurrence
# ---------------------------------------------------------------------------
def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + NORM_EPS)


def _inputs(params: Dict, x: torch.Tensor, cfg, window: torch.Tensor):
    """The recurrence's inputs of the normed input `x` (B, T, d) after the
    convolution's `window` (B, conv - 1, 3 H dk): q, k (B, T, H, dk), v
    (B, T, H, dv), g (B, T, H, dk), beta (B, T, H), all f32, and the last
    ``conv - 1`` projections (the next window)."""
    a = cfg.kda
    b, t, _ = x.shape
    h, dk = a.n_heads, a.head_dim
    proj = matmul(x, params["wqkv"])                        # (B, T, 3 H dk)
    seq = torch.cat([window.to(proj.dtype), proj], dim=1).to(F32)
    w = params["conv"].to(F32)                               # (C, conv)
    mixed = seq[:, :t] * w[:, 0]
    for j in range(1, a.conv):
        mixed = mixed + seq[:, j:j + t] * w[:, j]
    q, k, v = F.silu(mixed).view(b, t, 3, h, dk).unbind(2)
    q = _l2norm(q) * dk ** -0.5
    k = _l2norm(k)
    f = matmul(matmul(x, params["wf_a"]), params["wf_b"]).to(F32)
    g = (-torch.exp(params["A_log"]).repeat_interleave(dk)
         * F.softplus(f + params["dt_bias"])).view(b, t, h, dk)
    beta = torch.sigmoid(matmul(x, params["wb"]).to(F32))
    return q, k, v, g, beta, seq[:, t:].to(window.dtype)


def _output(params: Dict, o: torch.Tensor, x: torch.Tensor, cfg
            ) -> torch.Tensor:
    """The layer's output of the recurrence's `o` (B, T, H, dv) f32."""
    a = cfg.kda
    b, t, _ = x.shape
    gate = matmul(matmul(x, params["wg_a"]), params["wg_b"]).to(F32)
    o = o * torch.rsqrt((o * o).mean(-1, keepdim=True) + cfg.norm_eps) \
        * params["o_norm"]["scale"]
    o = o * torch.sigmoid(gate.view(b, t, a.n_heads, a.head_dim))
    return matmul(o.to(x.dtype).reshape(b, t, -1), params["wo"])


# ---------------------------------------------------------------------------
# The chunkwise form
# ---------------------------------------------------------------------------
def _decayed(a: torch.Tensor, b: torch.Tensor, G: torch.Tensor,
             inclusive: bool) -> torch.Tensor:
    """``P[c, i] = sum_d a_c[d] b_i[d] exp(G_c[d] - G_i[d])`` for i < c
    (i <= c with `inclusive`), 0 above; a, b, G (..., C, d) f32, G not
    increasing along C, C a power of two -> (..., C, C).

    By halving: each segment's second half of rows against its first half
    of columns is one product through the decay to the second half's first
    position m, ``(a_c e^(G_c - G_m)) . (b_i e^(G_m - G_i))``, whose
    exponents are never positive; then each half is a segment in turn,
    down to single positions (the diagonal, ``a_c . b_c``)."""
    *lead, c, d = a.shape
    if c & (c - 1):
        raise ValueError(f"a chunk of {c} positions is no power of two")
    out = a.new_zeros((*lead, c, c))
    if inclusive:
        torch.diagonal(out, 0, -2, -1).copy_((a * b).sum(-1))
    half = c // 2
    while half:
        n = c // (2 * half)
        a2, b2, G2 = (x.view(*lead, n, 2, half, d) for x in (a, b, G))
        ref = G2[..., 1, :1, :]                            # (..., n, 1, d)
        rows = a2[..., 1, :, :] * torch.exp(G2[..., 1, :, :] - ref)
        cols = b2[..., 0, :, :] * torch.exp(ref - G2[..., 0, :, :])
        block = out.view(*lead, n, 2, half, n, 2, half)[..., 1, :, :, 0, :]
        torch.diagonal(block, 0, -4, -2).copy_(
            (rows @ cols.transpose(-1, -2)).movedim(-3, -1))
        half //= 2
    return out


def _within_chunks(q, k, v, g, beta):
    """Each chunk's parts, on (B, H, N, C, .) f32 inputs: the state's
    carry ``S' = F S + Bc`` (F (.., dk, dk), Bc (.., dk, dv)) and the
    output ``O = Op + P S`` (P (.., C, dk), Op (.., C, dv)), S the state
    before the chunk."""
    c = q.shape[-2]
    G = g.cumsum(-2)
    Gl = G[..., -1:, :]
    eye = torch.eye(c, dtype=F32, device=q.device)
    lower = eye + _decayed(k, k, G, False) * beta[..., :, None]
    w = torch.linalg.solve_triangular(
        lower, beta[..., None] * k * torch.exp(G), upper=False,
        unitriangular=True)
    u = torch.linalg.solve_triangular(lower, beta[..., None] * v,
                                      upper=False, unitriangular=True)
    kq = _decayed(q, k, G, True)
    k_end = (k * torch.exp(Gl - G)).transpose(-1, -2)      # (.., dk, C)
    carry = torch.diag_embed(torch.exp(Gl[..., 0, :])) - k_end @ w
    return carry, k_end @ u, q * torch.exp(G) - kq @ w, kq @ u


def chunk_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, beta: torch.Tensor, chunk: int,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over a whole sequence in chunks of `chunk`
    positions: q, k, g (B, T, H, dk), v (B, T, H, dv), beta (B, T, H) f32,
    `state` (B, H, dk, dv) or zeros -> (o (B, T, H, dv), the final state).
    A ragged tail is padded with positions that neither decay nor write
    the state."""
    b, t, h, dk = k.shape
    dv = v.shape[-1]
    n = -(-t // chunk)
    pad = n * chunk - t

    def chunks(x):
        x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad)) if pad else x
        return x.view(b, n, chunk, h, -1).permute(0, 3, 1, 2, 4)

    q_, k_, v_, g_ = (chunks(x) for x in (q, k, v, g))
    beta_ = chunks(beta[..., None])[..., 0]               # (B, H, N, C)
    with span("kda.scan"):
        LAUNCHES["kda_chunks"] += n
        group = max(_GROUP // (b * h * max(chunk, dk) * dk), 1)
        parts = [_within_chunks(*(x[:, :, i:i + group]
                                  for x in (q_, k_, v_, g_, beta_)))
                 for i in range(0, n, group)]
        carry, add, p, op = (torch.cat(x, dim=2) for x in zip(*parts))
        s = (torch.zeros((b, h, dk, dv), dtype=F32, device=q.device)
             if state is None else state.to(F32))
        before = []
        for i in range(n):
            before.append(s)
            s = torch.baddbmm(add[:, :, i].reshape(b * h, dk, dv),
                              carry[:, :, i].reshape(b * h, dk, dk),
                              s.reshape(b * h, dk, dv)).view(b, h, dk, dv)
        o = op + p @ torch.stack(before, dim=2)           # (B, H, N, C, dv)
    o = o.permute(0, 2, 3, 1, 4).reshape(b, n * chunk, h, dv)[:, :t]
    return o, s


def recurrent_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, beta: torch.Tensor, state: torch.Tensor
                   ) -> torch.Tensor:
    """One token of the recurrence: q, k, g (B, H, dk), v (B, H, dv), beta
    (B, H) f32; `state` (B, H, dk, dv) f32, updated in place -> o (B, H,
    dv)."""
    state.mul_(torch.exp(g)[..., None])
    u = beta[..., None] * (v - torch.einsum("bhk,bhkv->bhv", k, state))
    state.add_(k[..., None] * u[..., None, :])
    return torch.einsum("bhk,bhkv->bhv", q, state)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------
def kda_prefill(params: Dict, x: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, Dict]:
    """A KDA layer over the normed sequence `x` (B, T, d) from a zero
    state: (y (B, T, d), the cache entry after the last position)."""
    window = torch.zeros((x.shape[0], cfg.kda.conv - 1,
                          3 * cfg.kda.n_heads * cfg.kda.head_dim),
                         dtype=x.dtype, device=x.device)
    q, k, v, g, beta, window = _inputs(params, x, cfg, window)
    o, state = chunk_scan(q, k, v, g, beta, cfg.kda.chunk)
    return _output(params, o, x, cfg), {"S": state, "conv": window}


def kda_decode(params: Dict, x: torch.Tensor, cfg, cache: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """One token x (B, 1, d) through a KDA layer: the state and the
    convolution's window of `cache` updated in place -> (y (B, 1, d),
    cache)."""
    with span("kda.step"):
        LAUNCHES["kda_steps"] += 1
        q, k, v, g, beta, window = _inputs(params, x, cfg, cache["conv"])
        cache["conv"].copy_(window)
        o = recurrent_step(q[:, 0], k[:, 0], v[:, 0], g[:, 0], beta[:, 0],
                           cache["S"])
        return _output(params, o[:, None], x, cfg), cache
