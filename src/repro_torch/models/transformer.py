"""Transformer assembly: segments of repeating block patterns.

Depth is organised into **segments**, maximal runs where a block pattern
repeats, as in the JAX package (``dense LMs: [('attn',) x L]``).  The
reference stacks each segment's parameters along a leading period axis
for ``lax.scan``; the port keeps one dict per period instead and loops:

    params["segments"][seg][period]["b0"]["attn"]["wqkv"]

so every leaf keeps the reference's name (``wqkv``, ``wo``, ``wiu``,
``ln1``, ...) and maps one to one (:func:`repro_torch.convert.
model_params` unstacks the period axis).  Caches follow the same layout,
``caches[seg][period]["b0"]``, one entry per block kind:

    attn / moe, GQA:  {"k", "v": (B, S, K, hd)}
    attn / moe, MLA:  {"ckv": (B, S, r), "krope": (B, S, rope)}
    attn / moe, KDA:  {"S": (B, H, dk, dv) f32, "conv": (B, conv - 1, 3 H dk)}
    rwkv:             {"tm_shift", "cm_shift": (B, d), "S": (B, H, hd, hd)}
    rec:              {"h": (B, W) f32, "conv": (B, cw - 1, W)}

Three assembly paths share the block implementations, as in the
reference: :func:`forward_train` (no cache; each period recomputed in the
backward pass), :func:`forward_prefill` (emits the caches) and
:func:`decode_step`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt_mod

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import kda as kda_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (ShapeOnly, dense_init, embed,
                                       embed_init, head_init, lm_head, mlp,
                                       mlp_init, pdtype, rmsnorm,
                                       rmsnorm_init, sinusoidal_positions)
from repro_torch.models.rope import text_mrope_positions
from repro_torch.models.sharding import BATCH, MODEL, shard
from repro_torch.runtime.trace import cut_at_spans, span

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: Tuple[str, ...]
    n_periods: int


def segments(cfg) -> List[Segment]:
    kinds = cfg.layer_kinds()
    segs: List[Segment] = []
    if len(set(kinds)) == 1:
        return [Segment((kinds[0],), len(kinds))]
    # split off a leading run of a different kind (deepseek first_dense)
    j = 0
    while j < len(kinds) and kinds[j] == kinds[0]:
        j += 1
    rest = kinds[j:]
    if len(set(rest)) == 1:
        segs.append(Segment((kinds[0],), j))
        segs.append(Segment((rest[0],), len(rest)))
        return segs
    # periodic pattern (recurrentgemma)
    pat = tuple(cfg.block_pattern)
    plen = len(pat)
    n_full = len(kinds) // plen
    for idx, k in enumerate(kinds[:n_full * plen]):
        if k != pat[idx % plen]:
            raise ValueError(f"layer kinds do not follow pattern at {idx}")
    segs.append(Segment(pat, n_full))
    rem = kinds[n_full * plen:]
    if rem:
        segs.append(Segment(tuple(rem), 1))
    return segs


def layer_ids(cfg) -> List[List[List[int]]]:
    """Each block's layer index, laid out as the segments are:
    ``[seg][period][b]``; a layer's configuration is ``cfg.layer(i)``."""
    out, i = [], 0
    for seg in segments(cfg):
        n = len(seg.pattern)
        out.append([list(range(i + p * n, i + (p + 1) * n))
                    for p in range(seg.n_periods)])
        i += seg.n_periods * n
    return out


def layer_entry(tree: List, cfg, i: int) -> Dict:
    """Layer `i`'s entry of a tree laid out as the segments (the params'
    ``"segments"`` or the caches): its block's parameters or cache."""
    for seg, seg_ids in zip(tree, layer_ids(cfg)):
        for period, ids in zip(seg, seg_ids):
            if i in ids:
                return period[f"b{ids.index(i)}"]
    raise IndexError(f"{cfg.arch} has no layer {i}")


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------
def _dense_ff(cfg) -> int:
    if cfg.moe is not None and cfg.moe.dense_d_ff:
        return cfg.moe.dense_d_ff
    return cfg.d_ff


def _attn_init(gen: torch.Generator, cfg) -> Dict:
    if cfg.attn_kind == "mla":
        return attn_mod.mla_init(gen, cfg)
    return attn_mod.attn_init(gen, cfg)


def block_init(gen: torch.Generator, kind: str, cfg) -> Dict:
    """One block's parameters: ``ln1``, its mixer (``attn``, ``kda``, ``tm``
    or ``rec``), ``ln2`` and its feed-forward (``mlp``, ``moe`` or
    ``cm``)."""
    d = cfg.d_model
    if kind in ("attn", "moe"):
        mixer = (("kda", kda_mod.kda_init(gen, cfg))
                 if cfg.attn_kind == "kda" else ("attn", _attn_init(gen, cfg)))
        ffn = (("moe", moe_mod.moe_init(gen, cfg)) if kind == "moe" else
               ("mlp", mlp_init(gen, d, _dense_ff(cfg), dtype=pdtype(cfg))))
    elif kind == "rwkv":
        mixer = "tm", rwkv_mod.timemix_init(gen, cfg)
        ffn = "cm", rwkv_mod.channelmix_init(gen, cfg)
    elif kind == "rec":
        mixer = "rec", rglru_mod.rglru_init(gen, cfg)
        ffn = "mlp", mlp_init(gen, d, cfg.d_ff, dtype=pdtype(cfg))
    else:
        raise ValueError(kind)
    return {"ln1": rmsnorm_init(d, gen.device), mixer[0]: mixer[1],
            "ln2": rmsnorm_init(d, gen.device), ffn[0]: ffn[1]}


def _ffn(kind: str, p: Dict, h: torch.Tensor, cfg, decode: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The feed-forward half of an attention or rec block: (y, MoE aux
    loss or 0); `decode` for a decode step's tokens."""
    if kind == "moe":
        return moe_mod.moe_ffn(p["moe"], h, cfg, decode=decode)
    return (mlp(p["mlp"], h, cfg.act, reduce_bf16=cfg.tp_reduce_bf16),
            torch.zeros((), dtype=F32, device=h.device))


def _attn_seq(p: Dict, h: torch.Tensor, cfg, positions, want_cache: bool
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The attention (or KDA) half over a sequence: (y, cache entry or
    None)."""
    if cfg.attn_kind == "kda":
        y, cache = kda_mod.kda_prefill(p["kda"], h, cfg)
        return y, (cache if want_cache else None)
    if cfg.attn_kind == "mla":
        if want_cache:
            return attn_mod.mla_prefill(p["attn"], h, cfg, positions)
        return attn_mod.mla_attention(p["attn"], h, cfg, positions), None
    if want_cache:
        return attn_mod.attention_prefill(p["attn"], h, cfg, positions,
                                          seq_shard=cfg.attn_seq_shard)
    return attn_mod.attention(p["attn"], h, cfg, positions,
                              seq_shard=cfg.attn_seq_shard), None


def _rwkv_block(p: Dict, x: torch.Tensor, cfg, state: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """An rwkv block (time-mix, channel-mix) from `state`: (x, new state)."""
    eps = cfg.norm_eps
    y, tm_shift, S = rwkv_mod.timemix(p["tm"], rmsnorm(p["ln1"], x, eps),
                                      state["tm_shift"], state["S"], cfg)
    x = x + y
    y, cm_shift = rwkv_mod.channelmix(p["cm"], rmsnorm(p["ln2"], x, eps),
                                      state["cm_shift"])
    return x + y, {"tm_shift": tm_shift, "cm_shift": cm_shift, "S": S}


def _block_seq(kind: str, p: Dict, x: torch.Tensor, cfg, positions,
               want_cache: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Sequence-form block (train/prefill); a recurrent block starts from a
    zero state.  Returns (x, aux, cache entry or None)."""
    if kind == "rwkv":
        x, cache = _rwkv_block(p, x, cfg, rwkv_mod.rwkv_state_init(
            cfg, x.shape[0], x.device))
        return (x, torch.zeros((), dtype=F32, device=x.device),
                cache if want_cache else None)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        y, cache = rglru_mod.recurrent_block(
            p["rec"], h, rglru_mod.rglru_state_init(cfg, x.shape[0],
                                                    x.device), cfg)
        cache = cache if want_cache else None
    else:
        y, cache = _attn_seq(p, h, cfg, positions, want_cache)
    x = x + y
    y, aux = _ffn(kind, p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x + y, aux, cache


def _block_decode(kind: str, p: Dict, x: torch.Tensor, cfg, cache: Dict,
                  ctx_len) -> Tuple[torch.Tensor, Dict]:
    if kind == "rwkv":
        return _rwkv_block(p, x, cfg, cache)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "rec":
        y, cache = rglru_mod.recurrent_block_step(p["rec"], h, cache, cfg)
    elif cfg.attn_kind == "kda":
        y, cache = kda_mod.kda_decode(p["kda"], h, cfg, cache)
    elif cfg.attn_kind == "mla":
        y, cache = attn_mod.mla_decode(p["attn"], h, cfg, cache, ctx_len)
    else:
        y, cache = attn_mod.attention_decode(p["attn"], h, cfg, cache,
                                             ctx_len)
    x = x + y
    y, _ = _ffn(kind, p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg,
                decode=True)
    return x + y, cache


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------
def init_params(cfg, generator: Optional[torch.Generator] = None,
                device=None) -> Dict:
    """Random parameters for `cfg` on `device` (default: the CUDA card).

    `generator` (a ``torch.Generator`` on `device`) seeds every draw; a
    fresh one seeded 0 when omitted.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator lies on {generator.device}, the "
                         f"parameters on {dev}")
    return _param_tree(cfg, generator, dev)


def param_shapes(cfg) -> Dict:
    """The tree of :func:`init_params` with meta tensors for leaves: each
    leaf's shape and dtype, without allocating or drawing (the dry run's
    stand-ins; a full-width deepseek-v3-671b takes a moment)."""
    gen = ShapeOnly()
    return _param_tree(cfg, gen, gen.device)


def _param_tree(cfg, gen, dev) -> Dict:
    """The parameter tree's layout, its leaves drawn from `gen` (a
    ``torch.Generator``) or laid out on the meta device (a
    :class:`~repro_torch.models.layers.ShapeOnly`)."""
    segs = segments(cfg)
    dt = pdtype(cfg)
    params: Dict = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                            cfg.n_codebooks, dtype=dt),
        "final_norm": rmsnorm_init(cfg.d_model, dev),
        "segments": [],
    }
    if not cfg.tie_embeddings:
        params["head"] = head_init(gen, cfg.d_model, cfg.vocab_size,
                                   cfg.n_codebooks, dtype=dt)
    if cfg.vision_tokens:
        params["vision_proj"] = dense_init(gen, (cfg.vision_dim, cfg.d_model),
                                           dtype=dt)
    for seg, seg_ids in zip(segs, layer_ids(cfg)):
        params["segments"].append([
            {f"b{j}": block_init(gen, kind, cfg.layer(i))
             for j, (kind, i) in enumerate(zip(seg.pattern, ids))}
            for ids in seg_ids])
    return params


def n_param_elements(params: Dict) -> int:
    """Number of parameter elements in a tree of dicts and lists."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    items = params.values() if isinstance(params, dict) else params
    return sum(n_param_elements(v) for v in items)


# ---------------------------------------------------------------------------
# Embedding & positions
# ---------------------------------------------------------------------------
def _embed_inputs(params: Dict, cfg, tokens: torch.Tensor,
                  vision: Optional[torch.Tensor], offset=0) -> torch.Tensor:
    x = embed(params["embed"], tokens)
    if cfg.rope == "none":
        s = x.shape[-2]
        x = x + sinusoidal_positions(s, cfg.d_model, offset,
                                     x.device).to(x.dtype)[None]
    if cfg.vision_tokens and vision is not None:
        vproj = vision.to(x.dtype) @ params["vision_proj"]
        x = torch.cat([vproj, x[:, cfg.vision_tokens:]], dim=1)
    return shard(x, BATCH, None, None)


def _positions(cfg, batch: int, seq: int,
               positions: Optional[torch.Tensor], device) -> torch.Tensor:
    if positions is not None:
        return positions
    if cfg.rope == "mrope":
        return text_mrope_positions(batch, seq, device=device)
    return torch.arange(seq, dtype=torch.int32,
                        device=device).expand(batch, seq)


def _prefill_inputs(params: Dict, cfg, tokens: torch.Tensor,
                    positions: Optional[torch.Tensor],
                    vision: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefill's embedded tokens (B, S, d) and their positions."""
    x = _embed_inputs(params, cfg, tokens, vision)
    return x, _positions(cfg, x.shape[0], tokens.shape[-1], positions,
                         x.device)


def prefill_layer0_qkv(params: Dict, cfg, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Layer 0's q (B, S, H, D), k and v (B, S, K, D) on `tokens`, with
    positions applied, as :func:`forward_prefill` hands them to its first
    attention; layer 0 must be a GQA attention block."""
    if segments(cfg)[0].pattern[0] not in ("attn", "moe") \
            or cfg.attn_kind == "mla":
        raise ValueError(f"layer 0 of {cfg.arch} is not a GQA attention "
                         f"block")
    x, pos = _prefill_inputs(params, cfg, tokens, None, None)
    p = params["segments"][0][0]["b0"]
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    return attn_mod.projected_qkv(p["attn"], h, cfg.layer(0), pos,
                                  cfg.attn_seq_shard)


def _head(params: Dict, cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        table = params["embed"]["table"].to(x.dtype)
        return shard(torch.matmul(x, table.t()), BATCH, None, MODEL)
    return lm_head(params["head"], x)


# ---------------------------------------------------------------------------
# Forward paths
# ---------------------------------------------------------------------------
# ops whose outputs remat_policy "dots" keeps, as jax.checkpoint_policies.
# dots_saveable keeps every dot_general's
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default))


def _dots_saveable(ctx, op, *args, **kwargs):
    return (ckpt_mod.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt_mod.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context():
    return ckpt_mod.create_selective_checkpoint_contexts(_dots_saveable)


def forward_train(params: Dict, cfg, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  vision: Optional[torch.Tensor] = None,
                  remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux_loss).

    With `remat` and autograd on, each period runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass; with
    ``cfg.remat_policy == "dots"`` the matrix products' outputs are kept
    and only the rest is recomputed.  Values are the same either way."""
    x, pos = _prefill_inputs(params, cfg, tokens, positions, vision)
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    for seg, seg_params, seg_ids in zip(segments(cfg), params["segments"],
                                        layer_ids(cfg)):
        def body(x, aux, pp, ids, seg=seg):
            for j, kind in enumerate(seg.pattern):
                x, a, _ = _block_seq(kind, pp[f"b{j}"], x, cfg.layer(ids[j]),
                                     pos, False)
                aux = aux + a
            return x, aux
        for pp, ids in zip(seg_params, seg_ids):
            if remat and torch.is_grad_enabled():
                kw = ({"context_fn": _remat_context}
                      if cfg.remat_policy == "dots" else {})
                x, aux_total = ckpt_mod.checkpoint(
                    body, x, aux_total, pp, ids, use_reentrant=False, **kw)
            else:
                x, aux_total = body(x, aux_total, pp, ids)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, cfg, x), aux_total


def pad_cache(caches: List, cfg, target_len: int) -> List:
    """Right-pad attention caches (k/v/ckv/krope, sequence dim 1) to
    `target_len` capacity for the decode that follows; rolling SWA k/v
    caches (each layer's own window) stay window-sized, the MLA latent is
    never windowed.  The recurrent states pass through.  Returns new
    caches."""
    def pad(name, leaf, lcfg):
        if name not in ("k", "v", "ckv", "krope"):
            return leaf
        tgt = target_len
        if name in ("k", "v") and lcfg.window:
            tgt = min(tgt, lcfg.window)
        s = leaf.shape[1]
        if s >= tgt:
            return leaf
        width = [0, 0] * (leaf.ndim - 2) + [0, tgt - s]
        return torch.nn.functional.pad(leaf, width)

    return [[{b: {name: pad(name, leaf, cfg.layer(ids[int(b[1:])]))
                  for name, leaf in entry.items()}
              for b, entry in period.items()}
             for period, ids in zip(seg, seg_ids)]
            for seg, seg_ids in zip(caches, layer_ids(cfg))]


def forward_prefill(params: Dict, cfg, tokens: torch.Tensor,
                    positions: Optional[torch.Tensor] = None,
                    vision: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, List]:
    """Returns (last-token logits (B, 1, V), caches[seg][period])."""
    x, pos = _prefill_inputs(params, cfg, tokens, positions, vision)
    caches: List = []
    for seg, seg_params, seg_ids in zip(segments(cfg), params["segments"],
                                        layer_ids(cfg)):
        seg_cache = []
        for pp, ids in zip(seg_params, seg_ids):
            entry = {}
            for j, kind in enumerate(seg.pattern):
                x, _, entry[f"b{j}"] = _block_seq(kind, pp[f"b{j}"], x,
                                                  cfg.layer(ids[j]), pos,
                                                  True)
            seg_cache.append(entry)
        caches.append(seg_cache)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, cfg, x[:, -1:]), caches


def decode_step(params: Dict, cfg, token: torch.Tensor, caches: List,
                ctx_len, positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List]:
    """One decode step. token (B,) or (B, C); `ctx_len` the tokens already
    cached, an int or a 0-d integer tensor on the device -> (logits
    (B, 1, ...), caches), the caches updated in place.  `positions` is
    accepted and unused, as in the reference: positions follow from
    `ctx_len`.

    When `caches` is a :class:`StepGraph` built for these `params` and
    `cfg`, the step runs through it: replayed from its CUDA graph once
    captured, the logits a fresh tensor either way; eagerly otherwise."""
    if isinstance(caches, StepGraph) and caches.takes(params, cfg, token):
        return caches.step(token, ctx_len), caches
    return _decode(params, cfg, token, caches,
                   attn_mod.context_length(ctx_len, token.device))


def _decode(params: Dict, cfg, token: torch.Tensor, caches: List,
            ctx_len: torch.Tensor) -> Tuple[torch.Tensor, List]:
    tok = token[:, None] if token.ndim == 1 else token[..., None]
    x = _embed_inputs(params, cfg, tok, None, offset=ctx_len)
    for seg, seg_params, seg_cache, seg_ids in zip(
            segments(cfg), params["segments"], caches, layer_ids(cfg)):
        for pp, entry, ids in zip(seg_params, seg_cache, seg_ids):
            for j, kind in enumerate(seg.pattern):
                x, entry[f"b{j}"] = _block_decode(
                    kind, pp[f"b{j}"], x, cfg.layer(ids[j]), entry[f"b{j}"],
                    ctx_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, cfg, x), caches


def graphable(cfg, device) -> bool:
    """Whether :func:`decode_step` of `cfg` on `device` can be captured as
    CUDA graphs: a CUDA device, every block attention or KDA (GQA, MLA or
    KDA, whose decode reads nothing back to the host and updates its cache
    in place) with a dense MLP or an MoE FFN (whose decode has static
    shapes), and RoPE, M-RoPE or no positions."""
    return (torch.device(device).type == "cuda"
            and cfg.rope in ("rope", "mrope", "nope")
            and all(kind in ("attn", "moe") for seg in segments(cfg)
                    for kind in seg.pattern))


def _opens_spans(cfg) -> bool:
    """Whether a decode step opens spans: an MoE FFN or a KDA layer."""
    return cfg.kda is not None or any(
        kind == "moe" for seg in segments(cfg) for kind in seg.pattern)


class _Pieces:
    """A decode step captured as CUDA graphs in one memory pool, cut at the
    spans it opens (a held MoE layer's ``moe.route`` and ``moe.experts``, a
    KDA layer's ``kda.step``):
    :meth:`replay` replays the graphs in turn, each span's inside its span,
    so that a profiler sees the spans of a replayed step."""

    def __init__(self):
        self.graphs: List[Tuple] = []       # (graph, (name, id) or None)
        self.pool = torch.cuda.graph_pool_handle()

    def begin(self, label=None) -> None:
        self.graphs.append((torch.cuda.CUDAGraph(), label))
        self.graphs[-1][0].capture_begin(pool=self.pool)

    def end(self) -> None:
        with warnings.catch_warnings():
            # two spans back to back leave an empty graph between them
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            self.graphs[-1][0].capture_end()

    @contextlib.contextmanager
    def span(self, name: str, id: Optional[int] = None):
        self.end()
        self.begin((name, id))
        try:
            yield
        finally:
            self.end()
            self.begin()

    def replay(self) -> None:
        for graph, label in self.graphs:
            if label is None:
                graph.replay()
            else:
                with span(*label):
                    graph.replay()


class StepGraph(list):
    """One sequence's caches, the list of segments :func:`decode_step`
    takes, with that step captured as a CUDA graph.

    The first step through it runs eagerly on its static inputs (the
    token and the context length as a 0-d device tensor), which warms up
    what the capture records; :meth:`capture` then records the step on
    those inputs, and every later step copies its token and length in,
    replays the graph and returns a clone of the graph's logits.  A step
    with MoE FFNs or KDA layers is captured as :class:`_Pieces`, cut at
    the spans of its held MoE and its KDA layers.  The caches are updated
    in place, as by the eager step, so the list's tensors stay the ones
    the graph reads and writes;
    ``params`` and ``cfg`` are those the graph was made for (a call with
    others runs eagerly).  ``replayed`` counts the replays.
    """

    def __init__(self, caches: List, params: Dict, cfg):
        super().__init__(caches)
        self.params, self.cfg = params, cfg
        self.token: Optional[torch.Tensor] = None
        self.ctx: Optional[torch.Tensor] = None
        self.graph = None           # a torch.cuda.CUDAGraph or _Pieces
        self.logits: Optional[torch.Tensor] = None
        self.replayed = 0

    def takes(self, params: Dict, cfg, token: torch.Tensor) -> bool:
        """Whether a step of `params`, `cfg` on `token` is this graph's."""
        return (params is self.params and cfg is self.cfg
                and (self.token is None
                     or (token.shape == self.token.shape
                         and token.dtype == self.token.dtype)))

    def step(self, token: torch.Tensor, ctx_len) -> torch.Tensor:
        """One step at `ctx_len` on `token`: its logits."""
        if self.token is None:
            self.token = torch.empty_like(token)
            self.ctx = torch.zeros((), dtype=torch.int64, device=token.device)
        self.token.copy_(token)
        self.ctx.fill_(ctx_len)
        if self.graph is None:
            return self._run()
        self.graph.replay()
        self.replayed += 1
        return self.logits.clone()

    @property
    def warm(self) -> bool:
        """Whether a step has run, so that the graph can be captured."""
        return self.token is not None

    def capture(self) -> None:
        """Record the step on the static inputs; nothing runs."""
        if _opens_spans(self.cfg):
            self.graph = self._capture_pieces()
            return
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.logits = self._run()
        self.graph = graph

    def _capture_pieces(self) -> _Pieces:
        torch.cuda.synchronize()
        pieces = _Pieces()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), cut_at_spans(pieces.span):
            pieces.begin()
            try:
                logits = self._run()
            finally:
                pieces.end()
        torch.cuda.current_stream().wait_stream(stream)
        self.logits = logits
        return pieces

    def _run(self) -> torch.Tensor:
        return _decode(self.params, self.cfg, self.token, self, self.ctx)[0]


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, s_cache: int, device=None) -> List:
    """Empty caches shaped like :func:`decode_step` expects."""
    dev = resolve_device(device)
    dt = pdtype(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def entry(kind: str, lc) -> Dict:
        if kind in ("attn", "moe"):
            if lc.attn_kind == "kda":
                return kda_mod.kda_state_init(lc, batch, dev)
            if lc.attn_kind == "mla":
                m = lc.mla
                return {"ckv": zeros(batch, s_cache, m.kv_lora_rank),
                        "krope": zeros(batch, s_cache, m.qk_rope_head_dim)}
            s = min(lc.window, s_cache) if lc.window else s_cache
            return {"k": zeros(batch, s, lc.n_kv_heads, lc.head_dim),
                    "v": zeros(batch, s, lc.n_kv_heads, lc.v_dim)}
        if kind == "rwkv":
            return rwkv_mod.rwkv_state_init(lc, batch, dev)
        if kind == "rec":
            return rglru_mod.rglru_state_init(lc, batch, dev)
        raise ValueError(kind)

    return [[{f"b{j}": entry(kind, cfg.layer(i))
              for j, (kind, i) in enumerate(zip(seg.pattern, ids))}
             for ids in seg_ids]
            for seg, seg_ids in zip(segments(cfg), layer_ids(cfg))]
