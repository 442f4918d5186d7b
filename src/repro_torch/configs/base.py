"""Model/architecture configuration schema.

One :class:`ModelConfig` describes every assigned architecture (DESIGN.md §6)
plus the reduced smoke variants.  `block_pattern` drives the transformer
assembly: a cycle of block kinds over the depth, e.g. ``("attn",)`` for dense
LMs, ``("rec", "rec", "attn")`` for recurrentgemma's 2:1 hybrid,
``("rwkv",)`` for RWKV6, ``("moe",)`` / ``("dense*3", "moe*rest")`` via
`first_dense` for the MoE archs.  A block kind fixes the feed-forward
(``attn``: a dense MLP, ``moe``: experts); the mixer of layer i is that of
``cfg.layer(i)`` (its ``attn_kind``), so Kimi-Linear's KDA and MLA layers
share the kinds ``attn`` and ``moe``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

BlockKind = str  # 'attn' | 'moe' | 'rwkv' | 'rec'


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention; `q_lora_rank` None: the
    query projected directly (Kimi-Linear)."""
    q_lora_rank: Optional[int] = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class YarnConfig:
    """YaRN rope scaling (DeepSeek-V3's ``rope_scaling``, type "yarn")."""
    factor: float = 40.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


@dataclasses.dataclass(frozen=True)
class HybridAttention:
    """Layers of two attention kinds (MiMo-V2-Flash's
    ``hybrid_layer_pattern``): layer i is a window layer where
    ``pattern[i]`` is 1, with this window, these KV heads, this rope theta
    and (with `sinks`) a learnable sink logit per query head; a full layer
    where it is 0, with the :class:`ModelConfig`'s own (``window``,
    ``n_kv_heads``, ``rope_theta``, ``attn_sinks``)."""
    pattern: Tuple[int, ...]
    window: int = 128
    n_kv_heads: int = 8
    rope_theta: float = 10_000.0
    sinks: bool = True


@dataclasses.dataclass(frozen=True)
class KDAConfig:
    """Kimi Delta Attention (Kimi-Linear's ``linear_attn_config``): the
    layers in `layers` (0-indexed) are gated delta-rule linear attention,
    `n_heads` heads whose keys and values are `head_dim` wide, a causal
    depthwise convolution of `conv` taps on q, k and v, the decay's and the
    output gate's low-rank projections through `head_dim`, and the
    chunkwise prefill in chunks of `chunk` positions (a power of two)."""
    layers: Tuple[int, ...]
    n_heads: int = 32
    head_dim: int = 128
    conv: int = 4
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 128           # the router's outputs
    top_k: int = 8
    n_shared: int = 0              # shared (always-on) experts
    expert_d_ff: int = 1536
    shared_d_ff: int = 0           # d_ff of the shared expert (0 => expert_d_ff)
    first_dense: int = 0           # leading dense layers (deepseek: 3)
    dense_d_ff: int = 0            # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3
    # the gate: 'softmax' | 'sigmoid' scores; the top `topk_group` of
    # `n_group` expert groups kept; the chosen weights times `routed_scale`;
    # a per-expert bias on the scores that choose (not on the weights)
    scoring: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0
    score_bias: bool = False
    # the experts this layer holds, (first, count), of an expert-parallel
    # deployment: routed over all `n_experts`, computed without drops for
    # the held ones only.  None: every expert, the capacity dispatch
    held: Optional[Tuple[int, int]] = None

    @property
    def n_held(self) -> int:
        """Experts whose weights this layer holds."""
        return self.n_experts if self.held is None else self.held[1]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                    # 'dense' | 'ssm' | 'vlm' | 'moe' | 'audio' | 'hybrid'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads

    block_pattern: Tuple[BlockKind, ...] = ("attn",)

    # attention flavour
    attn_kind: str = "full"        # 'full' | 'swa' | 'mla' | 'kda' (a KDA
                                   # layer's own, :meth:`layer`)
    window: Optional[int] = None   # SWA / local-attn window
    rope: str = "rope"             # 'rope' | 'mrope' | 'none' (sinusoidal)
                                   # | 'nope' (no positions at all)
    rope_theta: float = 10_000.0
    rope_scaling: Optional[YarnConfig] = None
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    qk_norm: bool = False
    v_head_dim: int = 0            # 0 => head_dim (GQA values' width)
    rotary_dim: int = 0            # 0 => head_dim (leading dims rotated)
    value_scale: float = 1.0       # v = value_scale * x @ Wv
    attn_sinks: bool = False       # a learnable sink logit per query head
    hybrid: Optional[HybridAttention] = None   # window and full layers

    # mixture of experts
    moe: Optional[MoEConfig] = None
    # multi-head latent attention
    mla: Optional[MLAConfig] = None
    # gated delta-rule linear attention in some layers (Kimi-Linear)
    kda: Optional[KDAConfig] = None

    # rwkv6 / rg-lru
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 0            # 0 = step scan; >0 = chunk-parallel WKV
    lru_width: int = 0             # 0 => d_model
    conv_width: int = 4

    # embeddings / heads
    n_codebooks: int = 1           # musicgen: 4
    tie_embeddings: bool = False
    vision_tokens: int = 0         # qwen2-vl stub frontend tokens
    vision_dim: int = 0

    act: str = "silu"
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # distribution
    fsdp: bool = False             # ZeRO-3 weight sharding over the data axis
    attn_seq_shard: bool = False   # shard q-seq (not heads) over model axis
    kv_chunk: int = 1024           # blockwise-attention KV chunk
    strategy: str = "tp"           # 'tp' | 'dp' (pure DP + ZeRO-3)
    remat_policy: str = "none"     # 'none' (full remat) | 'dots' (save dots)
    tp_reduce_bf16: bool = False   # bf16 wire on TP-boundary all-reduces
                                   # (lowering-only on CPU: smoke configs
                                   # keep False, see configs.get_smoke)

    # serving
    sub_quadratic: bool = False    # eligible for long_500k
    kv_tiering: bool = True        # CXL KV-cache tiering applicable

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # ---- derived -----------------------------------------------------------
    @property
    def v_dim(self) -> int:
        """Width of a GQA value head."""
        return self.v_head_dim or self.head_dim

    @property
    def rot_dim(self) -> int:
        """Leading dims of a GQA q or k head that RoPE rotates."""
        return self.rotary_dim or self.head_dim

    def is_window_layer(self, i: int) -> bool:
        """Whether layer `i` is a window layer of a hybrid model."""
        return self.hybrid is not None and self.hybrid.pattern[i] == 1

    def is_kda_layer(self, i: int) -> bool:
        """Whether layer `i` is a KDA layer."""
        return self.kda is not None and i in self.kda.layers

    def layer(self, i: int) -> "ModelConfig":
        """Layer `i`'s configuration: a hybrid model's window layer with
        its window, KV heads, rope theta and sinks put in (and no
        ``hybrid``); a KDA layer with ``attn_kind`` "kda"; every other
        layer's is this one."""
        if self.is_window_layer(i) or self.is_kda_layer(i):
            return _layer_config(self, i)
        return self

    def layer_kinds(self) -> Tuple[BlockKind, ...]:
        """Expand block_pattern over depth (+ first_dense override for MoE)."""
        kinds = []
        for i in range(self.n_layers):
            k = self.block_pattern[i % len(self.block_pattern)]
            if (k == "moe" and self.moe is not None
                    and i < self.moe.first_dense):
                k = "attn"
            kinds.append(k)
        return tuple(kinds)

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        total = v * d * self.n_codebooks            # embed
        if not self.tie_embeddings:
            total += d * v * self.n_codebooks       # head(s)
        for i, k in enumerate(self.layer_kinds()):
            lc = self.layer(i)
            n_q = lc.n_heads * hd
            n_kv = lc.n_kv_heads * hd
            if k in ("attn", "moe"):
                if lc.attn_kind == "kda":
                    a = self.kda
                    w = a.n_heads * a.head_dim
                    total += (d * 3 * w + a.conv * 3 * w + d * a.n_heads
                              + 2 * (d * a.head_dim + a.head_dim * w)
                              + w * d + a.n_heads + w + a.head_dim)
                elif self.attn_kind == "mla" and self.mla:
                    m = self.mla
                    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                    q = (d * self.n_heads * qk if m.q_lora_rank is None
                         else d * m.q_lora_rank
                         + m.q_lora_rank * self.n_heads * qk)
                    total += (q
                              + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                              + m.kv_lora_rank * self.n_heads *
                              (m.qk_nope_head_dim + m.v_head_dim)
                              + self.n_heads * m.v_head_dim * d)
                else:
                    n_v = lc.n_kv_heads * lc.v_dim
                    total += (d * (n_q + n_kv + n_v) + lc.n_heads * lc.v_dim
                              * d + lc.n_heads * lc.attn_sinks)
            if k == "attn":
                ff = (self.moe.dense_d_ff if self.moe and self.moe.dense_d_ff
                      else f)
                total += 3 * d * ff
            elif k == "moe":
                if not self.moe:
                    raise ValueError(
                        "block kind 'moe' requires a MoE config")
                total += d * self.moe.n_experts     # router
                total += self.moe.n_held * 3 * d * self.moe.expert_d_ff
                sh = self.moe.shared_d_ff or self.moe.expert_d_ff
                total += self.moe.n_shared * 3 * d * sh
            elif k == "rwkv":
                # time-mix (r,k,v,w,g,o) + channel-mix (~3.5 d^2) + loras
                total += 6 * d * d + 3.5 * d * d
            elif k == "rec":
                w = self.lru_width
                total += 2 * d * w + w * d + self.conv_width * w + 3 * w
                total += 3 * d * f
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        m = self.moe
        full = self.n_params()
        n_moe_layers = sum(1 for k in self.layer_kinds() if k == "moe")
        inactive = n_moe_layers * (m.n_experts - m.top_k) * 3 * d * m.expert_d_ff
        return int(full - inactive)


@functools.lru_cache(maxsize=None)
def _layer_config(cfg: ModelConfig, i: int) -> ModelConfig:
    if cfg.is_kda_layer(i):
        return dataclasses.replace(cfg, attn_kind="kda")
    h = cfg.hybrid
    return dataclasses.replace(cfg, window=h.window, n_kv_heads=h.n_kv_heads,
                               rope_theta=h.rope_theta, attn_sinks=h.sinks,
                               hybrid=None)
