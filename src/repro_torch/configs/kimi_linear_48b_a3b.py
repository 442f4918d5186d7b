"""kimi-linear-48b-a3b [moe, linear attention]: 27L d=2304, vocab 163840,
MoE 256 routed experts top-8 (width 1024) + 1 shared.

[huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct config.json].
Two mixers by ``linear_attn_config``: 20 Kimi Delta Attention layers
(``kda_layers``, 1-indexed; 0-indexed 0-2, 4-6, ..., 24-25: gated
delta-rule linear attention, 32 heads of 128, a short convolution of 4, a
decay per key channel) and 7 MLA layers (``full_attn_layers`` 3, 7, ...,
23, 26: kv_lora 512, nope 128, rope 64, v 128, the query projected
directly, ``q_lora_rank`` null).  ``mla_use_nope``: no rotary anywhere in
the model, nor any other position signal.  Layer 0 has a dense SwiGLU FFN
of 9,216; the gate is sigmoid with a score-correction bias, one group, the
top 8 renormalised and scaled by 2.446.  Not in the JAX package: a
port-only architecture (``configs.PORT_ARCHS``).
"""
import dataclasses
from repro_torch.configs.base import (KDAConfig, MLAConfig, ModelConfig,
                                      MoEConfig)

#: ``linear_attn_config.full_attn_layers`` (1-indexed), 0-indexed
MLA_LAYERS = (3, 7, 11, 15, 19, 23, 26)

CONFIG = ModelConfig(
    arch="kimi-linear-48b-a3b", family="moe",
    n_layers=27, d_model=2304, n_heads=32, n_kv_heads=32, head_dim=192,
    d_ff=1024, vocab_size=163840,
    block_pattern=("moe",),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, expert_d_ff=1024,
                  shared_d_ff=1024, first_dense=1, dense_d_ff=9216,
                  scoring="sigmoid", n_group=1, topk_group=1,
                  routed_scale=2.446, score_bias=True),
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    kda=KDAConfig(layers=tuple(i for i in range(27) if i not in MLA_LAYERS),
                  n_heads=32, head_dim=128, conv=4, chunk=64),
    rope="nope",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=32, vocab_size=512, kv_chunk=16,
        moe=dataclasses.replace(CONFIG.moe, n_experts=8, top_k=2,
                                expert_d_ff=32, shared_d_ff=32,
                                dense_d_ff=96),
        mla=MLAConfig(q_lora_rank=None, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        kda=KDAConfig(layers=(0, 1, 3), n_heads=2, head_dim=16, conv=4,
                      chunk=8))
