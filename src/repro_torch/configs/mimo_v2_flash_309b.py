"""mimo-v2-flash-309b [moe, hybrid attention]: 48L d=4096 64H, vocab
152576, MoE 256 routed experts top-8 (width 2048), no shared expert.

[huggingface.co/XiaomiMiMo/MiMo-V2-Flash config.json]. Two attention
kinds by ``hybrid_layer_pattern``: 9 full layers (64 query heads over 4 KV
heads, rope theta 5,000,000) and 39 sliding-window layers (a window of
128, 8 KV heads, rope theta 10,000, a learnable sink logit per head); q
and k heads 192 wide, v heads 128, the leading 64 dims rotated
(``partial_rotary_factor`` 0.334), v scaled by 0.707
(``attention_value_scale``).  Layer 0 has a dense SwiGLU FFN of 16,384;
the gate is sigmoid with a score-correction bias (``noaux_tc``), one
group, weights normalised.  The 3 MTP layers are left out (draft heads,
not on the next-token path).  Not in the JAX package: a port-only
architecture (``configs.PORT_ARCHS``).
"""
import dataclasses
from repro_torch.configs.base import HybridAttention, ModelConfig, MoEConfig

PATTERN = (0, 1, 1, 1, 1) + (0, 1, 1, 1, 1, 1) * 7 + (0,)

CONFIG = ModelConfig(
    arch="mimo-v2-flash-309b", family="moe",
    n_layers=48, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=192,
    d_ff=2048, vocab_size=152576,
    block_pattern=("moe",),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=0, expert_d_ff=2048,
                  first_dense=1, dense_d_ff=16384, scoring="sigmoid",
                  n_group=1, topk_group=1, routed_scale=1.0,
                  score_bias=True),
    rope="rope", rope_theta=5_000_000.0, v_head_dim=128, rotary_dim=64,
    value_scale=0.707,
    hybrid=HybridAttention(pattern=PATTERN, window=128, n_kv_heads=8,
                           rope_theta=10_000.0, sinks=True),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=24,
        d_ff=32, vocab_size=512, v_head_dim=16, rotary_dim=8, kv_chunk=16,
        moe=dataclasses.replace(CONFIG.moe, n_experts=8, top_k=2,
                                expert_d_ff=32, dense_d_ff=96),
        hybrid=dataclasses.replace(CONFIG.hybrid, window=8, n_kv_heads=2))
