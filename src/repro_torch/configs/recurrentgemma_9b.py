"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (local-MQA kv=1) ff=12288
vocab=256000. RG-LRU + local attention, 2 recurrent : 1 attention.

[arXiv:2402.19427 Griffin; unverified]. Pattern (rec, rec, attn) x 12 +
(rec, rec); local attention window 2048; RG-LRU width 4096 with width-4
causal conv. Sub-quadratic => long_500k runs.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rec", "rec", "attn"),
    attn_kind="swa", window=2048, rope="rope", rope_theta=10_000.0,
    lru_width=4096, conv_width=4,
    sub_quadratic=True, act="gelu",
    tp_reduce_bf16=True, remat_policy="dots", strategy="dp",
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=160, vocab_size=512, window=16, lru_width=64, kv_chunk=16)
