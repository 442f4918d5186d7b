"""rwkv6-1.6b [ssm]: 24L d=2048 (attention-free) ff=7168 vocab=65536.

[arXiv:2404.05892 "Finch"; unverified]. Data-dependent decay WKV6
recurrence; no KV cache => kv_tiering inapplicable (state+optimizer
tiering applies); sub-quadratic => long_500k runs.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    block_pattern=("rwkv",), rwkv_head_dim=64, rwkv_chunk=64,
    sub_quadratic=True, kv_tiering=False,
    tp_reduce_bf16=True, strategy="dp", remat_policy="dots",
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=224, vocab_size=512, rwkv_head_dim=32)
