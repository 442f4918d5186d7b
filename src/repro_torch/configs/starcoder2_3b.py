"""starcoder2-3b [dense]: 30L d=3072 24H (GQA kv=2) ff=12288 vocab=49152.

[arXiv:2402.19173; hf-verified]. GQA, RoPE. 24 heads don't divide the
16-way model axis => query-sequence sharding strategy (DESIGN.md §4).
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    attn_kind="full", rope="rope", rope_theta=100_000.0,
    attn_seq_shard=True,
    tp_reduce_bf16=True, remat_policy="dots", strategy="dp",
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=60, n_heads=6, n_kv_heads=2, head_dim=10,
        d_ff=128, vocab_size=512, kv_chunk=32)
