"""granite-3-8b [dense]: 40L d=4096 32H (GQA kv=8) ff=12800 vocab=49155.

[hf:ibm-granite/granite-3.0-2b-base family; hf-verified]. GQA, RoPE.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab_size=49155,
    attn_kind="full", rope="rope", rope_theta=10_000.0,
    tp_reduce_bf16=True, remat_policy="dots", strategy="dp",
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=515, kv_chunk=32)
