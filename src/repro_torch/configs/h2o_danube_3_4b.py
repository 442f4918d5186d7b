"""h2o-danube-3-4b [dense]: 24L d=3840 32H (GQA kv=8) ff=10240 vocab=32000.

[arXiv:2401.16818; unverified]. Llama+Mistral mix with sliding-window
attention (window 4096) => sub-quadratic, long_500k runs with a rolling
window cache.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab_size=32000,
    attn_kind="swa", window=4096, rope="rope", rope_theta=10_000.0,
    sub_quadratic=True,
    tp_reduce_bf16=True, remat_policy="dots", strategy="dp",
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=512, window=16, kv_chunk=16)
