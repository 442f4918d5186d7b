"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) ff=13824 vocab=100352.

[hf:stabilityai/stablelm-2-1_6b family; hf-verified]. Per-head qk-norm as in
StableLM-2-12B. Full attention => long_500k skipped (DESIGN.md §6).
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352,
    attn_kind="full", rope="rope", rope_theta=10_000.0, qk_norm=True,
    tp_reduce_bf16=True, remat_policy="dots", strategy="dp",
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=512, kv_chunk=32)
