"""qwen2-vl-2b [vlm]: 28L d=1536 12H (GQA kv=2) ff=8960 vocab=151936.

[arXiv:2409.12191; hf-verified]. M-RoPE (sections 16/24/24 over head_dim
128), dynamic-resolution vision frontend STUBBED: input_specs() supplies
precomputed patch embeddings (B, 256, 1280) that replace the leading
sequence positions. 12 heads don't divide tp=16 => sequence sharding.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    attn_kind="full", rope="mrope", rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    vision_tokens=256, vision_dim=1280,
    attn_seq_shard=True,
    tp_reduce_bf16=True, remat_policy="dots", strategy="dp",
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=512, mrope_sections=(4, 2, 2),
        vision_tokens=4, vision_dim=32, kv_chunk=32)
