"""musicgen-large [audio]: 48L d=2048 32H (MHA kv=32) ff=8192 vocab=2048.

[arXiv:2306.05284; hf-verified]. Decoder-only over EnCodec tokens: 4
codebooks (summed embeddings, 4 LM heads), sinusoidal positions. The
EnCodec frontend and the codebook delay pattern are data-pipeline stubs:
input_specs() supplies (B, 4, S) token ids.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    attn_kind="full", rope="none",
    n_codebooks=4, act="gelu",
    tp_reduce_bf16=True, remat_policy="dots", strategy="dp",
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=160, vocab_size=128, n_codebooks=2, kv_chunk=32)
