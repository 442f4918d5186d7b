"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4) expert-ff=1536
vocab=151936, MoE 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B family; hf-verified]. qk-norm; no shared expert.
235B total / ~22B active. fsdp=True: weights+optimizer ZeRO-3 over the
data axis (29 GiB/device unsharded would exceed v5e HBM).
"""
import dataclasses
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    block_pattern=("moe",),
    moe=MoEConfig(n_experts=128, top_k=8, n_shared=0, expert_d_ff=1536,
                  capacity_factor=1.25),
    attn_kind="full", rope="rope", rope_theta=1_000_000.0, qk_norm=True,
    fsdp=True,
    tp_reduce_bf16=True, remat_policy="dots",
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=512, kv_chunk=32,
        moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=64), fsdp=False)
