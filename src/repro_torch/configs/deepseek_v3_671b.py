"""deepseek-v3-671b [moe]: 61L d=7168 128H MLA, expert-ff=2048,
vocab=129280, MoE 1 shared + 256 routed top-8.

[arXiv:2412.19437; hf-verified]. MLA (q_lora 1536, kv_lora 512, nope 128,
rope 64, v 128); first 3 layers dense (ff 18432); decode uses the absorbed
latent formulation over the 9x-smaller {ckv,krope} cache. MTP head omitted
(training-objective add-on; noted in DESIGN.md). fsdp=True — and even then
optimizer state exceeds single-pod HBM: the paper-representative CXL
offload cell (EXPERIMENTS.md §Dry-run).
"""
import dataclasses
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=2048, vocab_size=129280,
    block_pattern=("moe",),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, expert_d_ff=2048,
                  shared_d_ff=2048, first_dense=3, dense_d_ff=18432,
                  capacity_factor=1.25),
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    rope="rope", rope_theta=10_000.0,
    fsdp=True,
    tp_reduce_bf16=True, remat_policy="dots",
)

def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=64, vocab_size=512, kv_chunk=32,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, expert_d_ff=64,
                      shared_d_ff=64, first_dense=1, dense_d_ff=128),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        fsdp=False)
