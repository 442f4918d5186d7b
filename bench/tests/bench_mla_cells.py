"""A small version of the DeepSeek-V3 serving cell that a CPU test run can
hold: every width cut, the gate's groups, YaRN and the held share kept."""
import copy

from harness.core import Cell

SMOKE = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, intermediate_size=96,
             moe_intermediate_size=32, n_routed_experts=4,
             num_experts_per_tok=4, n_group=4, topk_group=2,
             num_hidden_layers=3, first_k_dense_replace=1, vocab_size=512)


def small_mla_moe_cell(cell: Cell = None) -> Cell:
    """The DeepSeek-V3 cell at smoke widths (16 routed experts in 4 groups,
    4 held from expert 4), 3 requests of 24 + 6."""
    cell = cell or Cell("deepseek-v3-671b.serve-spill")
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(SMOKE)
    cell.config["expert_parallel"].update(router_experts=16,
                                          first_held_expert=4)
    cell.config["weights"]["score_bias_std"] = 0.2
    cell.traffic = dict(cell.traffic, requests=3, prefill=24, decode=6,
                        page_size=4, hbm_pages=5, warmup_decode=2,
                        check_requests=3, profile_from=1, profile_units=2)
    return cell
