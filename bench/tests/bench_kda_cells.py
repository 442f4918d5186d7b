"""A small version of the Kimi-Linear serving cell that a CPU test run can
hold: every width cut, both mixers (KDA layers 0, 1, 3, 4 and MLA layers 2,
5; chunks of 8 under a 24-token prompt, so that the state is carried
between chunks), the dense layer, the shared expert and the held share
kept.  It runs in float32: at these widths bf16's rounding alone moves the
latent rows past the cell's limits, which are set at the published
widths."""
import copy

from harness.core import Cell

SMOKE = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
             num_experts=4, num_experts_per_token=4, num_hidden_layers=6,
             vocab_size=512, kda_chunk=8)


def small_kda_cell(cell: Cell = None) -> Cell:
    """The Kimi-Linear cell at smoke widths (16 routed experts, 4 held from
    expert 4; KDA heads 2 x 16), 3 requests of 24 + 6 in 4-token pages."""
    cell = cell or Cell("kimi-linear-48b-a3b.serve-16k")
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(SMOKE, dtype="float32")
    cell.config["linear_attn_config"].update(
        num_heads=2, head_dim=16, kda_layers=[1, 2, 4, 5],
        full_attn_layers=[3, 6])
    cell.config["expert_parallel"].update(router_experts=16,
                                          first_held_expert=4)
    cell.config["weights"].update(score_bias_std=0.2)
    cell.traffic = dict(cell.traffic, requests=3, prefill=24, decode=6,
                        page_size=4, hbm_pages=5, warmup_decode=2,
                        check_requests=3, profile_from=1, profile_units=2)
    return cell
