"""A small version of the MiMo-V2-Flash serving cell that a CPU test run can
hold: every width cut, both attention kinds (a window of 8 shorter than the
prompt, so that the rings roll), the sinks, the partial rotary, the value
scale and the held share kept."""
import copy

from harness.core import Cell

SMOKE = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=1,
             head_dim=24, v_head_dim=16, swa_num_attention_heads=4,
             swa_num_key_value_heads=2, swa_head_dim=24, swa_v_head_dim=16,
             sliding_window=8, sliding_window_size=8, intermediate_size=96,
             moe_intermediate_size=32, n_routed_experts=4,
             num_experts_per_tok=4, num_hidden_layers=6, vocab_size=512)


def small_hybrid_cell(cell: Cell = None) -> Cell:
    """The MiMo-V2-Flash cell at smoke widths (16 routed experts, 4 held
    from expert 4; layers 0-5: full, 4 window, full; 8 of the 24 rotary
    dims), 3 requests of 24 + 6 in 4-token pages (2-page rings)."""
    cell = cell or Cell("mimo-v2-flash-309b.serve-4k")
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(SMOKE)
    cell.config["expert_parallel"].update(router_experts=16,
                                          first_held_expert=4)
    cell.config["weights"].update(score_bias_std=0.2, sink_mean=2.0)
    cell.traffic = dict(cell.traffic, requests=3, prefill=24, decode=6,
                        page_size=4, hbm_pages=5, warmup_decode=2,
                        check_requests=3, profile_from=1, profile_units=2)
    return cell
