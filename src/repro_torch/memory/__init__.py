"""CXL-tier memory management: planner, paged KV cache, offload schedules."""
from repro_torch.memory.tiering import (MemoryPlan, TierSpec,  # noqa: F401
                                        dynamic_tiering, kv_bytes_per_token,
                                        plan_serving, plan_training)
