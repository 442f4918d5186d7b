"""CXL-tier memory management: planner, paged KV cache, offload schedules."""
from repro_torch.memory.tiering import (TPU_V5E, MemoryPlan,  # noqa: F401
                                        TierSpec,
                                        dynamic_tiering, kv_bytes_per_token,
                                        plan_serving, plan_training)
