"""Architecture registry: --arch <id> resolves here."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "stablelm-12b": "stablelm_12b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "granite-3-8b": "granite_3_8b",
    "starcoder2-3b": "starcoder2_3b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "musicgen-large": "musicgen_large",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

#: the JAX package's registry, mirrored
ARCHS = tuple(_MODULES)

# architectures of the port alone (not in the JAX package)
_PORT_MODULES = {
    "mimo-v2-flash-309b": "mimo_v2_flash_309b",
    "kimi-linear-48b-a3b": "kimi_linear_48b_a3b",
}

#: every architecture the port builds: ARCHS, then the port's own
PORT_ARCHS = ARCHS + tuple(_PORT_MODULES)


def _mod(arch: str):
    name = _MODULES.get(arch) or _PORT_MODULES.get(arch)
    if name is None:
        raise KeyError(f"unknown arch {arch!r}; known: {PORT_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    import dataclasses
    # bf16-wire dots don't execute on the CPU backend; smoke configs run
    return dataclasses.replace(_mod(arch).smoke(), tp_reduce_bf16=False)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
