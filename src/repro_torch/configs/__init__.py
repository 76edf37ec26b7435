"""The paper's experiment settings and the ten model configs.

The dense (llama3.2-3b, deepseek-67b, internlm2-20b, starcoder2-15b), ssm
(mamba2-130m), moe (granite-moe-1b-a400m, mixtral-8x22b), hybrid
(zamba2-7b), vlm (llama-3.2-vision-11b) and encdec (seamless-m4t-large-v2)
configs, the JAX package's values.  ``shapes`` holds the four assigned
input shapes.

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` resolve an
architecture id, as ``repro.configs`` does; an unknown id raises.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "seamless-m4t-large-v2",
    "granite-moe-1b-a400m",
    "llama-3.2-vision-11b",
    "internlm2-20b",
    "starcoder2-15b",
    "mamba2-130m",
    "mixtral-8x22b",
    "zamba2-7b",
    "deepseek-67b",
    "llama3.2-3b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; choose from "
                         f"{ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    """Full-size config for an architecture id."""
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config (2 layers, d_model 128)."""
    return _module(arch_id).SMOKE_CONFIG
