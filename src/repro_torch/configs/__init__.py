"""The paper's experiment settings and the model configs ported so far.

The dense (llama3.2-3b, deepseek-67b, internlm2-20b, starcoder2-15b), ssm
(mamba2-130m) and moe (granite-moe-1b-a400m, mixtral-8x22b) configs; the
hybrid, vlm and encdec ids wait for their families.  ``shapes`` holds the
four assigned input shapes.

``get_config(arch_id)`` / ``get_smoke_config(arch_id)`` resolve the ported
architecture ids, as ``repro.configs`` does for all of its ids.  An id the
JAX package has but the port does not yet raises, naming ``ROADMAP.md``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "granite-moe-1b-a400m",
    "internlm2-20b",
    "starcoder2-15b",
    "mamba2-130m",
    "mixtral-8x22b",
    "deepseek-67b",
    "llama3.2-3b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise ValueError(f"arch {arch_id!r} is not ported yet (ported: "
                         f"{ARCH_IDS}); ROADMAP.md lists the rest")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    """Full-size config for a ported architecture id."""
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config (2 layers, d_model 128)."""
    return _module(arch_id).SMOKE_CONFIG
