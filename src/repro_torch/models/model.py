"""Public model API: ``build(config)`` -> a ``Model`` of plain functions.

Counterpart of ``repro/models/model.py`` for every family; the vlm and
encdec families take their frontend ``memory`` (``data.pipeline.memory_stub``)
in ``forward`` and ``prefill``, and ``init_cache`` sizes its K/V by
``mem_len``.
``Model.init`` draws the parameters from an explicit ``torch.Generator`` of
the device it is given (``cuda`` unless the caller passes ``device="cpu"``).
The JAX package's ``abstract_*`` stand-ins have no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.param import init_params
from repro_torch.utils.device import DeviceLike


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    plan: Any

    def init(self, generator: torch.Generator, device: DeviceLike = None):
        """Parameters on ``device`` (None means cuda, and raises without a
        GPU), drawn from ``generator``, which must be of that device; in the
        config's dtype (norm scales and SSM scalars in float32)."""
        return init_params(self.plan, self.cfg.dtype, generator=generator,
                           device=device)

    def forward(self, params, tokens, memory=None, *, blockwise=False):
        return transformer.forward(params, self.cfg, tokens, memory,
                                   blockwise=blockwise)

    def prefill(self, params, tokens, memory=None):
        return transformer.prefill(params, self.cfg, tokens, memory)

    def decode(self, params, cache, token, *, window=None):
        return transformer.decode(params, self.cfg, cache, token,
                                  window=window)

    def init_cache(self, batch, capacity, mem_len=0, dtype=None, device=None):
        return transformer.init_cache(self.cfg, batch, capacity, mem_len,
                                      dtype, device)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, plan=transformer.plan(cfg))


def serve_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """KV-cache slots for decode: full context, or the SWA ring if the arch
    serves long contexts through a sliding window."""
    win = cfg.window or cfg.serve_window
    if win is not None and win < seq_len:
        return win
    return seq_len


def needs_memory(cfg: ModelConfig) -> bool:
    return cfg.family in ("vlm", "encdec")
