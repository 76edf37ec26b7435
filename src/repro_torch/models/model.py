"""Public model API: ``build(config)`` -> a ``Model`` of plain functions.

Counterpart of ``repro/models/model.py`` for every family; the vlm and
encdec families take their frontend ``memory`` (``data.pipeline.memory_stub``)
in ``forward`` and ``prefill``, and ``init_cache`` sizes its K/V by
``mem_len``.
``Model.init`` draws the parameters from an explicit ``torch.Generator`` of
the device it is given (``cuda`` unless the caller passes ``device="cpu"``).
The abstract stand-ins (``Model.abstract``, :func:`abstract_inputs`,
:func:`abstract_cache`) are tensors on the ``meta`` device, the torch
meaning of JAX's ``ShapeDtypeStruct``: shapes and dtypes, no storage.
Tokens are int64, the port's index type, where the JAX package's are
int32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.param import (
    Rules, abstract_params, init_params, partition_specs,
)
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

    def abstract(self):
        """The parameters as ``meta`` tensors (no storage)."""
        return abstract_params(self.plan, self.cfg.dtype)

    def specs(self, rules: Rules, mesh):
        """Every leaf's partition spec under ``rules`` on ``mesh``."""
        return partition_specs(self.plan, rules, mesh)

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


def abstract_inputs(cfg: ModelConfig, shape: InputShape, *,
                    dtype: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for one step of the given kind.

    train:   {tokens, labels[, memory]}          (B, S) int64
    prefill: {tokens[, memory]}
    decode:  {token}  (B, 1) — cache/params come from their own specs
    """
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, dtype or cfg.dtype)

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"token": meta((b, 1), torch.int64)}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    out = {"tokens": meta((b, s), torch.int64)}
    if shape.kind == "train":
        out["labels"] = meta((b, s), torch.int64)
    if needs_memory(cfg):
        out["memory"] = meta((b, transformer.cross_len(cfg, s), cfg.d_model),
                             dt)
    return out


def abstract_cache(cfg: ModelConfig, shape: InputShape):
    """``meta`` stand-ins matching ``init_cache`` for the decode shapes."""
    return transformer.init_cache(
        cfg, shape.global_batch, serve_capacity(cfg, shape.seq_len),
        transformer.cross_len(cfg, shape.seq_len), device="meta")
