"""Serving: batched greedy decode steps over a KV cache or SSM state.

Counterpart of ``repro/train/server.py`` without sharding (``cache_specs``
comes with the distribute slice).  Cache capacity honours the
architecture's serving window: SWA archs use a ring buffer of ``window``
slots; SSM archs carry O(1) recurrent state.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import InputShape
from repro_torch.models import transformer
from repro_torch.models.model import Model, serve_capacity


@dataclass(frozen=True)
class ServeConfig:
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0


def make_serve_step(model: Model, shape: InputShape):
    """serve_step(params, cache, token) -> (next_token, logits, cache').
    Tokens are int64 (B, 1) tensors, the index type of PyTorch."""
    cfg = model.cfg
    window = cfg.window or cfg.serve_window
    eff_window = window if (window and window < shape.seq_len) else None

    @torch.no_grad()
    def serve_step(params, cache, token):
        logits, cache = transformer.decode(params, cfg, cache, token,
                                           window=eff_window)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return next_token, logits, cache

    return serve_step


def init_cache_for_shape(model: Model, shape: InputShape, device=None):
    cfg = model.cfg
    cap = serve_capacity(cfg, shape.seq_len)
    mem_len = transformer.cross_len(cfg, shape.seq_len)
    cache = model.init_cache(shape.global_batch, cap, mem_len, device=device)
    # decode_32k/long_500k semantics: the cache is already full up to seq_len-1
    return cache._replace(pos=shape.seq_len - 1)
