"""Dispatch layer over the port's kernels.

Counterpart of ``repro/kernels/ops.py`` with the JAX signatures minus
``use_pallas``, ``interpret`` and ``block_*``: each function launches its
CUDA kernel for CUDA tensors and runs the kernel's plain PyTorch version for
CPU tensors (the wrappers decide, by device).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ota_channel as _ota
from repro_torch.kernels import ota_fused as _fused
from repro_torch.kernels import ssd_scan as _ssd


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """(B, H, S, Dh) attention through K3; GQA via Hkv < H."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """(B, S, H, P) Mamba2 SSD scan through K4, float32 out (as the JAX
    model's ``ssd_ref``)."""
    return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)


def ota_update(v: torch.Tensor, *, sigma: float, n_agents: int,
               m_h: float = 1.0, debias: bool = True,
               seed: int = 0) -> torch.Tensor:
    """The paper's fused server update ``(v + sigma*n) / (N * m_h)`` (K2).

    On the CPU it runs K2's plain version, which draws the kernel's counter
    stream: the port equals the JAX package's *kernel* here, where the JAX
    function with ``use_pallas=False`` draws threefry noise instead."""
    return _ota.ota_channel_apply(v, sigma=sigma, n_agents=n_agents,
                                  m_h=m_h, debias=debias, seed=seed)


def ota_aggregate(grads: torch.Tensor, gains: torch.Tensor, *, sigma=0.0,
                  scale=1.0, seed=0, with_noise: Optional[bool] = None,
                  wire_dtype=None) -> torch.Tensor:
    """The whole uplink — gain matvec + AWGN + debias — in one pass (K1)."""
    return _fused.fused_aggregate(grads, gains, sigma=sigma, scale=scale,
                                  seed=seed, with_noise=with_noise,
                                  wire_dtype=wire_dtype)


def ota_aggregate_sgd(grads: torch.Tensor, gains: torch.Tensor,
                      params: torch.Tensor, *, alpha, sigma=0.0, scale=1.0,
                      seed=0, with_noise: Optional[bool] = None,
                      wire_dtype=None) -> torch.Tensor:
    """Uplink + server SGD step fused (K1): p' = p - alpha * u."""
    return _fused.fused_aggregate_sgd(grads, gains, params, alpha=alpha,
                                      sigma=sigma, scale=scale, seed=seed,
                                      with_noise=with_noise,
                                      wire_dtype=wire_dtype)
