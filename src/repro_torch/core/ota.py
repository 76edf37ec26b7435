"""Over-the-air aggregation (Eq. 6-7), stacked form.

Counterpart of ``repro/core/ota.py`` for the form the RL loops use: per-agent
gradient dicts stacked on a leading N axis.  The channel superposes the
agents' signals, ``v_k = sum_i h_{i,k} g_i + n_k``, and the server applies
``theta <- theta - alpha * u_k`` with ``u_k = v_k * scale`` and
``scale = 1 / (N * m_h)`` under ``debias`` (``1 / N`` otherwise).

Backends (:class:`AggregateSpec`):

* ``"torch"`` — the plain PyTorch chain over the dict leaves
  (:func:`_aggregate_stacked_torch`, the counterpart of the XLA chain);
* ``"cuda"``  — the hand-written kernel K1 over the flattened parameter
  vector (``repro_torch.kernels.ota_fused``); a CPU tensor raises;
* ``"auto"``  — the kernel for CUDA tensors, the plain chain on the CPU.

Random streams: each noisy round draws the gains ``h`` and then one uint32
kernel seed from the round's ``torch.Generator``.  Both backends take their
AWGN from the kernel's counter PRNG keyed on that seed and the absolute flat
index, so the two backends see the same gains and the same noise for the
same generator state.  ``gains=`` and ``seed=`` inject the draws (the parity
tests feed the JAX package's own).  ``power_control``, the axis forms and
agent streaming come with later parts of the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.channel import Channel
from repro_torch.kernels import ota_fused, ref
from repro_torch.utils.tree import (
    Params, flatten_agent_stack, flatten_params, theta_device, tree_keys,
)

Seed = Union[int, torch.Tensor]


@dataclass(frozen=True)
class OTAConfig:
    """Static configuration of the over-the-air uplink.

    ``update_scale`` overrides the server normalisation ``1 / (N * m_h)``;
    ``wire_dtype="bfloat16"`` narrows the uplink payload on the kernel path
    (compute and the parameter master copy stay float32)."""

    channel: Channel
    noise_sigma: float = 0.0   # sigma of the AWGN on the *sum* (Eq. 6)
    debias: bool = False       # divide by m_h (unbiased grad estimate)
    power_control: Optional[object] = None
    update_scale: Optional[float] = None
    wire_dtype: str = ""       # "" (native) | "bfloat16"

    def __post_init__(self):
        if self.power_control is not None:
            raise NotImplementedError(
                "power_control is not ported yet (see ROADMAP.md)")
        if self.wire_dtype not in ("", "bfloat16"):
            raise ValueError(f"wire_dtype must be '' or 'bfloat16', got "
                             f"{self.wire_dtype!r}")
        if self.debias and self.update_scale is None \
                and not math.isfinite(self.channel.mean):
            raise ValueError(f"debias=True needs a finite channel mean, got "
                             f"m_h={self.channel.mean!r}")

    @property
    def norm_const(self) -> float:
        """The debias normaliser m_h (1 without debias)."""
        return self.channel.mean if self.debias else 1.0

    def norm_const_for(self, n_agents: Optional[int] = None) -> float:
        """The normaliser the aggregation divides by; with power control
        (not ported yet) it would be the effective mean for ``n_agents``."""
        del n_agents
        return self.norm_const


_BACKENDS = ("auto", "torch", "cuda")


@dataclass(frozen=True)
class AggregateSpec:
    """One aggregation call: ``exact`` (Algorithm 1's plain mean) and the
    ``backend`` (``"torch"`` | ``"cuda"`` | ``"auto"``)."""

    exact: bool = False
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; one of {_BACKENDS}")

    def resolved_backend(self, device: torch.device) -> str:
        """The backend this spec runs on for tensors on ``device``."""
        if self.exact:
            return "torch"
        if self.backend == "auto":
            return "cuda" if device.type == "cuda" else "torch"
        if self.backend == "cuda" and device.type != "cuda":
            raise ValueError(f"backend='cuda' needs CUDA tensors, got "
                             f"{device} (use backend='auto' or 'torch')")
        return self.backend


def sample_gains(cfg: OTAConfig, generator: torch.Generator, n_agents: int,
                 device) -> torch.Tensor:
    """h_{i,k} for every agent for one round: shape (n_agents,)."""
    return cfg.channel.sample(generator, (n_agents,), device)


def sample_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One uint32 counter-PRNG seed (as an int64 0-dim tensor on ``device``,
    so a draw on the card needs no host synchronisation) — the counterpart
    of ``_kernel_seed``."""
    return torch.randint(0, 2 ** 32, (), generator=generator, device=device,
                         dtype=torch.int64)


def _round_draws(cfg: OTAConfig, generator: Optional[torch.Generator],
                 n: int, device, gains: Optional[torch.Tensor],
                 seed: Optional[Seed]) -> Tuple[torch.Tensor, Seed]:
    """This round's gains and kernel seed: drawn from ``generator`` in that
    order, unless injected."""
    if generator is None and (gains is None or seed is None):
        raise ValueError("noisy aggregation needs a generator, or injected "
                         "gains= and seed=")
    h = sample_gains(cfg, generator, n, device) if gains is None else gains
    s = sample_seed(generator, device) if seed is None else seed
    return h.to(device=device, dtype=torch.float32), s


def _server_scale(cfg: OTAConfig, n_total: int,
                  n_agents: Optional[int]) -> float:
    """The epilogue's multiplier, in Python double: ``update_scale`` or
    ``1 / (n_total * m_h)``.  Kernels round it to float32 once."""
    if cfg.update_scale is not None:
        return cfg.update_scale
    return 1.0 / (n_total * cfg.norm_const_for(n_agents))


def _server_epilogue(cfg: OTAConfig, seed: Seed, v: Params,
                     n_total: int, n_agents: Optional[int]) -> Params:
    """The server tail of the plain chain: AWGN on the summed signal from
    the counter stream over the flat layout, then the normalisation."""
    dev = theta_device(v)
    if cfg.noise_sigma > 0.0:
        flat, unflatten = flatten_params(v)
        noise = unflatten(ref.counter_noise(seed, flat.numel(), dev))
        sigma = ref.f32(cfg.noise_sigma)
        v = {k: v[k] + sigma * noise[k] for k in tree_keys(v)}
    scale = ref.f32(_server_scale(cfg, n_total, n_agents))
    return {k: v[k] * scale for k in tree_keys(v)}


def _aggregate_stacked_torch(cfg: OTAConfig, h: torch.Tensor, seed: Seed,
                             grads: Params) -> Params:
    """u_k = (sum_i h_i g_i + sigma n_k) * scale over the dict leaves."""
    n = grads[tree_keys(grads)[0]].shape[0]

    def combine(g):
        hb = h.reshape((n,) + (1,) * (g.ndim - 1)).to(g.dtype)
        return torch.sum(hb * g, dim=0)

    v = {k: combine(grads[k]) for k in tree_keys(grads)}
    return _server_epilogue(cfg, seed, v, n, n)


def _exact_mean(grads: Params) -> Params:
    """Algorithm 1: the exact mean of the per-agent gradients."""
    return {k: torch.mean(grads[k], dim=0) for k in tree_keys(grads)}


def _wire_dtype(cfg: OTAConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.wire_dtype == "bfloat16" else None


def _aggregate_stacked_cuda(cfg: OTAConfig, h: torch.Tensor, seed: Seed,
                            grads: Params) -> Params:
    flat, n, unflatten = flatten_agent_stack(grads)
    u = ota_fused.fused_aggregate(
        flat, h, sigma=cfg.noise_sigma, scale=_server_scale(cfg, n, n),
        seed=seed, with_noise=cfg.noise_sigma > 0.0,
        wire_dtype=_wire_dtype(cfg))
    return unflatten(u)


def _aggregate_apply_cuda(cfg: OTAConfig, h: torch.Tensor, seed: Seed,
                          grads: Params, params: Params, alpha) -> Params:
    flat, n, _ = flatten_agent_stack(grads)
    pflat, punflatten = flatten_params(params)
    p_next = ota_fused.fused_aggregate_sgd(
        flat, h, pflat, alpha=alpha, sigma=cfg.noise_sigma,
        scale=_server_scale(cfg, n, n), seed=seed,
        with_noise=cfg.noise_sigma > 0.0,
        wire_dtype=_wire_dtype(cfg))
    return punflatten(p_next)


def aggregate(grads: Params, cfg: Optional[OTAConfig], *,
              generator: Optional[torch.Generator] = None,
              backend: str = "auto", gains: Optional[torch.Tensor] = None,
              seed: Optional[Seed] = None) -> Tuple[Params, torch.Tensor]:
    """OTA-aggregate the (N, ...) stack ``grads``; returns ``(u_k, h)``.

    ``cfg=None`` is the exact Algorithm-1 uplink (mean; ``h == 1``).
    ``gains``/``seed`` inject the round's draws instead of drawing them from
    ``generator``."""
    spec = AggregateSpec(exact=cfg is None, backend=backend)
    dev = theta_device(grads)
    be = spec.resolved_backend(dev)
    if spec.exact:
        return _exact_mean(grads), torch.ones((), device=dev)
    n = grads[tree_keys(grads)[0]].shape[0]
    h, s = _round_draws(cfg, generator, n, dev, gains, seed)
    if be == "cuda":
        return _aggregate_stacked_cuda(cfg, h, s, grads), h
    return _aggregate_stacked_torch(cfg, h, s, grads), h


def aggregate_apply(grads: Params, cfg: Optional[OTAConfig], params: Params,
                    *, alpha, generator: Optional[torch.Generator] = None,
                    backend: str = "auto",
                    gains: Optional[torch.Tensor] = None,
                    seed: Optional[Seed] = None) -> Tuple[Params, torch.Tensor]:
    """Aggregate + server SGD step ``theta' = theta - alpha * u_k``; returns
    ``(theta', h)``.  On the kernel path the gain matvec, AWGN, debias and
    update are one launch of K1 (``fused_aggregate_sgd``)."""
    spec = AggregateSpec(exact=cfg is None, backend=backend)
    dev = theta_device(grads)
    if spec.exact or spec.resolved_backend(dev) == "torch":
        u, h = aggregate(grads, cfg, generator=generator, backend="torch",
                         gains=gains, seed=seed)
        return {k: params[k] - alpha * u[k] for k in tree_keys(params)}, h
    n = grads[tree_keys(grads)[0]].shape[0]
    h, s = _round_draws(cfg, generator, n, dev, gains, seed)
    return _aggregate_apply_cuda(cfg, h, s, grads, params, alpha), h
