"""Fading-channel models for the over-the-air uplink.

Counterpart of ``repro/core/channel.py``.  Each model samples the per-agent,
per-round gain ``h_{i,k}`` of Eq. (6) from an explicit ``torch.Generator`` and
exposes its exact moments ``(m_h, sigma_h^2)`` as Python floats, equal to the
JAX package's.  The paper's settings: ``RayleighChannel(scale=1)`` and
``NakagamiChannel(m=0.1, omega=1)`` (power-gain convention,
``sigma_h^2 = 10 m_h^2``).  ``BatchedChannel`` and ``register_channel`` belong
to the sweep engine and come with it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class Channel:
    """Base class: a distribution over non-negative gains h."""

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...],
               device) -> torch.Tensor:
        raise NotImplementedError

    @property
    def mean(self) -> float:  # m_h
        raise NotImplementedError

    @property
    def var(self) -> float:  # sigma_h^2
        raise NotImplementedError

    @property
    def second_moment(self) -> float:
        return self.var + self.mean ** 2

    def satisfies_theorem1(self, n_agents: int) -> bool:
        """The Theorem-1 channel condition sigma_h^2 <= (N+1) m_h^2."""
        return self.var <= (n_agents + 1) * self.mean ** 2


def _normal(generator, shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)


@dataclass(frozen=True)
class IdealChannel(Channel):
    """h == 1: exact (TDMA/FDMA) aggregation."""

    def sample(self, generator, shape, device) -> torch.Tensor:
        return torch.ones(tuple(shape), device=device, dtype=torch.float32)

    @property
    def mean(self) -> float:
        return 1.0

    @property
    def var(self) -> float:
        return 0.0


@dataclass(frozen=True)
class FixedGainChannel(Channel):
    """h == gain: distortion without randomness."""

    gain: float = 1.0

    def sample(self, generator, shape, device) -> torch.Tensor:
        return torch.full(tuple(shape), self.gain, device=device,
                          dtype=torch.float32)

    @property
    def mean(self) -> float:
        return self.gain

    @property
    def var(self) -> float:
        return 0.0


@dataclass(frozen=True)
class RayleighChannel(Channel):
    """Rayleigh(scale): the norm of two iid N(0, s^2) draws.

    mean = s*sqrt(pi/2); var = (4-pi)/2 * s^2.  The paper uses s=1.
    """

    scale: float = 1.0

    def sample(self, generator, shape, device) -> torch.Tensor:
        z = _normal(generator, tuple(shape) + (2,), device)
        return self.scale * torch.sqrt(torch.sum(z * z, dim=-1))

    @property
    def mean(self) -> float:
        return self.scale * math.sqrt(math.pi / 2.0)

    @property
    def var(self) -> float:
        return (4.0 - math.pi) / 2.0 * self.scale ** 2


@dataclass(frozen=True)
class NakagamiChannel(Channel):
    """Nakagami-m power gain: h ~ Gamma(shape=m, scale=omega/m)."""

    m: float = 0.1
    omega: float = 1.0

    def sample(self, generator, shape, device) -> torch.Tensor:
        alpha = torch.full(tuple(shape), self.m, device=device,
                           dtype=torch.float32)
        return torch._standard_gamma(alpha, generator=generator) * (
            self.omega / self.m)

    @property
    def mean(self) -> float:
        return self.omega

    @property
    def var(self) -> float:
        return self.omega ** 2 / self.m


@dataclass(frozen=True)
class LogNormalChannel(Channel):
    """Log-normal shadowing: h = exp(mu + sigma Z)."""

    mu: float = 0.0
    sigma: float = 0.25

    def sample(self, generator, shape, device) -> torch.Tensor:
        return torch.exp(self.mu + self.sigma * _normal(generator, shape,
                                                        device))

    @property
    def mean(self) -> float:
        return math.exp(self.mu + self.sigma ** 2 / 2.0)

    @property
    def var(self) -> float:
        return (math.exp(self.sigma ** 2) - 1.0) * math.exp(
            2 * self.mu + self.sigma ** 2)


_REGISTRY: Dict[str, type] = {
    "ideal": IdealChannel,
    "fixed": FixedGainChannel,
    "rayleigh": RayleighChannel,
    "nakagami": NakagamiChannel,
    "lognormal": LogNormalChannel,
}


def make_channel(name: str, **kwargs) -> Channel:
    """Factory: make_channel('rayleigh'), make_channel('nakagami', m=0.1)."""
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError as e:
        raise ValueError(
            f"unknown channel {name!r}; choose from {sorted(_REGISTRY)}"
        ) from e


def noise_sigma_from_db(db: float) -> float:
    """sigma of the AWGN for a noise power in dB: sigma^2 = 10^(db/10)."""
    return math.sqrt(10.0 ** (db / 10.0))
