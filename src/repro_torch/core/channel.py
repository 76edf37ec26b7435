"""Fading-channel models for the over-the-air uplink.

Counterpart of ``repro/core/channel.py``.  Each model samples the per-agent,
per-round gain ``h_{i,k}`` of Eq. (6) from an explicit ``torch.Generator`` and
exposes its exact moments ``(m_h, sigma_h^2)`` as Python floats, equal to the
JAX package's.  The paper's settings: ``RayleighChannel(scale=1)`` and
``NakagamiChannel(m=0.1, omega=1)`` (power-gain convention,
``sigma_h^2 = 10 m_h^2``).

The scenario-sweep engine batches Monte-Carlo runs and scenarios as lanes
of one round: ``register_channel`` / ``channel_kind`` name a family,
``batched_channel_arrays`` stacks a same-kind list into float64 parameter
arrays (derived constants precomputed in float64, as the JAX package does),
and :class:`BatchedChannel` samples every lane at once.  Lane l draws its
variates from its own generator, in the concrete class's shape and order,
so lane l's gains are bitwise the concrete channel's draw from the same
generator; only the deterministic transform runs once over the lanes.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
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

# Hooks of families whose fields are not all plain floats (the power-
# controlled channel nests a base channel and a policy), keyed by the root
# of the kind tag (the part before the first ':'):
#   packer(channels)                              -> Dict[str, np.ndarray]
#   sampler(kind, params, generators, shape, dev) -> (L, *shape) tensor
_BATCHED_PACKERS: Dict[str, Callable[..., Dict[str, np.ndarray]]] = {}
_BATCHED_SAMPLERS: Dict[str, Callable[..., torch.Tensor]] = {}


def register_channel(name: str, cls: type, *,
                     packer: Callable[..., Dict[str, np.ndarray]] = None,
                     sampler: Callable[..., torch.Tensor] = None) -> None:
    """Add a channel family to the registry (and the sweep engine).
    ``packer``/``sampler`` are needed only when the dataclass fields are
    not all plain floats; a class may define ``kind_tag()`` returning a
    refined tag (``'<name>:<...>'``) so structurally different members of a
    family fall into separate sweep partitions."""
    _REGISTRY[name] = cls
    if packer is not None:
        _BATCHED_PACKERS[name] = packer
    if sampler is not None:
        _BATCHED_SAMPLERS[name] = sampler


def channel_kind(ch: Channel) -> str:
    """Reverse registry lookup, ``RayleighChannel() -> 'rayleigh'``, refined
    by the class's ``kind_tag()`` where it has one."""
    for name, cls in _REGISTRY.items():
        if type(ch) is cls:
            tag = getattr(ch, "kind_tag", None)
            return tag() if callable(tag) else name
    raise ValueError(f"channel {type(ch).__name__} is not in the registry")


def batched_channel_arrays(
        channels: Sequence[Channel]) -> Tuple[str, Dict[str, np.ndarray]]:
    """Stack a same-kind channel list into ``(len(channels),)`` float64
    arrays: every dataclass field, plus derived constants computed in
    float64 so a lane reproduces the concrete class bit for bit —
    ``_mean``/``_var`` (m_h, sigma_h^2) and, for Nakagami, the Gamma scale
    ``_omega_over_m``.  Families registered with a ``packer`` stack through
    it; their kind is the full composite tag."""
    kinds = {channel_kind(ch) for ch in channels}
    if len(kinds) != 1:
        raise ValueError(f"cannot batch across channel kinds {sorted(kinds)}")
    kind = kinds.pop()
    root = kind.split(":", 1)[0]
    if root in _BATCHED_PACKERS:
        params = _BATCHED_PACKERS[root](channels)
    else:
        params = {f.name: np.array([float(getattr(ch, f.name))
                                    for ch in channels], np.float64)
                  for f in dataclasses.fields(channels[0])}
        if kind == "nakagami":
            params["_omega_over_m"] = np.array(
                [float(ch.omega) / float(ch.m) for ch in channels],
                np.float64)
    params["_mean"] = np.array([float(ch.mean) for ch in channels],
                               np.float64)
    params["_var"] = np.array([float(ch.var) for ch in channels], np.float64)
    if not (np.isfinite(params["_mean"]).all()
            and np.isfinite(params["_var"]).all()):
        raise ValueError(
            f"channel kind {kind!r} has non-finite (m_h, sigma_h^2) moments; "
            "power-controlled channels must be built with "
            "make_controlled_channel so their effective moments are known")
    return kind, params


def lane_param(x: Any, n_trailing: int) -> Any:
    """A per-lane parameter as a factor of an ``(L, *shape)`` tensor: an
    ``(L,)`` tensor gains ``n_trailing`` unit axes; a shared Python number
    stays as it is (the concrete class's own literal)."""
    if isinstance(x, torch.Tensor):
        return x.reshape((-1,) + (1,) * n_trailing)
    return x


@dataclass(frozen=True)
class BatchedChannel(Channel):
    """A channel family over L lanes.  ``params`` maps each parameter (and
    the derived constants of :func:`batched_channel_arrays`) to an ``(L,)``
    float32 tensor on the run's device, or to a Python float shared by
    every lane.  :meth:`sample` takes one generator per lane and returns
    ``(L, *shape)`` gains; ``mean`` and ``var`` are the per-lane moments."""

    kind: str = ""
    params: Any = None

    @staticmethod
    def of(channel: Channel) -> "BatchedChannel":
        """The lane form of one concrete channel shared by every lane (its
        parameters as Python floats: the same literals it samples with)."""
        kind, arrays = batched_channel_arrays([channel])
        return BatchedChannel(kind=kind, params={k: float(v[0])
                                                 for k, v in arrays.items()})

    def sample(self, generators: Sequence[torch.Generator],
               shape: Tuple[int, ...], device) -> torch.Tensor:
        p, shape, nd = self.params, tuple(shape), len(tuple(shape))
        lanes = len(generators)
        root = self.kind.split(":", 1)[0]
        if root in _BATCHED_SAMPLERS:
            return _BATCHED_SAMPLERS[root](self.kind, p, generators, shape,
                                           device)
        if self.kind == "ideal":
            return torch.ones((lanes,) + shape, device=device,
                              dtype=torch.float32)
        if self.kind == "fixed":
            gain = p["gain"]
            if isinstance(gain, torch.Tensor):
                return lane_param(gain, nd).expand((lanes,) + shape) \
                    .contiguous()
            return torch.full((lanes,) + shape, gain, device=device,
                              dtype=torch.float32)
        if self.kind == "rayleigh":
            z = torch.stack([_normal(g, shape + (2,), device)
                             for g in generators])
            return lane_param(p["scale"], nd) * torch.sqrt(
                torch.sum(z * z, dim=-1))
        if self.kind == "nakagami":
            m = p["m"]
            draws = []
            for i, g in enumerate(generators):
                alpha = (m[i].expand(shape).contiguous()
                         if isinstance(m, torch.Tensor)
                         else torch.full(shape, m, device=device,
                                         dtype=torch.float32))
                draws.append(torch._standard_gamma(alpha, generator=g))
            return torch.stack(draws) * lane_param(p["_omega_over_m"], nd)
        if self.kind == "lognormal":
            z = torch.stack([_normal(g, shape, device) for g in generators])
            return torch.exp(lane_param(p["mu"], nd)
                             + lane_param(p["sigma"], nd) * z)
        raise ValueError(f"unknown batched channel kind {self.kind!r}")

    @property
    def mean(self):  # per-lane m_h
        return self.params["_mean"]

    @property
    def var(self):  # per-lane sigma_h^2
        return self.params["_var"]


def sample_lanes(channel: Channel, generators: Sequence[torch.Generator],
                 shape: Tuple[int, ...], device) -> torch.Tensor:
    """``(L, *shape)`` gains, lane l from ``generators[l]``: a
    :class:`BatchedChannel` samples all lanes at once; a channel outside
    the registry samples lane by lane (its own ``sample``)."""
    if not isinstance(channel, BatchedChannel):
        try:
            channel = BatchedChannel.of(channel)
        except ValueError:   # not registered: the class's own draw, per lane
            return torch.stack([channel.sample(g, shape, device)
                                for g in generators])
    return channel.sample(generators, shape, device)


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
