"""Transmit-power policies: h_{i,k} = c_{i,k} * p_{i,k}.

Counterpart of ``repro/core/power_control.py``.  The paper folds the power
coefficient p into the effective gain h and only needs the pair
(m_h, sigma_h^2) that Theorems 1/2 are stated in; these policies shape p as
a function of the actual channel gain c.

Policies: ``UnitPower`` (p = 1, the paper's default), ``TruncatedInversion``
(p = min(target/c, p_max), outage below c_min), ``FullInversion`` (no
outage), ``ConstantReceived`` (h = target a.s.) and ``HeterogeneousBudget``
(per-agent constant budgets linspaced over the agents).

Moments: :func:`make_controlled_channel` builds the effective-gain
``ControlledChannel`` with finite (m_h, sigma_h^2): the closed forms
(inversion over Rayleigh through lower incomplete gamma functions, constant
received power, the budget mixture) are the JAX package's, in Python double,
so they equal its values; anything else falls back to :func:`estimate_moments`
Monte Carlo.  That fallback draws on the CPU from
``torch.Generator().manual_seed(0)``: a configuration-time constant, the same
on every machine and device, but not the JAX package's ``jax.random.key(0)``
draw (torch cannot replay threefry).

Lanes: ``ControlledChannel`` is registered with the channel registry under
``controlled`` with its sweep hooks, ``_pack_controlled`` (base parameters
under ``base.``, policy parameters under ``pc.``) and ``_sample_controlled``
(the base's lane draw, then the policy rebuilt from the lanes' parameters).
A policy's float fields may hold ``(L, 1)`` tensors, one value per lane:
``apply`` forms ``target / c`` as ``reciprocal(c) * target``, which is what
PyTorch computes for a Python-float numerator, so a lane's power is
bitwise the concrete policy's.  ``HeterogeneousBudget`` lanes whose
``p_min``/``p_max`` vary are :class:`LaneBudgets`: each lane's ``(N,)``
budgets built as its run builds them (a ``linspace`` from the lane's own
Python floats, on the run's device) and stacked to ``(L, N)`` once per run,
never per round; a float32 ``linspace`` of lane tensors could round
otherwise.  A streamed round draws the gains for all N agents and slices
them per block, so a block's budgets are this row at its absolute agent
indices.
"""
from __future__ import annotations

import functools
import math
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import channel as _channel
from repro_torch.core.channel import BatchedChannel, Channel, RayleighChannel

_POLICY_REGISTRY: Dict[str, type] = {}


def register_policy(cls: type) -> type:
    """Class decorator: make a policy rebuildable from lane parameters."""
    _POLICY_REGISTRY[cls.__name__] = cls
    return cls


def _inv(c: torch.Tensor) -> torch.Tensor:
    """``1 / max(c, 1e-12)`` as PyTorch forms a Python-float numerator's
    division (``reciprocal``, then the multiply by the numerator)."""
    return torch.reciprocal(torch.clamp(c, min=1e-12))


@dataclass(frozen=True)
class PowerPolicy:
    # True for policies whose p depends on the agent index (the gain
    # tensor's last axis is then the agent axis).
    per_agent = False

    def apply(self, c: torch.Tensor) -> torch.Tensor:
        """Map actual channel gains c to transmit power coefficients p."""
        raise NotImplementedError

    def apply_indexed(self, c: torch.Tensor, idx: torch.Tensor,
                      n_agents: int) -> torch.Tensor:
        """Single-agent form: p for gains ``c`` of agents ``idx`` out of
        ``n_agents``."""
        del idx, n_agents
        return self.apply(c)

    def closed_form_moments(self, base: Channel,
                            n_agents: Optional[int] = None
                            ) -> Optional[Tuple[float, float]]:
        """Exact effective-gain (m_h, sigma_h^2) over ``base`` when known,
        else None (callers fall back to :func:`estimate_moments`)."""
        del base, n_agents
        return None


@register_policy
@dataclass(frozen=True)
class UnitPower(PowerPolicy):
    """p == 1: the paper's default (h = c)."""

    def apply(self, c):
        return torch.ones_like(c)

    def closed_form_moments(self, base, n_agents=None):
        return float(base.mean), float(base.var)


def _rayleigh_partial_moments(scale: float, lo: float,
                              hi: float) -> Tuple[float, float]:
    """(int_lo^hi c f(c) dc, int_lo^hi c^2 f(c) dc) for Rayleigh(scale).

    With u = c^2/(2 s^2) ~ Exp(1) these are lower-incomplete-gamma
    differences: gamma(3/2, u) = sqrt(pi)/2 erf(sqrt(u)) - sqrt(u) e^-u and
    gamma(2, u) = 1 - (1+u) e^-u.
    """
    s2 = scale * scale

    def u(c: float) -> float:
        return c * c / (2.0 * s2)

    def g32(x: float) -> float:
        return (0.5 * math.sqrt(math.pi) * math.erf(math.sqrt(x))
                - math.sqrt(x) * math.exp(-x))

    def g2(x: float) -> float:
        return 1.0 - (1.0 + x) * math.exp(-x)

    i1 = scale * math.sqrt(2.0) * (g32(u(hi)) - g32(u(lo)))
    i2 = 2.0 * s2 * (g2(u(hi)) - g2(u(lo)))
    return i1, i2


def _rayleigh_inversion_moments(scale: float, target: float, p_max: float,
                                c_min: float) -> Tuple[float, float]:
    """Exact (m_h, sigma_h^2) of h = c * min(target/c, p_max) * 1{c >= c_min}
    over Rayleigh(scale): h = p_max c on [c_min, target/p_max), = target
    above."""
    t = target / p_max
    lo, hi = c_min, max(c_min, t)
    i1, i2 = _rayleigh_partial_moments(scale, lo, hi)
    surv = math.exp(-hi * hi / (2.0 * scale * scale))  # P(c >= hi)
    m = p_max * i1 + target * surv
    m2 = p_max * p_max * i2 + target * target * surv
    return m, max(m2 - m * m, 0.0)


@register_policy
@dataclass(frozen=True)
class TruncatedInversion(PowerPolicy):
    """p = min(target/c, p_max), with outage (p = 0) below c_min: agents
    invert their channel, deep fades truncated to respect the budget."""

    target: float = 1.0
    p_max: float = 10.0
    c_min: float = 0.05

    def apply(self, c):
        p = torch.clamp(_inv(c) * self.target, max=self.p_max)
        return torch.where(c >= self.c_min, p, torch.zeros_like(p))

    def closed_form_moments(self, base, n_agents=None):
        if type(base) is RayleighChannel:
            return _rayleigh_inversion_moments(
                float(base.scale), float(self.target), float(self.p_max),
                float(self.c_min))
        return None


@register_policy
@dataclass(frozen=True)
class FullInversion(PowerPolicy):
    """p = min(target/c, p_max): inversion with a power cap, no outage."""

    target: float = 1.0
    p_max: float = 10.0

    def apply(self, c):
        return torch.clamp(_inv(c) * self.target, max=self.p_max)

    def closed_form_moments(self, base, n_agents=None):
        if type(base) is RayleighChannel:
            return _rayleigh_inversion_moments(
                float(base.scale), float(self.target), float(self.p_max), 0.0)
        return None


@register_policy
@dataclass(frozen=True)
class ConstantReceived(PowerPolicy):
    """Phase-aware exact inversion, p = target/c, so h = target a.s.:
    sigma_h^2 = 0, the best case of Theorems 1/2."""

    target: float = 1.0

    def apply(self, c):
        return _inv(c) * self.target

    def closed_form_moments(self, base, n_agents=None):
        # exact for any base with no atom at 0 (all continuous models here)
        return float(self.target), 0.0


@register_policy
@dataclass(frozen=True)
class HeterogeneousBudget(PowerPolicy):
    """Per-agent constant budgets: agent i transmits at b_i, linearly spaced
    from ``p_min`` (agent 0) to ``p_max`` (agent N-1).  The gain tensor's
    last axis is the agent axis; the theory takes the mixture moments over a
    uniformly random agent."""

    p_min: float = 0.5
    p_max: float = 1.5

    per_agent = True

    def budgets(self, n_agents: int, device) -> torch.Tensor:
        """The ``(n_agents,)`` float32 budgets on ``device``."""
        return torch.linspace(self.p_min, self.p_max, n_agents,
                              dtype=torch.float32, device=device)

    def apply(self, c):
        if c.ndim == 0:
            raise ValueError(
                "HeterogeneousBudget.apply needs a trailing agent axis; "
                "single-agent paths must use apply_indexed")
        b = self.budgets(c.shape[-1], c.device).to(c.dtype)
        return torch.broadcast_to(b, c.shape)

    def apply_indexed(self, c, idx, n_agents):
        step = (self.p_max - self.p_min) / max(int(n_agents) - 1, 1)
        return (self.p_min + idx.to(c.dtype) * step) * torch.ones_like(c)

    def closed_form_moments(self, base, n_agents=None):
        if n_agents is None:
            raise ValueError(
                "HeterogeneousBudget moments depend on the agent count; "
                "pass n_agents (e.g. make_controlled_channel(..., "
                "n_agents=N))")
        n = int(n_agents)
        mean_b = (self.p_min + self.p_max) / 2.0
        step = (self.p_max - self.p_min) / max(n - 1, 1)
        var_b = 0.0 if n == 1 else step * step * (n * n - 1) / 12.0
        m_c, v_c = float(base.mean), float(base.var)
        m = mean_b * m_c
        m2 = (var_b + mean_b * mean_b) * (v_c + m_c * m_c)
        return m, max(m2 - m * m, 0.0)


@dataclass(frozen=True)
class LaneBudgets(PowerPolicy):
    """``HeterogeneousBudget`` over L lanes whose parameters vary: ``table``
    holds each lane's budgets as an ``(L, N)`` float32 tensor (module
    docstring); ``apply`` broadcasts it over ``(L, N)`` gains."""

    table: torch.Tensor = None  # type: ignore[assignment]

    per_agent = True

    @staticmethod
    def of(policies, n_agents: int, device) -> "LaneBudgets":
        """Each lane's ``budgets(n_agents, device)``, stacked once."""
        return LaneBudgets(torch.stack([p.budgets(n_agents, device)
                                        for p in policies]))

    def apply(self, c):
        return torch.broadcast_to(self.table.to(c.dtype), c.shape)


@dataclass(frozen=True)
class ControlledChannel(Channel):
    """Effective-gain channel h = c * policy(c) over a base channel, with
    its effective moments.  Build it with :func:`make_controlled_channel`:
    the moments are NaN until filled, and a debiased update refuses them."""

    base: Channel = None  # type: ignore[assignment]
    policy: PowerPolicy = UnitPower()
    _mean: float = float("nan")
    _var: float = float("nan")
    # per-agent policies: the agent count the moments were computed for
    _n_agents: Optional[int] = None

    def __post_init__(self):
        if self.base is None:
            raise ValueError(
                "ControlledChannel needs a base channel; construct it with "
                "make_controlled_channel(base, policy, ...)")

    def kind_tag(self) -> str:
        base_kind = _channel.channel_kind(self.base)
        if ":" in base_kind:
            raise ValueError("nested ControlledChannel is not supported")
        return f"controlled:{base_kind}:{type(self.policy).__name__}"

    def sample(self, generator, shape, device) -> torch.Tensor:
        shape = tuple(shape)
        if (self.policy.per_agent and self._n_agents is not None
                and (not shape or shape[-1] != self._n_agents)):
            raise ValueError(
                f"ControlledChannel moments were computed for n_agents="
                f"{self._n_agents} but sample() was asked for agent axis "
                f"{shape[-1] if shape else '(scalar)'}; rebuild with "
                "make_controlled_channel(..., n_agents=<runtime count>)")
        c = self.base.sample(generator, shape, device)
        return c * self.policy.apply(c)

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def var(self) -> float:
        return self._var


def _pack_controlled(channels) -> Dict[str, np.ndarray]:
    """Lane packer: the base's parameters under ``base.``, the policy's
    under ``pc.`` (the caller adds the ``_mean``/``_var`` columns)."""
    _, base_params = _channel.batched_channel_arrays(
        [ch.base for ch in channels])
    params = {f"base.{k}": v for k, v in base_params.items()}
    for f in dataclasses.fields(channels[0].policy):
        params[f"pc.{f.name}"] = np.array(
            [float(getattr(ch.policy, f.name)) for ch in channels],
            np.float64)
    return params


def _sample_controlled(kind, params, generators, shape, device):
    """Lane sampler: the base's lane draw, times the power of the policy
    rebuilt from the lanes' parameters (``(L, 1, ...)`` tensors, or shared
    Python floats) — ``ControlledChannel.sample``'s ops.  A per-agent
    policy packed per lane applies its lanes' budgets
    (:func:`_lane_budgets`)."""
    _, base_kind, policy_name = kind.split(":")
    nd = len(tuple(shape))
    base = {k[len("base."):]: v for k, v in params.items()
            if k.startswith("base.")}
    cls = _POLICY_REGISTRY[policy_name]
    pc = {k[len("pc."):]: _channel.lane_param(v, nd)
          for k, v in params.items() if k.startswith("pc.")}
    c = BatchedChannel(kind=base_kind, params=base).sample(generators, shape,
                                                           device)
    if cls.per_agent and any(isinstance(v, torch.Tensor)
                             for v in pc.values()):
        return c * _lane_budgets(cls, params, len(generators), c.shape[-1],
                                 device).apply(c)
    return c * cls(**pc).apply(c)


def _lane_budgets(cls, params, n_lanes: int, n_agents: int,
                  device) -> LaneBudgets:
    """The ``(L, N)`` budgets of a per-agent policy packed per lane: on the
    first draw each lane's policy is rebuilt from its Python parameters
    (one read of the ``(L,)`` columns) and :meth:`LaneBudgets.of` stacks
    their budgets; ``params`` keeps the table for every later draw of the
    run, so no round builds it or waits for the host."""
    key = f"_budgets.{n_agents}"
    if key not in params:
        cols = {k[len("pc."):]: (v.tolist() if isinstance(v, torch.Tensor)
                                 else [v] * n_lanes)
                for k, v in params.items() if k.startswith("pc.")}
        params[key] = LaneBudgets.of(
            [cls(**{k: float(v[i]) for k, v in cols.items()})
             for i in range(n_lanes)], n_agents, device)
    return params[key]


def estimate_moments(base: Channel, policy: PowerPolicy,
                     generator: torch.Generator, n: int = 200_000, *,
                     n_agents: Optional[int] = None) -> Tuple[float, float]:
    """Monte Carlo (m_h, sigma_h^2) of h = c * p(c) over ``n`` draws from
    ``generator`` (on the generator's device), float32 as in the JAX
    package.  Per-agent policies need ``n_agents``: the draws carry a
    trailing agent axis and the mixture moments are returned."""
    if policy.per_agent:
        if not n_agents:
            raise ValueError("per-agent policy moments need n_agents")
        shape = (max(1, n // n_agents), n_agents)
    else:
        shape = (n,)
    c = base.sample(generator, shape, generator.device)
    h = c * policy.apply(c)
    return float(torch.mean(h)), float(torch.var(h, unbiased=False))


def closed_form_moments(base: Channel, policy: PowerPolicy, *,
                        n_agents: Optional[int] = None
                        ) -> Optional[Tuple[float, float]]:
    """Exact effective moments when the (base, policy) pair has a closed
    form, else None."""
    return policy.closed_form_moments(base, n_agents)


def _fallback_generator() -> torch.Generator:
    """The documented Monte-Carlo seed: a CPU generator seeded with 0."""
    return torch.Generator().manual_seed(0)


@functools.lru_cache(maxsize=None)
def effective_moments(base: Channel, policy: PowerPolicy, *,
                      n_agents: Optional[int] = None,
                      n: int = 200_000) -> Tuple[float, float]:
    """Effective-gain (m_h, sigma_h^2): closed form if available, otherwise
    Monte Carlo from the fixed CPU generator (see the module docstring)."""
    closed = closed_form_moments(base, policy, n_agents=n_agents)
    if closed is not None:
        return closed
    return estimate_moments(base, policy, _fallback_generator(), n,
                            n_agents=n_agents)


def make_controlled_channel(base: Channel, policy: PowerPolicy,
                            generator: Optional[torch.Generator] = None,
                            n: int = 200_000, *,
                            n_agents: Optional[int] = None
                            ) -> ControlledChannel:
    """The ControlledChannel constructor: the effective (m_h, sigma_h^2) in
    closed form when available, else Monte Carlo from ``generator`` (default:
    the fixed CPU generator).  ``n_agents`` is required by per-agent
    policies."""
    closed = closed_form_moments(base, policy, n_agents=n_agents)
    if closed is not None:
        m, v = closed
    else:
        m, v = estimate_moments(base, policy,
                                generator or _fallback_generator(), n,
                                n_agents=n_agents)
    return ControlledChannel(base=base, policy=policy, _mean=m, _var=v,
                             _n_agents=n_agents if policy.per_agent else None)


def check_agent_count(channel: Channel, n_agents: int) -> None:
    """Refuse a ControlledChannel whose per-agent mixture moments were
    computed for another agent count than the run uses."""
    if (isinstance(channel, ControlledChannel)
            and channel._n_agents is not None
            and channel._n_agents != n_agents):
        raise ValueError(
            f"ControlledChannel moments were computed for n_agents="
            f"{channel._n_agents} but the run uses {n_agents} agents; "
            f"rebuild it with make_controlled_channel(..., "
            f"n_agents={n_agents})")


_channel.register_channel("controlled", ControlledChannel,
                          packer=_pack_controlled, sampler=_sample_controlled)
