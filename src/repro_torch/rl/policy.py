"""Policies: the paper's softmax MLP, a tabular softmax and a Gaussian.

Counterpart of ``repro/rl/policy.py`` over dicts of tensors with the JAX
layout (``w1`` is ``(obs_dim, hidden)``, not ``nn.Linear``'s transpose), so
weights carried across by ``repro_torch.interop`` need no reshuffle.
Observations may have any leading dims.

Every policy draws its sampling noise explicitly:
``sample_noise(generator, batch, device)`` makes the draw that
``sample(params, obs, generator, noise=None)`` consumes, so the
agent-streamed round can draw a whole round up front in the stacked
order and a test can inject the JAX package's draws.  The discrete
policies take ``(*batch, n_actions)`` uniforms and sample by Gumbel-max;
``GaussianPolicy`` takes ``(*batch, act_dim)`` standard normals and
returns float actions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.utils.tree import Params


def _uniforms(generator, batch, n: int, device) -> torch.Tensor:
    return torch.rand(tuple(batch) + (n,), generator=generator,
                      device=device, dtype=torch.float32)


def _gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Categorical draw ``argmax(logits + G)``, ``G = -log(-log(u))``."""
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _log_prob_of(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, action.unsqueeze(-1)).squeeze(-1)


@dataclass(frozen=True)
class MLPPolicy:
    """The paper's target policy (Section IV): 16 hidden ReLU units,
    softmax over the discrete actions."""

    obs_dim: int = 4
    hidden: int = 16
    n_actions: int = 5

    def init(self, generator: torch.Generator, device) -> Params:
        """``N(0, 1) / sqrt(fan_in)`` weights, zero biases (as the JAX init)."""
        def normal(shape):
            return torch.randn(shape, generator=generator, device=device,
                               dtype=torch.float32)

        f32 = dict(device=device, dtype=torch.float32)
        return {
            "w1": normal((self.obs_dim, self.hidden)) / self.obs_dim ** 0.5,
            "b1": torch.zeros(self.hidden, **f32),
            "w2": normal((self.hidden, self.n_actions)) / self.hidden ** 0.5,
            "b2": torch.zeros(self.n_actions, **f32),
        }

    def logits(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        h = torch.relu(obs @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]

    def log_prob(self, params: Params, obs: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
        return _log_prob_of(self.logits(params, obs), action)

    def sample_noise(self, generator: torch.Generator, batch, device
                     ) -> torch.Tensor:
        """The ``(*batch, n_actions)`` uniforms :meth:`sample` draws."""
        return _uniforms(generator, batch, self.n_actions, device)

    def sample(self, params: Params, obs: torch.Tensor,
               generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Categorical draw by Gumbel-max; ``noise`` replaces the uniforms."""
        logits = self.logits(params, obs)
        u = (self.sample_noise(generator, logits.shape[:-1], logits.device)
             if noise is None else noise)
        return _gumbel_argmax(logits, u)


@dataclass(frozen=True)
class TabularSoftmaxPolicy:
    """``theta[s, a]`` logits over one-hot states (pairs with
    ``TabularMDP`` and ``CliffWalk``)."""

    n_states: int
    n_actions: int

    def init(self, generator: torch.Generator, device) -> Params:
        return {"theta": 0.1 * torch.randn(
            (self.n_states, self.n_actions), generator=generator,
            device=device, dtype=torch.float32)}

    def logits(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        return obs @ params["theta"]

    def log_prob(self, params: Params, obs: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
        return _log_prob_of(self.logits(params, obs), action)

    def sample_noise(self, generator, batch, device) -> torch.Tensor:
        return _uniforms(generator, batch, self.n_actions, device)

    def sample(self, params: Params, obs: torch.Tensor,
               generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = self.logits(params, obs)
        u = (self.sample_noise(generator, logits.shape[:-1], logits.device)
             if noise is None else noise)
        return _gumbel_argmax(logits, u)

    def action_probs(self, params: Params) -> torch.Tensor:
        """The (S, A) table ``TabularMDP.exact_J`` takes."""
        return torch.softmax(params["theta"], dim=-1)


@dataclass(frozen=True)
class GaussianPolicy:
    """Diagonal Gaussian over continuous actions, ``a ~ N(obs W + b,
    e^{2 s})`` with a learnable log-std ``s`` (pairs with ``LQRTask``)."""

    obs_dim: int = 2
    act_dim: int = 2
    init_scale: float = 0.1

    def init(self, generator: torch.Generator, device) -> Params:
        f32 = dict(device=device, dtype=torch.float32)
        w = torch.randn((self.obs_dim, self.act_dim), generator=generator,
                        **f32)
        return {"w": self.init_scale * w / math.sqrt(float(self.obs_dim)),
                "b": torch.zeros(self.act_dim, **f32),
                "log_std": torch.zeros(self.act_dim, **f32)}

    def mean(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        return obs @ params["w"] + params["b"]

    def log_prob(self, params: Params, obs: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
        mu, log_std = self.mean(params, obs), params["log_std"]
        z = (action - mu) * torch.exp(-log_std)
        return (-0.5 * torch.sum(z * z, dim=-1) - torch.sum(log_std)
                - 0.5 * self.act_dim * math.log(2.0 * math.pi))

    def sample_noise(self, generator, batch, device) -> torch.Tensor:
        """The ``(*batch, act_dim)`` standard normals :meth:`sample` takes."""
        return torch.randn(tuple(batch) + (self.act_dim,),
                           generator=generator, device=device,
                           dtype=torch.float32)

    def sample(self, params: Params, obs: torch.Tensor,
               generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        eps = (self.sample_noise(generator, obs.shape[:-1], obs.device)
               if noise is None else noise)
        return self.mean(params, obs) + torch.exp(params["log_std"]) * eps
