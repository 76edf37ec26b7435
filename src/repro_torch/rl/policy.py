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

Products and sums over features use ``utils.tree.fixed_matmul`` /
``fixed_sum`` (elementwise ops in a fixed order), so an action or a
log-probability has the same bits whatever batch it is computed in, and
whether the parameters are shared or one set per lane: ``params`` leaves
may carry leading lane dims that broadcast against ``obs``'s batch (a
lane-batched run passes ``(L, 1, 1, ...)`` leaves over ``(L, N, M)``).

Every policy provides ``grad_log_prob(params, obs, action)``: each row's
``grad_theta log pi(a | s)`` in closed form, flat in sorted-key order
(``(..., P)``), the per-step terms of G(PO)MDP (``core/gpomdp.py``).  It
uses the same fixed-order ops, so an agent's estimate does not depend on
what else is computed with it, and equals autograd's gradient of
:meth:`log_prob` up to rounding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.utils.tree import Params, fixed_matmul, fixed_sum


def _uniforms(generator, batch, n: int, device) -> torch.Tensor:
    return torch.rand(tuple(batch) + (n,), generator=generator,
                      device=device, dtype=torch.float32)


def _gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Categorical draw ``argmax(logits + G)``, ``G = -log(-log(u))``."""
    tiny = torch.finfo(logits.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def _dlogits(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``d log softmax(logits)[a] / d logits = onehot(a) - softmax``; the
    softmax's sum in the fixed order of ``fixed_sum`` (a max is exact in
    any order)."""
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    p = e / fixed_sum(e, -1).unsqueeze(-1)
    return torch.nn.functional.one_hot(action, logits.shape[-1]).to(
        p.dtype) - p


def _outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row-wise outer products, flat: ``(..., I), (..., J) -> (..., I*J)``
    (row-major, the layout of an ``(I, J)`` leaf)."""
    return (x.unsqueeze(-1) * y.unsqueeze(-2)).flatten(-2)


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
        h = torch.relu(fixed_matmul(obs, params["w1"]) + params["b1"])
        return fixed_matmul(h, params["w2"]) + params["b2"]

    def log_prob(self, params: Params, obs: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
        return _log_prob_of(self.logits(params, obs), action)

    def grad_log_prob(self, params: Params, obs: torch.Tensor,
                      action: torch.Tensor) -> torch.Tensor:
        """``(..., P)``: the flat ``(b1, b2, w1, w2)`` gradient of each
        row's log-probability (back-propagation written out)."""
        pre = fixed_matmul(obs, params["w1"]) + params["b1"]
        h = torch.relu(pre)
        dl = _dlogits(fixed_matmul(h, params["w2"]) + params["b2"], action)
        dh = fixed_matmul(dl, params["w2"].transpose(-1, -2))
        dpre = torch.where(pre > 0, dh, torch.zeros_like(dh))
        return torch.cat([dpre, dl, _outer(obs, dpre), _outer(h, dl)], -1)

    def entropy(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        """The action distribution's entropy summed over every row of
        ``obs`` (one scalar, as the JAX package's ``jnp.sum`` over all
        axes)."""
        logp = torch.log_softmax(self.logits(params, obs), dim=-1)
        return -torch.sum(torch.exp(logp) * logp)

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
        return fixed_matmul(obs, params["theta"])

    def log_prob(self, params: Params, obs: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
        return _log_prob_of(self.logits(params, obs), action)

    def grad_log_prob(self, params: Params, obs: torch.Tensor,
                      action: torch.Tensor) -> torch.Tensor:
        """``(..., S*A)``: the flat ``theta`` gradient of each row."""
        return _outer(obs, _dlogits(self.logits(params, obs), action))

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
        return fixed_matmul(obs, params["w"]) + params["b"]

    def log_prob(self, params: Params, obs: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
        mu, log_std = self.mean(params, obs), params["log_std"]
        z = (action - mu) * torch.exp(-log_std)
        return (-0.5 * fixed_sum(z * z, -1) - fixed_sum(log_std, -1)
                - 0.5 * self.act_dim * math.log(2.0 * math.pi))

    def grad_log_prob(self, params: Params, obs: torch.Tensor,
                      action: torch.Tensor) -> torch.Tensor:
        """``(..., P)``: the flat ``(b, log_std, w)`` gradient of each row:
        ``d/dmu = z e^{-s}``, ``d/ds = z^2 - 1`` with ``z = (a - mu)
        e^{-s}``."""
        inv = torch.exp(-params["log_std"])
        z = (action - self.mean(params, obs)) * inv
        dmu = z * inv
        return torch.cat([dmu, z * z - 1.0, _outer(obs, dmu)], -1)

    def entropy(self, params: Params, obs: torch.Tensor) -> torch.Tensor:
        """Closed form ``sum(log_std) + (d/2)(1 + log 2 pi)``; ``obs`` is
        not read (kept for the interface, as in the JAX package)."""
        del obs
        return torch.sum(params["log_std"]) + 0.5 * self.act_dim * (
            1.0 + math.log(2.0 * math.pi))

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
