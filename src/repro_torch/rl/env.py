"""The paper's LandmarkNav particle task and the known-model TabularMDP,
batched over any leading dims.

Counterpart of ``repro/rl/env.py``.  Every method takes tensors with
arbitrary leading dims (agents, trajectories) in place of the JAX
version's ``vmap``.  Randomness is explicit: ``reset(generator, batch,
device, noise=None)`` and ``step_noise(generator, batch, device)`` draw
from a ``torch.Generator`` (``step_noise`` returns None for deterministic
dynamics), and ``step(state, action, noise)`` consumes the draw.  The draws
are standard ones (uniforms, normals, Gumbels), so a test can inject the
JAX package's own (``jax.random.uniform`` / ``normal`` / ``gumbel`` of the
same key) and get the same states.

A float field may hold a tensor of shape ``(n, 1)``: the per-agent lanes of
a ``HeterogeneousEnv`` over an ``(n, M)`` batch (``rl/envs/heterogeneous.py``);
``_col`` broadcasts it against a trailing feature axis.

``LandmarkNav``: the agent and a landmark live in the plane, state ``s =
(x, y, x_landmark, y_landmark)``, five discrete actions {stay, left, right,
up, down}, and the per-step loss is the Euclidean distance to the landmark,
taken on the *post-move* state.  ``TabularMDP``: a finite MDP with known
kernel ``P`` (S, A, S), losses ``l`` (S, A) and start ``rho`` (S,), whose
exact objective :meth:`TabularMDP.exact_J` gives the exact policy gradient
by autograd.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.rl.policy import MLPPolicy, TabularSoftmaxPolicy

_MOVES = ((0.0, 0.0), (-1.0, 0.0), (1.0, 0.0), (0.0, 1.0), (0.0, -1.0))


@functools.lru_cache(maxsize=16)
def _moves(step_size: float, device: torch.device) -> torch.Tensor:
    """The displacement table, built once per device: a copy from the host
    on every step would stall a CUDA rollout."""
    return torch.tensor(_MOVES, dtype=torch.float32, device=device) * step_size


def _col(x):
    """A field as a factor of a ``(*batch, k)`` tensor: a lane tensor
    ``(n, 1)`` gains a trailing axis; a Python number stays as it is."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def displacement(step_size, action: torch.Tensor) -> torch.Tensor:
    """``moves[action]``, the five-action table scaled by ``step_size``
    (a float, or per-agent lanes)."""
    if isinstance(step_size, torch.Tensor):
        return _moves(1.0, action.device)[action] * _col(step_size)
    return _moves(step_size, action.device)[action]


def uniform_noise(generator, shape, device) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator, device=device,
                      dtype=torch.float32)


def normal_noise(generator, shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=torch.float32)


def gumbel_noise(generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u clamped to float32's
    tiny, as ``jax.random.gumbel`` draws them."""
    u = uniform_noise(generator, shape, device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(index, n).float()


@dataclass(frozen=True)
class LandmarkNav:
    arena: float = 1.0       # initial positions uniform in [-arena, arena]^2
    step_size: float = 0.1
    n_actions: int = 5       # stay, left, right, up, down
    obs_dim: int = 4

    def reset(self, generator: torch.Generator, shape: Tuple[int, ...],
              device, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(*shape, obs_dim) initial states, uniform in [-arena, arena];
        ``noise`` replaces the uniforms in [0, 1)."""
        u = (uniform_noise(generator, tuple(shape) + (self.obs_dim,), device)
             if noise is None else noise)
        a = _col(self.arena)
        return u * (2.0 * a) - a

    def step_noise(self, generator, shape, device) -> None:
        """Deterministic dynamics: no draw."""
        return None

    def step(self, state: torch.Tensor, action: torch.Tensor,
             noise: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic move; returns (next_state, loss(next_state))."""
        pos = state[..., :2] + displacement(self.step_size, action)
        nxt = torch.cat([pos, state[..., 2:]], dim=-1)
        return nxt, self.loss(nxt)

    def loss(self, state: torch.Tensor) -> torch.Tensor:
        """Distance to the landmark, ``sqrt(sum d^2 + 1e-12)``."""
        d = state[..., :2] - state[..., 2:]
        return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)

    def l_bar_for(self, horizon: int) -> float:
        """Loss envelope of Assumption 1 at the configured horizon: positions
        start in [-a, a]^2 and drift up to ``step_size * T`` further, so the
        worst distance to the landmark is the diagonal of
        [-(a + step_size*T), a + step_size*T]^2 (theory tables only)."""
        reach = self.arena + self.step_size * horizon
        return float(2.0 * reach * math.sqrt(2.0))

    @property
    def l_bar(self) -> float:
        """The fixed-horizon envelope ``l_bar_for(20)`` (the paper's T=20);
        other horizons must use :meth:`l_bar_for`."""
        return self.l_bar_for(20)

    def default_policy(self) -> MLPPolicy:
        """The paper's target policy for this task (registry hook)."""
        return MLPPolicy(obs_dim=self.obs_dim, hidden=16,
                         n_actions=self.n_actions)


def lookup(table: torch.Tensor, s: torch.Tensor, a: torch.Tensor,
           rest: int) -> torch.Tensor:
    """``table[s, a]`` for batched indices ``s``, ``a`` (shape ``batch``):
    ``table`` is ``(S, A, *R)`` with ``len(R) == rest``, or per-agent lanes
    ``(n, 1, S, A, *R)`` broadcasting over a batch ``(n, M)``."""
    batch = tuple(s.shape)
    n_s, n_a = table.shape[-2 - rest], table.shape[-1 - rest]
    tail = tuple(table.shape[table.ndim - rest:])
    flat = table.reshape(tuple(table.shape[:table.ndim - 2 - rest])
                         + (n_s * n_a,) + tail)
    flat = flat.expand(batch + (n_s * n_a,) + tail)
    idx = (s * n_a + a).reshape(batch + (1,) * (1 + rest))
    idx = idx.expand(batch + (1,) + tail)
    return torch.gather(flat, len(batch), idx).squeeze(len(batch))


@dataclass(frozen=True, eq=False)
class TabularMDP:
    """Finite MDP with a known model: ``P`` (S, A, S), ``l`` (S, A) in
    [0, l_bar], ``rho`` (S,), float32 tensors on the run's device
    (:meth:`to`).  One-hot observations."""

    P: torch.Tensor
    l: torch.Tensor
    rho: torch.Tensor
    gamma: float
    horizon: int

    @property
    def n_states(self) -> int:
        return self.P.shape[-3]

    @property
    def n_actions(self) -> int:
        return self.P.shape[-2]

    @property
    def obs_dim(self) -> int:
        return self.n_states

    def kind_tag(self) -> str:
        return f"tabular:{self.n_states}x{self.n_actions}"

    def default_policy(self) -> TabularSoftmaxPolicy:
        return TabularSoftmaxPolicy(self.n_states, self.n_actions)

    def l_bar_for(self, horizon: int) -> float:
        """The largest loss of the table (horizon-independent)."""
        return float(torch.max(self.l))

    @property
    def l_bar(self) -> float:
        return self.l_bar_for(0)

    def to(self, device) -> "TabularMDP":
        return dataclasses.replace(self, P=self.P.to(device),
                                   l=self.l.to(device),
                                   rho=self.rho.to(device))

    @staticmethod
    def random(generator: torch.Generator, n_states: int = 4,
               n_actions: int = 3, gamma: float = 0.9,
               horizon: int = 5) -> "TabularMDP":
        """A random dense MDP, drawn from ``generator`` (on its device)."""
        dev = generator.device
        logits = normal_noise(generator, (n_states, n_actions, n_states), dev)
        P = torch.softmax(2.0 * logits, dim=-1)
        loss = uniform_noise(generator, (n_states, n_actions), dev)
        rho = torch.softmax(normal_noise(generator, (n_states,), dev), dim=-1)
        return TabularMDP(P=P, l=loss, rho=rho, gamma=gamma, horizon=horizon)

    def reset(self, generator, shape, device,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One-hot ``s_0 ~ rho`` by Gumbel-max; ``noise`` replaces the
        ``(*shape, S)`` Gumbel draws."""
        g = (gumbel_noise(generator, tuple(shape) + (self.n_states,), device)
             if noise is None else noise)
        s = torch.argmax(torch.log(self.rho + 1e-30) + g, dim=-1)
        return one_hot(s, self.n_states)

    def step_noise(self, generator, shape, device) -> torch.Tensor:
        """The ``(*shape, S)`` Gumbel draws of the next state."""
        return gumbel_noise(generator, tuple(shape) + (self.n_states,),
                            device)

    def step(self, state: torch.Tensor, action: torch.Tensor,
             noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        s = torch.argmax(state, dim=-1)
        loss = lookup(self.l, s, action, 0)
        probs = lookup(self.P, s, action, 1)
        nxt = torch.argmax(torch.log(probs + 1e-30) + noise, dim=-1)
        return one_hot(nxt, self.n_states), loss

    def exact_J(self, policy_probs: torch.Tensor) -> torch.Tensor:
        """Exact ``J = E[sum_{t=0}^{T} gamma^t l(s_t, a_t)]`` under the
        ``(S, A)`` table ``policy_probs``, by propagating the state
        distribution (the JAX ``lax.scan`` as a loop).  Differentiable:
        autograd through a softmax parameterisation gives the exact
        policy gradient the G(PO)MDP estimate must match in expectation."""
        d = self.rho
        acc = torch.zeros((), dtype=torch.float32, device=d.device)
        disc = torch.ones((), dtype=torch.float32, device=d.device)
        for _ in range(self.horizon + 1):
            acc = acc + disc * torch.sum(d[:, None] * policy_probs * self.l)
            d = torch.einsum("s,sa,sat->t", d, policy_probs, self.P)
            disc = disc * self.gamma
        return acc
