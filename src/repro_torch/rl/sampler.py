"""Batched trajectory sampling: all N x M trajectories in one loop over time.

Counterpart of ``repro/rl/sampler.py``.  The JAX version vmaps ``rollout``
over trajectories and the round vmaps once more over agents; here the batch
shape ``(N, M)`` is a leading dimension of every tensor and ``lax.scan`` is a
Python loop over the T+1 steps (t = 0..T inclusive, as the paper's objective
sums).  Each step draws the policy's noise, then the environment's (none for
deterministic dynamics), from the one generator, in that order.  Every draw
may be injected: ``s0`` and ``actions`` replay the JAX package's own draws
(the test hook, as ``gains=`` is for the uplink); ``policy_noise`` and
``env_noise`` hand the steps draws made up front (the agent-streamed round
draws the whole fleet's in the stacked order and gives each block its
slice).

The policies compute in a fixed order (``rl/policy.py``), so a
trajectory's actions do not depend on how many trajectories share the
step.  ``params`` may hold one run's parameters, or a lane-batched run's
with leading ``(L, 1, ...)`` dims over an ``(L, ...)`` batch.

The per-round metrics reduce in a fixed order (``utils.tree.fixed_sum``),
the same for a run alone and as one lane of many.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.utils.tree import fixed_mean, theta_device


class Trajectory(NamedTuple):
    """Rollouts with the time axis after the batch dims."""

    obs: torch.Tensor      # (*batch, T+1, obs_dim) — state the action was taken in
    actions: torch.Tensor  # (*batch, T+1) int64; (*batch, T+1, act_dim) float
    losses: torch.Tensor   # (*batch, T+1) l(s_t, a_t)

    @property
    def horizon(self) -> int:
        return self.obs.shape[-2] - 1


def rollout_batch(env, policy, params, generator: Optional[torch.Generator],
                  horizon: int, batch: Tuple[int, ...], *,
                  s0: Optional[torch.Tensor] = None,
                  actions: Optional[torch.Tensor] = None,
                  policy_noise: Optional[torch.Tensor] = None,
                  env_noise: Optional[torch.Tensor] = None) -> Trajectory:
    """Sample ``s_0 ~ rho`` then T+1 policy steps for every trajectory of
    the ``batch`` shape.  ``s0`` and ``actions`` (``(*batch, T+1[,
    act_dim])``) replay those draws instead of sampling them;
    ``policy_noise`` and ``env_noise`` (``(T+1, *batch, ...)``) hand step
    ``t`` its draws."""
    device = theta_device(params)
    batch = tuple(batch)
    t_axis = len(batch)
    state = env.reset(generator, batch, device) if s0 is None else s0
    obs, acts, losses = [], [], []
    for t in range(horizon + 1):
        if actions is None:
            a = policy.sample(params, state, generator,
                              None if policy_noise is None else policy_noise[t])
        else:
            a = actions.select(t_axis, t)
        noise = (env.step_noise(generator, batch, device) if env_noise is None
                 else env_noise[t])
        nxt, loss = env.step(state, a, noise)
        obs.append(state)
        acts.append(a)
        losses.append(loss)
        state = nxt
    return Trajectory(obs=torch.stack(obs, dim=t_axis),
                      actions=torch.stack(acts, dim=t_axis),
                      losses=torch.stack(losses, dim=t_axis))


def discounted_return(losses: torch.Tensor, gamma: float) -> torch.Tensor:
    """sum_t gamma^t l_t along the last axis."""
    t = torch.arange(losses.shape[-1], dtype=torch.float32,
                     device=losses.device)
    return torch.sum(losses * gamma ** t, dim=-1)


def empirical_reward(traj: Trajectory, gamma: float,
                     n_batch_dims: Optional[int] = None) -> torch.Tensor:
    """The paper's 'empirical cumulative reward': minus the discounted loss,
    averaged over the last ``n_batch_dims`` batch dims (all of them by
    default; a lane-batched run keeps its lane axis)."""
    ret = discounted_return(traj.losses, gamma)
    return -fixed_mean(ret, ret.ndim if n_batch_dims is None
                       else n_batch_dims)
