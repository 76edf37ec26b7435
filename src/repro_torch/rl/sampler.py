"""Batched trajectory sampling: all N x M trajectories in one loop over time.

Counterpart of ``repro/rl/sampler.py``.  The JAX version vmaps ``rollout``
over trajectories and the round vmaps once more over agents; here the batch
shape ``(N, M)`` is a leading dimension of every tensor and ``lax.scan`` is a
Python loop over the T+1 steps (t = 0..T inclusive, as the paper's objective
sums).  ``s0`` and ``actions`` may be injected: the test hook that replays the
JAX package's own draws, as ``gains=`` does for the uplink.  ``uniforms``
injects the policy's sampling uniforms: the agent-streamed round draws them
for the whole fleet up front and hands each block its slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.utils.tree import theta_device


class Trajectory(NamedTuple):
    """Rollouts with the time axis after the batch dims."""

    obs: torch.Tensor      # (*batch, T+1, obs_dim) — state the action was taken in
    actions: torch.Tensor  # (*batch, T+1) int64
    losses: torch.Tensor   # (*batch, T+1) l(s_t, a_t) on the post-move state

    @property
    def horizon(self) -> int:
        return self.obs.shape[-2] - 1


def rollout_batch(env, policy, params, generator: Optional[torch.Generator],
                  horizon: int, batch: Tuple[int, ...], *,
                  s0: Optional[torch.Tensor] = None,
                  actions: Optional[torch.Tensor] = None,
                  uniforms: Optional[torch.Tensor] = None) -> Trajectory:
    """Sample ``s_0 ~ rho`` then T+1 policy steps for every trajectory of
    the ``batch`` shape.  With ``s0`` and/or ``actions`` given, those draws
    are replayed instead of sampled (``actions`` is ``(*batch, T+1)``);
    ``uniforms`` (``(T+1, *batch, n_actions)``) hands the policy the
    uniforms of its step-``t`` draw instead of drawing them."""
    device = theta_device(params)
    batch = tuple(batch)
    state = env.reset(generator, batch, device) if s0 is None else s0
    obs, acts, losses = [], [], []
    for t in range(horizon + 1):
        if actions is None:
            a = policy.sample(params, state, generator,
                              None if uniforms is None else uniforms[t])
        else:
            a = actions[..., t]
        nxt, loss = env.step(state, a)
        obs.append(state)
        acts.append(a)
        losses.append(loss)
        state = nxt
    return Trajectory(obs=torch.stack(obs, dim=-2),
                      actions=torch.stack(acts, dim=-1),
                      losses=torch.stack(losses, dim=-1))


def discounted_return(losses: torch.Tensor, gamma: float) -> torch.Tensor:
    """sum_t gamma^t l_t along the last axis."""
    t = torch.arange(losses.shape[-1], dtype=torch.float32,
                     device=losses.device)
    return torch.sum(losses * gamma ** t, dim=-1)


def empirical_reward(traj: Trajectory, gamma: float) -> torch.Tensor:
    """The paper's 'empirical cumulative reward': minus the discounted loss,
    averaged over every batch dim."""
    return -torch.mean(discounted_return(traj.losses, gamma))
