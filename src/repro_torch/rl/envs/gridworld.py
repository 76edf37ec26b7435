"""Finite grid worlds with one-hot observations.

Counterpart of ``repro/rl/envs/gridworld.py``: ``CliffWalk``, the Sutton &
Barto cliff walk in the paper's loss convention.  A W x H grid, start
bottom-left, goal bottom-right (absorbing, loss 0), a cliff along the bottom
edge between them (loss ``cliff_cost``, back to the start), every other
step ``step_cost``.  With probability ``slip`` the action is replaced by a
uniformly random one: the step draws ``(*batch, 2)`` values, a uniform and
the random action (as a float).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.rl.env import one_hot, uniform_noise
from repro_torch.rl.envs.registry import register_env
from repro_torch.rl.policy import TabularSoftmaxPolicy

_MOVES = ((0, 1), (0, -1), (-1, 0), (1, 0))   # up, down, left, right


@functools.lru_cache(maxsize=8)
def _moves(device: torch.device) -> torch.Tensor:
    return torch.tensor(_MOVES, dtype=torch.int64, device=device)


@dataclass(frozen=True)
class CliffWalk:
    """W x H cliff-walk grid; cells are indexed ``s = y * width + x``."""

    width: int = 6
    height: int = 4
    slip: float = 0.05
    cliff_cost: float = 1.0
    step_cost: float = 0.1
    n_actions: int = 4

    @property
    def obs_dim(self) -> int:
        return self.width * self.height

    @property
    def start_state(self) -> int:
        return 0                   # (0, 0), bottom-left

    @property
    def goal_state(self) -> int:
        return self.width - 1      # (W-1, 0), bottom-right

    def kind_tag(self) -> str:
        return f"cliffwalk:{self.width}x{self.height}"

    def reset(self, generator, shape, device, noise=None) -> torch.Tensor:
        """The deterministic start, one-hot (no draw)."""
        s = torch.full(tuple(shape), self.start_state, dtype=torch.int64,
                       device=device)
        return one_hot(s, self.obs_dim)

    def step_noise(self, generator, shape, device) -> torch.Tensor:
        """``(*shape, 2)``: the slip uniform, then the random action."""
        u = uniform_noise(generator, shape, device)
        rand_a = torch.randint(0, self.n_actions, tuple(shape),
                               generator=generator, device=device)
        return torch.stack([u, rand_a.float()], dim=-1)

    def step(self, state: torch.Tensor, action: torch.Tensor,
             noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        s = torch.argmax(state, dim=-1)
        a = torch.where(noise[..., 0] < self.slip, noise[..., 1].long(),
                        action)
        moves = _moves(s.device)[a]
        x, y = s % self.width, s // self.width
        x2 = torch.clamp(x + moves[..., 0], 0, self.width - 1)
        y2 = torch.clamp(y + moves[..., 1], 0, self.height - 1)
        nxt = y2 * self.width + x2
        in_cliff = (y2 == 0) & (x2 > 0) & (x2 < self.width - 1)
        at_goal = s == self.goal_state
        nxt = torch.where(at_goal, s, torch.where(
            in_cliff, torch.full_like(nxt, self.start_state), nxt))
        inner = torch.where(in_cliff, self.cliff_cost, self.step_cost)
        loss = torch.where(at_goal, torch.zeros_like(inner),
                           inner.to(torch.float32))
        return one_hot(nxt, self.obs_dim), loss

    def l_bar_for(self, horizon: int) -> float:
        return float(max(self.cliff_cost, self.step_cost))

    @property
    def l_bar(self) -> float:
        return self.l_bar_for(0)

    def default_policy(self) -> TabularSoftmaxPolicy:
        return TabularSoftmaxPolicy(self.obs_dim, self.n_actions)


register_env("cliffwalk", CliffWalk)
