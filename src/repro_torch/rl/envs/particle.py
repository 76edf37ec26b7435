"""Particle-family environments beyond the paper's landmark task.

Counterpart of ``repro/rl/envs/particle.py``.  ``WindyLandmarkNav`` adds a
constant wind drift along +x and Gaussian gusts to ``LandmarkNav``'s moves
(its step draws ``(*batch, 2)`` standard normals); ``MultiLandmarkNav``
takes the distance to the nearest of L landmarks as its loss.  Both keep
the paper's five discrete actions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.rl.env import (
    LandmarkNav, _col, displacement, normal_noise, uniform_noise,
)
from repro_torch.rl.envs.registry import register_env
from repro_torch.rl.policy import MLPPolicy


@dataclass(frozen=True)
class WindyLandmarkNav(LandmarkNav):
    """LandmarkNav with ``pos += move + (wind, 0) + gust_sigma * n``."""

    wind: float = 0.05
    gust_sigma: float = 0.02

    def step_noise(self, generator, shape, device) -> torch.Tensor:
        """The ``(*shape, 2)`` standard normals of the gust."""
        return normal_noise(generator, tuple(shape) + (2,), device)

    def step(self, state: torch.Tensor, action: torch.Tensor,
             noise: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if noise is None:
            raise ValueError("WindyLandmarkNav.step needs its gust draws "
                             "(step_noise)")
        pos = state[..., :2] + displacement(self.step_size, action)
        # + (wind, 0): the JAX package adds the drift vector, then the gust
        pos = torch.stack([pos[..., 0] + self.wind, pos[..., 1] + 0.0], -1)
        pos = pos + _col(self.gust_sigma) * noise
        nxt = torch.cat([pos, state[..., 2:]], dim=-1)
        return nxt, self.loss(nxt)

    def l_bar_for(self, horizon: int) -> float:
        """Envelope with the drift; the Gaussian gusts are unbounded, so
        this is the 3-sigma envelope (exact for ``gust_sigma=0``)."""
        per_step = self.step_size + abs(self.wind) + 3.0 * self.gust_sigma
        reach = self.arena + per_step * horizon
        return float(2.0 * reach * math.sqrt(2.0))


@dataclass(frozen=True)
class MultiLandmarkNav:
    """Nearest-of-L landmark covering: state ``(x, y, x_1, y_1, ...,
    x_L, y_L)``, loss ``min_j ||pos - landmark_j||``."""

    n_landmarks: int = 3
    arena: float = 1.0
    step_size: float = 0.1
    n_actions: int = 5

    @property
    def obs_dim(self) -> int:
        return 2 + 2 * self.n_landmarks

    def kind_tag(self) -> str:
        return f"multilandmark:{self.n_landmarks}"

    def reset(self, generator, shape, device,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        u = (uniform_noise(generator, tuple(shape) + (self.obs_dim,), device)
             if noise is None else noise)
        a = _col(self.arena)
        return u * (2.0 * a) - a

    def step_noise(self, generator, shape, device) -> None:
        return None

    def step(self, state: torch.Tensor, action: torch.Tensor,
             noise: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        pos = state[..., :2] + displacement(self.step_size, action)
        nxt = torch.cat([pos, state[..., 2:]], dim=-1)
        return nxt, self.loss(nxt)

    def loss(self, state: torch.Tensor) -> torch.Tensor:
        marks = state[..., 2:].reshape(state.shape[:-1]
                                       + (self.n_landmarks, 2))
        d = marks - state[..., None, :2]
        return torch.sqrt(torch.amin(torch.sum(d * d, dim=-1), dim=-1)
                          + 1e-12)

    def l_bar_for(self, horizon: int) -> float:
        reach = self.arena + self.step_size * horizon
        return float(2.0 * reach * math.sqrt(2.0))

    def default_policy(self) -> MLPPolicy:
        return MLPPolicy(obs_dim=self.obs_dim, hidden=16,
                         n_actions=self.n_actions)


register_env("windy", WindyLandmarkNav)
register_env("multilandmark", MultiLandmarkNav)
