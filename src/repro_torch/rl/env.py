"""The paper's LandmarkNav particle task, batched over any leading dims.

Counterpart of ``repro/rl/env.py::LandmarkNav``: the agent and a landmark
live in the plane, state ``s = (x, y, x_landmark, y_landmark)``, five
discrete actions {stay, left, right, up, down}, and the per-step loss is the
Euclidean distance to the landmark, taken on the *post-move* state.  Every
method takes tensors with arbitrary leading dims (agents, trajectories) in
place of the JAX version's ``vmap``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import torch

_MOVES = ((0.0, 0.0), (-1.0, 0.0), (1.0, 0.0), (0.0, 1.0), (0.0, -1.0))


@functools.lru_cache(maxsize=16)
def _moves(step_size: float, device: torch.device) -> torch.Tensor:
    """The displacement table, built once per device: a copy from the host
    on every step would stall a CUDA rollout."""
    return torch.tensor(_MOVES, dtype=torch.float32, device=device) * step_size


@dataclass(frozen=True)
class LandmarkNav:
    arena: float = 1.0       # initial positions uniform in [-arena, arena]^2
    step_size: float = 0.1
    n_actions: int = 5       # stay, left, right, up, down
    obs_dim: int = 4

    def moves(self, device) -> torch.Tensor:
        """(n_actions, 2) displacement table, float32 as in the JAX env."""
        return _moves(self.step_size, torch.device(device))

    def reset(self, generator: torch.Generator, shape: Tuple[int, ...],
              device) -> torch.Tensor:
        """(*shape, 4) initial states, uniform in [-arena, arena]."""
        u = torch.rand(tuple(shape) + (4,), generator=generator,
                       device=device, dtype=torch.float32)
        return u * (2.0 * self.arena) - self.arena

    def step(self, state: torch.Tensor,
             action: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic move; returns (next_state, loss(next_state))."""
        pos = state[..., :2] + self.moves(state.device)[action]
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
