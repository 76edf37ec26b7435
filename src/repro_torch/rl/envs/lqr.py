"""Linear-quadratic regulation as a policy-gradient task.

Counterpart of ``repro/rl/envs/lqr.py``:

    s' = A s + gain * a + process_sigma * w,   w ~ N(0, I)
    l(s, a) = q_cost * ||s||^2 + r_cost * ||a||^2

with ``A = drift * I + coupling * (upper - lower shift)``.  Continuous
actions: it pairs with ``GaussianPolicy``.  The quadratic loss is
unbounded, so Assumption 1 and the theory tables do not apply to it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.rl.env import _col, normal_noise
from repro_torch.rl.envs.registry import register_env
from repro_torch.rl.policy import GaussianPolicy


@dataclass(frozen=True)
class LQRTask:
    """d-dimensional LQR with isotropic process noise."""

    dim: int = 2
    drift: float = 0.9
    coupling: float = 0.1
    gain: float = 0.5
    process_sigma: float = 0.05
    q_cost: float = 1.0
    r_cost: float = 0.1
    init_scale: float = 1.0

    @property
    def obs_dim(self) -> int:
        return self.dim

    @property
    def act_dim(self) -> int:
        return self.dim

    def kind_tag(self) -> str:
        return f"lqr:{self.dim}"

    def A(self, device) -> torch.Tensor:
        """``(d, d)``, or ``(n, 1, d, d)`` for per-agent lanes."""
        eye = torch.eye(self.dim, dtype=torch.float32, device=device)
        skew = (torch.diag(torch.ones(self.dim - 1, device=device), 1)
                - torch.diag(torch.ones(self.dim - 1, device=device), -1))
        return _col(_col(self.drift)) * eye + _col(_col(self.coupling)) * skew

    def reset(self, generator, shape, device,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = (normal_noise(generator, tuple(shape) + (self.dim,), device)
             if noise is None else noise)
        return _col(self.init_scale) * w

    def step_noise(self, generator, shape, device) -> torch.Tensor:
        """The ``(*shape, dim)`` standard normals of the process noise."""
        return normal_noise(generator, tuple(shape) + (self.dim,), device)

    def step(self, state: torch.Tensor, action: torch.Tensor,
             noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        drive = torch.matmul(self.A(state.device),
                             state.unsqueeze(-1)).squeeze(-1)
        nxt = (drive + _col(self.gain) * action
               + _col(self.process_sigma) * noise)
        loss = (self.q_cost * torch.sum(state * state, dim=-1)
                + self.r_cost * torch.sum(action * action, dim=-1))
        return nxt, loss

    def default_policy(self) -> GaussianPolicy:
        return GaussianPolicy(obs_dim=self.dim, act_dim=self.act_dim)


register_env("lqr", LQRTask)
