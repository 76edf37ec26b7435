"""Garnet tabular MDPs.

Counterpart of ``repro/rl/envs/tabular.py``.  A Garnet MDP sends every
(s, a) pair to ``branching`` distinct next states with Dirichlet(1) weights:
a sparse kernel that is fully known, so ``TabularMDP.exact_J`` and its
autograd gradient anchor the estimators at any size.  The draws come from
an explicit ``torch.Generator`` (the JAX package's threefry stream cannot be
replayed; tests carry the JAX tables across with ``interop.env_from_jax``).
``TabularMDP``'s sweep-lane packer waits for the sweep slice.
"""
from __future__ import annotations

import torch

from repro_torch.rl.env import TabularMDP, uniform_noise
from repro_torch.rl.envs.registry import register_env


def _dirichlet1(generator, shape, device) -> torch.Tensor:
    """Dirichlet(1, ..., 1) over the last axis: normalised exponentials."""
    e = -torch.log1p(-uniform_noise(generator, shape, device))
    return e / torch.sum(e, dim=-1, keepdim=True)


def garnet(generator: torch.Generator, n_states: int = 8,
           n_actions: int = 4, branching: int = 3, gamma: float = 0.9,
           horizon: int = 5) -> TabularMDP:
    """A Garnet MDP on ``generator``'s device: each (s, a) reaches
    ``branching`` distinct next states with Dirichlet(1) weights; losses
    uniform in [0, 1); ``rho`` Dirichlet(1)."""
    if not 1 <= branching <= n_states:
        raise ValueError(
            f"branching must be in [1, n_states={n_states}], got {branching}")
    dev = generator.device
    rows = n_states * n_actions
    # `branching` distinct states per row: the first columns of a random
    # permutation (argsort of uniforms)
    idx = torch.argsort(uniform_noise(generator, (rows, n_states), dev),
                        dim=-1)[:, :branching]
    w = _dirichlet1(generator, (rows, branching), dev)
    P = torch.zeros((rows, n_states), dtype=torch.float32, device=dev)
    P.scatter_(1, idx, w)
    loss = uniform_noise(generator, (n_states, n_actions), dev)
    rho = _dirichlet1(generator, (n_states,), dev)
    return TabularMDP(P=P.reshape(n_states, n_actions, n_states), l=loss,
                      rho=rho, gamma=gamma, horizon=horizon)


register_env("tabular", TabularMDP)
