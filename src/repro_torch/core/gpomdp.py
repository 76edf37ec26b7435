"""Policy-gradient estimators: REINFORCE and mini-batch G(PO)MDP (Eq. 4).

Counterpart of ``repro/core/gpomdp.py``.  Both estimators are surrogate
losses whose gradient is the estimator; the gradient comes from
``torch.func.grad`` as ``jax.grad`` gives it in the JAX package.
:func:`per_agent_gradients` writes the agent ``vmap`` of the round as
``torch.func.vmap`` over the leading agent axis of the trajectories, with
theta shared, and returns an (N, ...) stack of gradient dicts.
"""
from __future__ import annotations

import torch
from torch.func import grad, vmap

from repro_torch.rl.sampler import Trajectory
from repro_torch.utils.tree import Params


def discounted_to_go(losses: torch.Tensor, gamma: float) -> torch.Tensor:
    """w_tau = sum_{t>=tau} gamma^t l_t — absolute ``gamma^t``, NOT
    ``gamma^(t - tau)``, as the paper's Eq. (4) keeps it.  Last axis."""
    t = torch.arange(losses.shape[-1], dtype=torch.float32,
                     device=losses.device)
    disc = losses * gamma ** t
    return torch.flip(torch.cumsum(torch.flip(disc, [-1]), -1), [-1])


def total_discounted(losses: torch.Tensor, gamma: float) -> torch.Tensor:
    t = torch.arange(losses.shape[-1], dtype=torch.float32,
                     device=losses.device)
    return torch.sum(losses * gamma ** t, dim=-1)


def gpomdp_surrogate(policy, params: Params, traj: Trajectory,
                     gamma: float) -> torch.Tensor:
    """Scalar whose gradient is the mini-batch G(PO)MDP estimate; averages
    over every leading batch dim of ``traj`` (the 1/M of Eq. 4)."""
    logps = policy.log_prob(params, traj.obs, traj.actions)
    to_go = discounted_to_go(traj.losses, gamma).detach()
    return torch.mean(torch.sum(logps * to_go, dim=-1))


def reinforce_surrogate(policy, params: Params, traj: Trajectory,
                        gamma: float) -> torch.Tensor:
    """REINFORCE: every log-prob weighted by the full discounted return."""
    logps = policy.log_prob(params, traj.obs, traj.actions)
    ret = total_discounted(traj.losses, gamma).detach()
    return torch.mean(torch.sum(logps, dim=-1) * ret)


def gpomdp_gradient(policy, params: Params, traj: Trajectory,
                    gamma: float) -> Params:
    """The G(PO)MDP estimate of one agent: grad of the surrogate."""
    return grad(lambda p: gpomdp_surrogate(policy, p, traj, gamma))(params)


def reinforce_gradient(policy, params: Params, traj: Trajectory,
                       gamma: float) -> Params:
    return grad(lambda p: reinforce_surrogate(policy, p, traj, gamma))(params)


ESTIMATORS = {"gpomdp": gpomdp_gradient, "reinforce": reinforce_gradient}


def per_agent_gradients(policy, params: Params, trajs: Trajectory,
                        gamma: float, estimator: str = "gpomdp") -> Params:
    """One estimate per agent from ``(N, M, T+1, ...)`` trajectories:
    a dict of ``(N, ...)`` gradient stacks."""
    try:
        fn = ESTIMATORS[estimator]
    except KeyError as e:
        raise ValueError(f"unknown estimator {estimator!r}") from e
    return vmap(lambda tr: fn(policy, params, tr, gamma))(trajs)
