"""Policy-gradient estimators: REINFORCE and mini-batch G(PO)MDP (Eq. 4).

Counterpart of ``repro/core/gpomdp.py``.  Both estimators are weighted sums
of log-policy gradients over the M x (T+1) steps of an agent's batch:

    G(PO)MDP:   (1/M) sum_m sum_t  w_{m,t} grad log pi(a_t | s_t),
                w_{m,t} = sum_{t'>=t} gamma^t' l_t'   (absolute discount);
    REINFORCE:  (1/M) sum_m sum_t  R_m     grad log pi(a_t | s_t).

The JAX package takes ``jax.grad`` of the surrogate loss.  Here each step's
``grad log pi`` comes in closed form from the policy (``grad_log_prob``,
elementwise ops in a fixed order, ``rl/policy.py``) for the whole batch at
once, is scaled by its weight ``w / M``, and the steps are summed by a
fixed pairwise tree of elementwise adds (``utils.tree.fixed_sum``).  The
reason is batch invariance: an agent's estimate must be the same bits
whatever else is computed with it — a block of agents (``agent_blocks``)
or the other lanes of a lane-batched Monte-Carlo run.  On the card cuBLAS
picks its algorithm by the shape of the call, so a sum over steps inside a
batched matrix product changes its last bits with the number of agents,
and so does a per-step product: measured on an H100, the
back-propagation through the output layer (a (rows, 5) x (5, 16) product)
gave other bits for 210, 630 and 840 rows than for 2100.  No op here has
a shape-dependent order.  ``grad_log_prob`` is part of the policy
interface (``rl/policy.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.rl.sampler import Trajectory
from repro_torch.utils.tree import Params, fixed_sum


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


def gpomdp_weights(losses: torch.Tensor, gamma: float) -> torch.Tensor:
    """(..., M, T+1) per-step weights of G(PO)MDP: the reward-to-go."""
    return discounted_to_go(losses, gamma)


def reinforce_weights(losses: torch.Tensor, gamma: float) -> torch.Tensor:
    """(..., M, T+1) per-step weights of REINFORCE: the full return."""
    ret = total_discounted(losses, gamma)
    return ret.unsqueeze(-1).expand(losses.shape)


ESTIMATORS = {"gpomdp": gpomdp_weights, "reinforce": reinforce_weights}


def log_prob_grads(policy, params, obs: torch.Tensor,
                   actions: torch.Tensor) -> torch.Tensor:
    """``(rows, P)``: each row's ``grad log pi(a | s)``, flat in sorted-key
    order (the policy's closed form)."""
    return policy.grad_log_prob(params, obs, actions)


def estimate_flat(policy, params: Params, traj: Trajectory, gamma: float,
                  estimator: str) -> torch.Tensor:
    """The estimate over ``(*lead, M, T+1)`` trajectories as ``(*lead, P)``
    flat vectors, one per leading index.  The leaves of ``params`` may
    carry leading lane dims that broadcast over ``lead`` (a lane-batched
    run passes ``(L, 1, 1, ...)`` leaves over ``(L, N)``)."""
    try:
        weights_fn = ESTIMATORS[estimator]
    except KeyError as e:
        raise ValueError(f"unknown estimator {estimator!r}") from e
    lead, (m, steps) = traj.losses.shape[:-2], traj.losses.shape[-2:]
    n = math.prod(lead)
    w = (weights_fn(traj.losses, gamma).detach() / m).reshape(n, m * steps, 1)
    rows_shape = tuple(lead) + (m * steps,)
    obs = traj.obs.reshape(rows_shape + traj.obs.shape[len(lead) + 2:])
    acts = traj.actions.reshape(rows_shape
                                + traj.actions.shape[len(lead) + 2:])
    g = policy.grad_log_prob(params, obs, acts)
    acc = fixed_sum(g.reshape(n, m * steps, -1) * w, 1)
    return acc.reshape(tuple(lead) + (acc.shape[-1],))


def _estimate(policy, params: Params, traj: Trajectory, gamma: float,
              estimator: str) -> Params:
    """The estimate over ``(*lead, M, T+1)`` trajectories: a dict of
    ``(*lead, ...)`` leaves, one estimate per leading index."""
    acc = estimate_flat(policy, params, traj, gamma, estimator)
    lead = acc.shape[:-1]
    out, off = {}, 0
    for k in sorted(params):
        size = params[k].numel()
        out[k] = acc[..., off:off + size].reshape(
            tuple(lead) + tuple(params[k].shape)).to(params[k].dtype)
        off += size
    return out


def gpomdp_gradient(policy, params: Params, traj: Trajectory,
                    gamma: float) -> Params:
    """The G(PO)MDP estimate of one agent from its (M, T+1) trajectories."""
    return _estimate(policy, params, traj, gamma, "gpomdp")


def reinforce_gradient(policy, params: Params, traj: Trajectory,
                       gamma: float) -> Params:
    """REINFORCE: every log-prob weighted by the full discounted return."""
    return _estimate(policy, params, traj, gamma, "reinforce")


def per_agent_gradients(policy, params: Params, trajs: Trajectory,
                        gamma: float, estimator: str = "gpomdp") -> Params:
    """One estimate per agent from ``(N, M, T+1, ...)`` trajectories:
    a dict of ``(N, ...)`` gradient stacks, each agent's bits independent of
    N (see the module docstring)."""
    return _estimate(policy, params, trajs, gamma, estimator)
