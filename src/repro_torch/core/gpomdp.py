"""Policy-gradient estimators: REINFORCE and mini-batch G(PO)MDP (Eq. 4).

Counterpart of ``repro/core/gpomdp.py``.  Both estimators are weighted sums
of log-policy gradients over the M x (T+1) steps of an agent's batch:

    G(PO)MDP:   (1/M) sum_m sum_t  w_{m,t} grad log pi(a_t | s_t),
                w_{m,t} = sum_{t'>=t} gamma^t' l_t'   (absolute discount);
    REINFORCE:  (1/M) sum_m sum_t  R_m     grad log pi(a_t | s_t).

The JAX package takes ``jax.grad`` of the surrogate loss.  Here each step's
``grad log pi`` comes from ``torch.func.grad`` (vmapped over the steps), is
scaled by its weight ``w / M``, and the steps are summed by a fixed
pairwise tree of elementwise adds.  The reason is batch invariance: an
agent's estimate must be the same bits whatever block of agents it is
computed with, or the agent-streamed round would depend on
``agent_blocks``.  On the card cuBLAS
picks its algorithm by the shape of the call, so a sum over steps inside a
batched matrix product changes its last bits with the number of agents, and
so does a per-step product: measured on an H100, the back-propagation
through the output layer (a (rows, 5) x (5, 16) product) gave other bits for
210, 630 and 840 rows than for 2100.  So the per-step gradients are taken
over fixed chunks of ``ROW_CHUNK`` steps (the last one padded with copies
of the first step) — every call has the same shape — and summed over steps
by elementwise adds in an order set by the step count alone; neither
depends on the batch.
"""
from __future__ import annotations

import math

import torch
from torch.func import grad, vmap

from repro_torch.rl.sampler import Trajectory
from repro_torch.utils.tree import Params, flatten_agent_stack


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

ROW_CHUNK = 4096   # rows per call: one call at the paper's N*M*(T+1) = 2100


def log_prob_grads(policy, params: Params, obs: torch.Tensor,
                   actions: torch.Tensor) -> torch.Tensor:
    """(rows, P) float32: ``grad log pi(a | s)`` of each row, flattened in
    sorted-key order, computed over fixed-shape chunks of ``ROW_CHUNK`` rows
    so a row's bits do not depend on how many rows share the call."""
    grad_fn = vmap(grad(policy.log_prob), in_dims=(None, 0, 0))
    parts = []
    for lo in range(0, obs.shape[0], ROW_CHUNK):
        o, a = obs[lo:lo + ROW_CHUNK], actions[lo:lo + ROW_CHUNK]
        real = o.shape[0]
        if real < ROW_CHUNK:
            pad = ROW_CHUNK - real
            o = torch.cat([o, o[:1].expand((pad,) + o.shape[1:])])
            a = torch.cat([a, a[:1].expand((pad,) + a.shape[1:])])
        flat, _, _ = flatten_agent_stack(grad_fn(params, o, a))
        parts.append(flat[:real])
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def tree_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """(n, R, P) -> (n, P): the sum over R as a pairwise tree whose shape
    depends on R alone (row i meets row i + R//2, an odd last row is carried
    up), in elementwise adds, so no reduction kernel chooses its order."""
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        y = x[:, :half] + x[:, half:2 * half]
        x = torch.cat([y, x[:, 2 * half:]], dim=1) if x.shape[1] % 2 else y
    return x[:, 0]


def _estimate(policy, params: Params, traj: Trajectory, gamma: float,
              estimator: str) -> Params:
    """The estimate over ``(*lead, M, T+1)`` trajectories: a dict of
    ``(*lead, ...)`` leaves, one estimate per leading index."""
    try:
        weights_fn = ESTIMATORS[estimator]
    except KeyError as e:
        raise ValueError(f"unknown estimator {estimator!r}") from e
    lead, (m, steps) = traj.losses.shape[:-2], traj.losses.shape[-2:]
    n = math.prod(lead)
    w = (weights_fn(traj.losses, gamma).detach() / m).reshape(n, m * steps, 1)
    obs = traj.obs.reshape((n * m * steps,) + traj.obs.shape[len(lead) + 2:])
    acts = traj.actions.reshape((n * m * steps,)
                                + traj.actions.shape[len(lead) + 2:])
    flat = log_prob_grads(policy, params, obs, acts)     # (rows, P)
    acc = tree_sum_rows(flat.reshape(n, m * steps, -1) * w)
    out, off = {}, 0
    for k in sorted(params):
        size = params[k].numel()
        out[k] = acc[:, off:off + size].reshape(
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
