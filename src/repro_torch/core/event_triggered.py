"""Event-triggered (LAPG-style) federated PG: the communication-efficient
baseline the paper argues against (Chen et al. [16], Section I).

Counterpart of ``repro/core/event_triggered.py``.  Each round, agent i
uploads its fresh gradient only if it moved enough since its last upload,

    upload_i  iff  ||g_i^k - g_i^last||^2 >= tau * ||g_i^k||^2,

and the server otherwise reuses the stale copy.  Every uploading agent
needs its own orthogonal channel use, so a round costs E[#triggers] in
[0, N] channel uses, against exactly 1 for the over-the-air uplink: the
asymmetry Fig. 3's argument and ``benchmarks/et_baseline.py`` measure.  The
server's uplink is the exact mean (``ota.aggregate(used, None)``): no
kernel, as in the JAX package.

The two squared norms are per-agent sums over the flattened estimate by a
fixed pairwise tree (``utils.tree.fixed_sum``), so a trigger never depends
on how many agents share a call.  ``agent_blocks`` rolls the fleet out in
blocks from the stacked draws (``fedpg``'s up-front draws) and stacks the
estimates again: the stale copies are O(N x d) by design.  :func:`run_jit`
is JAX's compiled entry point in eager PyTorch: :func:`run` after the same
normalisation of the participation config that keys JAX's cache (full
participation is the same run as ``None``); there is no program to compile
and nothing to cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import fedpg, gpomdp, ota
from repro_torch.core.fedpg import FedPGConfig, RoundDraws
from repro_torch.rl.envs.heterogeneous import check_agent_count
from repro_torch.rl.sampler import discounted_return
from repro_torch.service import participation as svc_part
from repro_torch.service.participation import ParticipationConfig
from repro_torch.utils.device import DeviceLike, make_generator, resolve_device
from repro_torch.utils.tree import (
    Params, fixed_sum, flatten_agent_stack, theta_device, tree_global_norm_sq,
    tree_keys,
)


@dataclass(frozen=True)
class ETConfig:
    tau: float = 0.05     # trigger threshold (relative squared change)


class ETHistory(NamedTuple):
    rewards: torch.Tensor   # (K,)
    grad_sq: torch.Tensor   # (K,)
    uploads: torch.Tensor   # (K,) float32: channel uses this round (0..N)


class ETState(NamedTuple):
    """What an ET round carries: the parameters, the server's stale copies
    ``(N, ...)``, the round index and the mask-stream seed (service only)."""

    theta: Params
    stale: Params
    round_idx: int = 0
    seed: Optional[torch.Tensor] = None


def _row_norms_sq(tree: Params) -> torch.Tensor:
    """(N,) squared norms, each a fixed-order sum over its agent's row."""
    flat, _, _ = flatten_agent_stack(tree)
    return fixed_sum(flat * flat, 1)


def make_round_fn(env, policy, cfg: FedPGConfig, et: ETConfig, *,
                  agent_blocks: Optional[int] = None,
                  participation: Optional[ParticipationConfig] = None):
    """One ET round: ``round_fn(state, generator, draws=None) -> (state',
    (reward, grad_sq, uploads))``; ``draws`` injects the rollout draws and
    the participation mask (:class:`fedpg.RoundDraws`)."""
    if cfg.estimator not in gpomdp.ESTIMATORS:
        raise ValueError(f"unknown estimator {cfg.estimator!r}")
    check_agent_count(env, cfg.n_agents)
    part = svc_part.normalize(participation, cfg.n_agents)
    n = cfg.n_agents
    n_blocks, block = ((1, n) if agent_blocks is None
                       else ota.blocked_layout(n, agent_blocks)[:2])

    def round_fn(state: ETState, generator: Optional[torch.Generator],
                 draws: Optional[RoundDraws] = None):
        d = draws or RoundDraws()
        theta = state.theta
        dev = theta_device(theta)
        pre = fedpg.predraw(env, policy, generator, cfg, dev, d)
        parts, returns = [], []
        for b in range(n_blocks):
            lo, hi = b * block, min((b + 1) * block, n)
            trajs = fedpg.block_rollout(env, policy, theta, cfg, pre, d,
                                        lo, hi)
            parts.append(gpomdp.per_agent_gradients(
                policy, theta, trajs, cfg.gamma, cfg.estimator))
            returns.append(discounted_return(trajs.losses, cfg.gamma))
        grads = {k: torch.cat([g[k] for g in parts]) for k in tree_keys(theta)}
        returns = torch.cat(returns)

        diff = {k: grads[k] - state.stale[k] for k in tree_keys(grads)}
        fire = _row_norms_sq(diff) >= et.tau * _row_norms_sq(grads)
        if part is None:
            reward = -torch.mean(returns)
        else:
            # an agent uploads iff it participates AND triggers; a
            # non-participant's server copy and reference stay put
            mask = d.mask
            if mask is None:
                mask = svc_part.round_mask(part, state.seed, state.round_idx,
                                           torch.arange(n, device=dev), n)
            mask = mask.to(device=dev, dtype=torch.bool)
            fire = fire & mask
            count_p = torch.sum(mask.float())
            kept = torch.where(mask[:, None], returns,
                               torch.zeros_like(returns))
            reward = -torch.sum(kept) * svc_part.safe_inv(count_p) \
                / cfg.batch_m

        used = {k: torch.where(fire.reshape((-1,) + (1,) * (g.ndim - 1)), g,
                               state.stale[k]) for k, g in grads.items()}
        update = ota.aggregate(used, None)[0]   # exact uplink (ideal mean)
        theta_next = {k: theta[k] - cfg.alpha * update[k]
                      for k in tree_keys(theta)}
        metrics = (reward, tree_global_norm_sq(update),
                   torch.sum(fire).float())
        return ETState(theta_next, used, state.round_idx + 1,
                       state.seed), metrics

    return round_fn


def run(env, policy, cfg: FedPGConfig, et: ETConfig, seed: int = 0, *,
        agent_blocks: Optional[int] = None,
        participation: Optional[ParticipationConfig] = None,
        device: DeviceLike = None) -> Tuple[Params, ETHistory]:
    """K rounds of event-triggered federated PG from
    ``torch.Generator(device).manual_seed(seed)``; returns ``(theta,
    ETHistory)``.  ``participation`` gates the trigger with the service's
    per-round mask (a config that normalises away runs the plain rounds,
    bit for bit); the server mean still runs over all N copies and the
    reward averages the participants' trajectories.  ``device=None`` means
    ``cuda`` and raises when no GPU is present."""
    dev = resolve_device(device)
    env = fedpg.env_on(env, dev)
    gen = make_generator(seed, dev)
    theta = policy.init(gen, dev)
    part = svc_part.normalize(participation, cfg.n_agents)
    stale = {k: torch.zeros((cfg.n_agents,) + tuple(v.shape), dtype=v.dtype,
                            device=dev) for k, v in theta.items()}
    state = ETState(theta, stale, 0, None if part is None
                    else ota.sample_seed(gen, dev))
    round_fn = make_round_fn(env, policy, cfg, et, agent_blocks=agent_blocks,
                             participation=part)
    metrics = []
    for _ in range(cfg.n_rounds):
        state, m = round_fn(state, gen)
        metrics.append(m)
    rewards, grad_sq, uploads = (torch.stack(x) for x in zip(*metrics))
    return state.theta, ETHistory(rewards=rewards, grad_sq=grad_sq,
                                  uploads=uploads)


def run_jit(env, policy, cfg: FedPGConfig, et: ETConfig, seed: int = 0, *,
            agent_blocks: Optional[int] = None,
            participation: Optional[ParticipationConfig] = None,
            device: DeviceLike = None) -> Tuple[Params, ETHistory]:
    """:func:`run`, bit for bit, with the participation config normalised
    first, as JAX's ``event_triggered.run_jit`` normalises it before keying
    its compiled program (module docstring)."""
    return run(env, policy, cfg, et, seed, agent_blocks=agent_blocks,
               participation=svc_part.normalize(participation, cfg.n_agents),
               device=device)
