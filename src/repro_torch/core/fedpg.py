"""Algorithm 1 (federated PG) and Algorithm 2 (over-the-air federated PG).

Counterpart of ``repro/core/fedpg.py`` for the stacked round.  Each
communication round rolls out N agents x M trajectories of T+1 steps as one
batch, forms one G(PO)MDP estimate per agent (Eq. 4), aggregates them —
exactly (Algorithm 1, ``ota=None``) or through the simulated fading channel
(Algorithm 2, an :class:`OTAConfig`) — and applies the server SGD step.
``lax.scan`` over rounds is a Python loop; per-round metrics stay on the
device until the run ends, so a round never waits for the host.

Per-round metrics (the paper's Figs. 1-5):
    reward    — empirical cumulative (discounted) reward over all N*M
                trajectories of the round;
    grad_sq   — ||(1/N) sum_i grad_hat J_i||^2 of the *exact* mean, in
                Algorithm 2 too;
    gain_mean — mean sampled h of the round (1.0 for Algorithm 1).

Randomness: one ``torch.Generator`` per run, on the run's device.  A round
draws, in order, the initial states, the actions step by step, then (in
Algorithm 2) the gains and the kernel seed.  :class:`RoundDraws` injects
them instead, the hook the parity tests use to replay the JAX package's
draws.

``agent_blocks`` streams the agent axis (:func:`_make_streamed_round_fn`):
rollouts, gradients and both cross-agent sums run one block of agents at a
time, so the gradients held at once are O(agent_blocks x d).  The JAX
package keeps O(N) key material and re-derives each agent's draws; a
``torch.Generator`` is sequential, so the streamed round makes exactly the
stacked round's generator calls up front — the initial states, T+1 uniform
draws of ``(N, M, n_actions)`` (the Gumbel-max uniforms of
``MLPPolicy.sample``), the gains, the kernel seed — and slices them per
block.  That costs O(N*M*(obs + (T+1)*n_actions)) floats per round (9.6 MB
at N = 10^5, M = 1, T = 3) and buys the stacked round's exact draws for
every block size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import gpomdp, ota, power_control
from repro_torch.core.ota import OTAConfig
from repro_torch.rl.sampler import (
    discounted_return, empirical_reward, rollout_batch,
)
from repro_torch.utils.device import DeviceLike, make_generator, resolve_device
from repro_torch.utils.tree import (
    Params, theta_device, tree_global_norm_sq, tree_keys,
)


@dataclass(frozen=True)
class FedPGConfig:
    n_agents: int = 10           # N
    batch_m: int = 10            # M (trajectories per agent per round)
    horizon: int = 20            # T
    gamma: float = 0.99
    alpha: float = 1e-4          # step size
    n_rounds: int = 200          # K
    estimator: str = "gpomdp"    # or "reinforce"


class History(NamedTuple):
    """Per-round training metrics, each (K,) (or (runs, K) from
    :func:`monte_carlo`)."""

    rewards: torch.Tensor
    grad_sq: torch.Tensor
    gain_mean: torch.Tensor


class RoundDraws(NamedTuple):
    """Injected random draws of one round; ``None`` fields are drawn."""

    s0: Optional[torch.Tensor] = None       # (N, M, obs_dim)
    actions: Optional[torch.Tensor] = None  # (N, M, T+1) int64
    gains: Optional[torch.Tensor] = None    # (N,)
    seed: Optional[Union[int, torch.Tensor]] = None  # kernel seed


RoundFn = Callable[..., Tuple[Params, Tuple[torch.Tensor, ...]]]


def make_round_fn(env, policy, cfg: FedPGConfig, ota_cfg: Optional[OTAConfig],
                  *, ota_backend: str = "auto",
                  agent_blocks: Optional[int] = None) -> RoundFn:
    """One communication round:
    ``round_fn(theta, generator, draws=None) -> (theta', (reward, grad_sq,
    gain_mean))``.  ``ota_backend`` picks the uplink ("torch" | "cuda" |
    "auto", see :class:`repro_torch.core.ota.AggregateSpec`).
    ``agent_blocks`` streams the agent axis in blocks of that many agents:
    the history is bitwise the same for every block size, with the stacked
    round's draws (see :func:`_make_streamed_round_fn`)."""
    if cfg.estimator not in gpomdp.ESTIMATORS:
        raise ValueError(f"unknown estimator {cfg.estimator!r}")
    if ota_cfg is not None:
        power_control.check_agent_count(ota_cfg.channel, cfg.n_agents)
    if agent_blocks is not None:
        return _make_streamed_round_fn(env, policy, cfg, ota_cfg,
                                       agent_blocks, ota_backend)

    def round_fn(theta: Params, generator: Optional[torch.Generator],
                 draws: Optional[RoundDraws] = None):
        d = draws or RoundDraws()
        trajs = rollout_batch(env, policy, theta, generator, cfg.horizon,
                              (cfg.n_agents, cfg.batch_m), s0=d.s0,
                              actions=d.actions)
        grads = gpomdp.per_agent_gradients(policy, theta, trajs, cfg.gamma,
                                           cfg.estimator)

        # --- uplink + server update -----------------------------------
        mean_grad = ota.aggregate(grads, None)[0]  # also the grad_sq metric
        if ota_cfg is None:
            gain_mean = torch.ones((), device=theta_device(theta))
            theta_next = {k: theta[k] - cfg.alpha * mean_grad[k]
                          for k in tree_keys(theta)}
        else:
            theta_next, h = ota.aggregate_apply(
                grads, ota_cfg, theta, alpha=cfg.alpha, generator=generator,
                backend=ota_backend, gains=d.gains, seed=d.seed)
            gain_mean = torch.mean(h)

        reward = empirical_reward(trajs, cfg.gamma)
        grad_sq = tree_global_norm_sq(mean_grad)
        return theta_next, (reward, grad_sq, gain_mean)

    return round_fn


def _make_streamed_round_fn(env, policy, cfg: FedPGConfig,
                            ota_cfg: Optional[OTAConfig], agent_blocks: int,
                            ota_backend: str = "auto") -> RoundFn:
    """The round evaluated block by block over the agent axis.

    The round's draws are made up front, in the stacked round's order (see
    the module docstring), or taken from :class:`RoundDraws` (full-N
    tensors, sliced per block).  Each block rolls out its agents, forms
    their G(PO)MDP estimates and folds them into the exact-mean and channel
    accumulators (strict sequential folds, :func:`ota.stream_fold_block`);
    only the per-agent returns, O(N) scalars, outlive the block.  The last
    block may be short: folding fewer rows equals folding masked phantom
    rows, since adding +0.0 changes no bit.  On the kernel path each block
    is two K1 launches and the server tail one more."""
    n = cfg.n_agents
    n_blocks, block, _ = ota.blocked_layout(n, agent_blocks)
    spec = ota.AggregateSpec(exact=ota_cfg is None, backend=ota_backend)

    def round_fn(theta: Params, generator: Optional[torch.Generator],
                 draws: Optional[RoundDraws] = None):
        d = draws or RoundDraws()
        dev = theta_device(theta)
        be = ota._fold_backend(spec, dev)
        batch = (n, cfg.batch_m)
        s0 = env.reset(generator, batch, dev) if d.s0 is None else d.s0
        uniforms = None
        if d.actions is None:
            uniforms = torch.stack([
                policy.sample_uniforms(generator, batch, dev)
                for _ in range(cfg.horizon + 1)])
        if ota_cfg is not None:
            h, seed = ota._round_draws(ota_cfg, generator, n, dev, d.gains,
                                       d.seed)
            wire = ota._wire_dtype(ota_cfg) if be == "cuda" else None
        gsum = ota.stream_zeros(theta, be)
        v = gsum
        returns = []
        for b in range(n_blocks):
            lo, hi = b * block, min((b + 1) * block, n)
            trajs = rollout_batch(
                env, policy, theta, None, cfg.horizon, (hi - lo, cfg.batch_m),
                s0=s0[lo:hi],
                actions=None if d.actions is None else d.actions[lo:hi],
                uniforms=None if uniforms is None else uniforms[:, lo:hi])
            grads = gpomdp.per_agent_gradients(policy, theta, trajs,
                                               cfg.gamma, cfg.estimator)
            gsum = ota.stream_fold_block(gsum, grads, backend=be)
            if ota_cfg is not None:
                v = ota.stream_fold_block(v, grads, h[lo:hi], wire_dtype=wire,
                                          backend=be)
            returns.append(discounted_return(trajs.losses, cfg.gamma))

        reward = -torch.mean(torch.cat(returns))
        mean_grad = {k: (gsum[k] / n).to(theta[k].dtype)
                     for k in tree_keys(theta)}
        grad_sq = tree_global_norm_sq(mean_grad)
        if ota_cfg is None:
            gain_mean = torch.ones((), device=dev)
            theta_next = {k: theta[k] - cfg.alpha * mean_grad[k]
                          for k in tree_keys(theta)}
        else:
            theta_next = ota.stream_finalize_apply(
                ota_cfg, seed, v, theta, cfg.alpha, n, backend=be)
            gain_mean = torch.mean(h)
        return theta_next, (reward, grad_sq, gain_mean)

    return round_fn


def run(env, policy, cfg: FedPGConfig, seed: int = 0, *,
        ota: Optional[OTAConfig] = None, theta0: Optional[Params] = None,
        ota_backend: str = "auto", agent_blocks: Optional[int] = None,
        device: DeviceLike = None) -> Tuple[Params, History]:
    """Run K rounds from ``torch.Generator(device).manual_seed(seed)``;
    returns ``(theta_K, History)``.  ``ota=None`` is Algorithm 1, an
    ``OTAConfig`` Algorithm 2.  ``agent_blocks`` streams the agent axis (see
    :func:`make_round_fn`).  ``device=None`` means ``cuda`` and raises
    when no GPU is present."""
    dev = resolve_device(device)
    gen = make_generator(seed, dev)
    theta = policy.init(gen, dev) if theta0 is None else {
        k: v.to(dev) for k, v in theta0.items()}
    round_fn = make_round_fn(env, policy, cfg, ota, ota_backend=ota_backend,
                             agent_blocks=agent_blocks)
    metrics = []
    for _ in range(cfg.n_rounds):
        theta, m = round_fn(theta, gen)
        metrics.append(m)
    rewards, grad_sq, gain_mean = (torch.stack(x) for x in zip(*metrics))
    return theta, History(rewards=rewards, grad_sq=grad_sq,
                          gain_mean=gain_mean)


def avg_grad_sq(history: History) -> torch.Tensor:
    """The paper's reported quantity: (1/K) sum_k ||grad J(theta^k)||^2."""
    return torch.mean(history.grad_sq, dim=-1)


def run_seeds(seed: int, n_runs: int) -> list:
    """Independent per-run seeds spawned from ``seed`` (numpy SeedSequence)."""
    children = np.random.SeedSequence(seed).spawn(n_runs)
    return [int(c.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for c in children]


def monte_carlo(env, policy, cfg: FedPGConfig, seed: int, n_runs: int, *,
                ota: Optional[OTAConfig] = None, ota_backend: str = "auto",
                agent_blocks: Optional[int] = None,
                device: DeviceLike = None) -> History:
    """``n_runs`` independent repetitions (the paper uses 20), one generator
    each; the History fields gain a leading (n_runs,) axis."""
    hists = [run(env, policy, cfg, s, ota=ota, ota_backend=ota_backend,
                 agent_blocks=agent_blocks, device=device)[1]
             for s in run_seeds(seed, n_runs)]
    return History(*(torch.stack(x) for x in zip(*hists)))
