"""Algorithm 1 (federated PG) and Algorithm 2 (over-the-air federated PG).

Counterpart of ``repro/core/fedpg.py`` for the stacked and the
agent-streamed round, plain and as a service round.  Each communication
round rolls out N agents x M trajectories of T+1 steps, forms one G(PO)MDP
estimate per agent (Eq. 4), aggregates them — exactly (Algorithm 1,
``ota=None``) or through the simulated fading channel (Algorithm 2, an
:class:`OTAConfig`) — and applies the server SGD step.  ``lax.scan`` over
rounds is a Python loop; per-round metrics stay on the device until the run
ends, so a round never waits for the host.

Per-round metrics (the paper's Figs. 1-5):
    reward    — empirical cumulative (discounted) reward over the round's
                trajectories (over the participants' in a service round);
    grad_sq   — ||(1/N) sum_i grad_hat J_i||^2 of the *exact* mean, in
                Algorithm 2 too (the participants' mean, plus replays, in a
                service round);
    gain_mean — mean sampled h of the round (of the participants' in a
                service round; 1.0 for Algorithm 1).

Randomness: one ``torch.Generator`` per run, on the run's device.  A round
draws, in order, the initial states, then each step's policy noise and
environment noise, then (in Algorithm 2) the gains and the kernel seed.
:class:`RoundDraws` injects them instead, the hook the parity tests use to
replay the JAX package's draws.  A service run draws one more value before
its first round, the seed of its counter-hash mask stream
(``service.stream``); the masks themselves cost the generator nothing.

``agent_blocks`` streams the agent axis (:func:`_make_streamed_round_fn`):
rollouts, gradients and the cross-agent sums run one block of agents at a
time, so the gradients held at once are O(agent_blocks x d).  The JAX
package keeps O(N) key material and re-derives each agent's draws; a
``torch.Generator`` is sequential, so the streamed round makes exactly the
stacked round's generator calls up front — the initial states, every
step's policy and environment noise, the gains, the kernel seed — and
slices them per block.  That costs O(N*M*(obs + (T+1)*noise)) floats per
round (9.6 MB at N = 10^5, M = 1, T = 3 for the MLP policy) and buys the
stacked round's exact draws for every block size.

``participation`` / ``staleness`` (``repro_torch.service``) make the rounds
service rounds, ``(ServiceState, generator, draws) -> (ServiceState',
metrics)``: every agent still rolls out and forms its estimate (the draws
are the plain round's), the agents outside the round's mask are zeroed
before any cross-agent sum, and the update is renormalised by the round's
contribution weight W (:func:`repro_torch.service.participation.
participation_factor`).  A config that can never drop an agent normalises
away and the round is the plain one, bit for bit.  A ``HeterogeneousEnv``
runs each agent on its own lane of the per-agent stacks.  Not ported here:
the agent-mesh forms (sweep/distribute slice) and telemetry.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import gpomdp, ota, power_control
from repro_torch.core.ota import OTAConfig, sample_seed
from repro_torch.rl.envs.heterogeneous import block_env, check_agent_count
from repro_torch.rl.sampler import (
    discounted_return, empirical_reward, rollout_batch,
)
from repro_torch.service import participation as svc_part
from repro_torch.service import staleness as svc_stale
from repro_torch.service.participation import (
    ParticipationConfig, ServiceState,
)
from repro_torch.service.staleness import StalenessConfig
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
    actions: Optional[torch.Tensor] = None  # (N, M, T+1[, act_dim])
    env: Optional[torch.Tensor] = None      # (T+1, N, M, ...) env step noise
    gains: Optional[torch.Tensor] = None    # (N,)
    seed: Optional[Union[int, torch.Tensor]] = None  # kernel seed
    mask: Optional[torch.Tensor] = None     # (N,) bool participation mask,
    #                                         faults included (service rounds)


RoundFn = Callable[..., Tuple[Union[Params, ServiceState],
                              Tuple[torch.Tensor, ...]]]


def make_round_fn(env, policy, cfg: FedPGConfig, ota_cfg: Optional[OTAConfig],
                  *, ota_backend: str = "auto",
                  agent_blocks: Optional[int] = None,
                  participation: Optional[ParticipationConfig] = None,
                  staleness: Optional[StalenessConfig] = None) -> RoundFn:
    """One communication round:
    ``round_fn(theta, generator, draws=None) -> (theta', (reward, grad_sq,
    gain_mean))``.  ``ota_backend`` picks the uplink ("torch" | "cuda" |
    "auto", see :class:`repro_torch.core.ota.AggregateSpec`).
    ``agent_blocks`` streams the agent axis in blocks of that many agents:
    the history is bitwise the same for every block size, with the stacked
    round's draws (see :func:`_make_streamed_round_fn`).  An active
    ``participation`` config makes it a service round over a
    :class:`ServiceState` (module docstring)."""
    if cfg.estimator not in gpomdp.ESTIMATORS:
        raise ValueError(f"unknown estimator {cfg.estimator!r}")
    if ota_cfg is not None:
        power_control.check_agent_count(ota_cfg.channel, cfg.n_agents)
    check_agent_count(env, cfg.n_agents)
    part = svc_part.normalize(participation, cfg.n_agents)
    stale_cfg = svc_stale.normalize(staleness, part)
    if agent_blocks is not None:
        if part is not None:
            return _make_streamed_service_round_fn(
                env, policy, cfg, ota_cfg, agent_blocks, ota_backend, part,
                stale_cfg)
        return _make_streamed_round_fn(env, policy, cfg, ota_cfg,
                                       agent_blocks, ota_backend)
    if part is not None:
        return _make_service_round_fn(env, policy, cfg, ota_cfg, ota_backend,
                                      part, stale_cfg)

    def round_fn(theta: Params, generator: Optional[torch.Generator],
                 draws: Optional[RoundDraws] = None):
        d = draws or RoundDraws()
        trajs = _rollout(env, policy, theta, generator, cfg, d)
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


def _rollout(env, policy, theta, generator, cfg: FedPGConfig, d: RoundDraws):
    """The whole fleet's rollouts, drawn step by step or injected."""
    return rollout_batch(env, policy, theta, generator, cfg.horizon,
                         (cfg.n_agents, cfg.batch_m), s0=d.s0,
                         actions=d.actions, env_noise=d.env)


class _Predrawn(NamedTuple):
    s0: torch.Tensor
    policy_noise: Optional[torch.Tensor]   # (T+1, N, M, ...)
    env_noise: Optional[torch.Tensor]      # (T+1, N, M, ...)


def predraw(env, policy, generator, cfg: FedPGConfig, dev,
            d: RoundDraws) -> _Predrawn:
    """The stacked round's rollout draws, made up front in its order
    (``s_0``, then per step the policy's noise and the environment's), or
    taken from ``d``."""
    batch = (cfg.n_agents, cfg.batch_m)
    s0 = env.reset(generator, batch, dev) if d.s0 is None else d.s0
    pol, envn = [], []
    for _ in range(cfg.horizon + 1):
        if d.actions is None:
            pol.append(policy.sample_noise(generator, batch, dev))
        if d.env is None:
            envn.append(env.step_noise(generator, batch, dev))
    env_noise = d.env
    if d.env is None and envn[0] is not None:
        env_noise = torch.stack(envn)
    return _Predrawn(s0, torch.stack(pol) if pol else None, env_noise)


def block_rollout(env, policy, theta, cfg: FedPGConfig, pre: _Predrawn,
                  d: RoundDraws, lo: int, hi: int):
    """Agents ``[lo, hi)``'s rollouts from the up-front draws."""
    return rollout_batch(
        block_env(env, lo, hi), policy, theta, None, cfg.horizon,
        (hi - lo, cfg.batch_m), s0=pre.s0[lo:hi],
        actions=None if d.actions is None else d.actions[lo:hi],
        policy_noise=(None if pre.policy_noise is None
                      else pre.policy_noise[:, lo:hi]),
        env_noise=None if pre.env_noise is None else pre.env_noise[:, lo:hi])


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
        pre = predraw(env, policy, generator, cfg, dev, d)
        if ota_cfg is not None:
            h, seed = ota._round_draws(ota_cfg, generator, n, dev, d.gains,
                                       d.seed)
            wire = ota._wire_dtype(ota_cfg) if be == "cuda" else None
        gsum = ota.stream_zeros(theta, be)
        v = gsum
        returns = []
        for b in range(n_blocks):
            lo, hi = b * block, min((b + 1) * block, n)
            trajs = block_rollout(env, policy, theta, cfg, pre, d, lo, hi)
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


# ---------------------------------------------------------------------------
# Service rounds: participation masks, staleness replay, W renormalisation.
# ---------------------------------------------------------------------------

class _RoundWeights(NamedTuple):
    """A service round's mask and normaliser scalars, computed from the
    ``(N,)`` mask and age vectors before any agent work, so every round
    form (stacked, streamed at any block size) computes them alike."""

    mask: torch.Tensor          # (N,) bool
    count_p: torch.Tensor       # participating count, float32
    rw: Optional[torch.Tensor]  # (N,) replay weights (staleness)
    w_norm: torch.Tensor        # the normaliser W (realised or expected)
    inv_w: torch.Tensor         # 1 / W, 0 at W == 0


def _round_weights(part: ParticipationConfig,
                   stale_cfg: Optional[StalenessConfig], state: ServiceState,
                   n: int, dev, d: RoundDraws) -> _RoundWeights:
    if d.mask is not None:
        mask = d.mask.to(device=dev, dtype=torch.bool)
    else:
        mask = svc_part.round_mask(part, state.seed, state.round_idx,
                                   torch.arange(n, device=dev), n)
    count_p = torch.sum(mask.float())
    rw = None
    w_real = count_p
    if stale_cfg is not None:
        rw = svc_stale.replay_weights(stale_cfg, mask, state.stale.age)
        w_real = count_p + torch.sum(rw)
    if part.debias == "realized":
        w_norm = w_real
    else:
        w_norm = torch.full((), svc_part.expected_count(part, n),
                            dtype=torch.float32, device=dev)   # no H2D copy
    return _RoundWeights(mask, count_p, rw, w_norm, svc_part.safe_inv(w_norm))


def _service_reward(returns: torch.Tensor, rw: _RoundWeights,
                    batch_m: int) -> torch.Tensor:
    """Minus the participants' mean discounted loss."""
    kept = torch.where(rw.mask[:, None], returns, torch.zeros_like(returns))
    return -torch.sum(kept) * svc_part.safe_inv(rw.count_p) / batch_m


def _service_gain_mean(hm: torch.Tensor, rw: _RoundWeights) -> torch.Tensor:
    return torch.sum(hm) * svc_part.safe_inv(rw.count_p)


def _make_service_round_fn(env, policy, cfg: FedPGConfig,
                           ota_cfg: Optional[OTAConfig], ota_backend: str,
                           part: ParticipationConfig,
                           stale_cfg: Optional[StalenessConfig]) -> RoundFn:
    """The stacked service round (JAX ``fedpg.py:235-322``): the uplink is
    one ``ota.aggregate`` over the masked stack with the masked gains (one
    K1 launch on the card), scaled by ``N / W``; replays are added after
    it, scaled by ``1 / W``."""
    n = cfg.n_agents

    def service_round(state: ServiceState,
                      generator: Optional[torch.Generator],
                      draws: Optional[RoundDraws] = None):
        d = draws or RoundDraws()
        theta = state.theta
        dev = theta_device(theta)
        rw = _round_weights(part, stale_cfg, state, n, dev, d)
        trajs = _rollout(env, policy, theta, generator, cfg, d)
        grads = gpomdp.per_agent_gradients(policy, theta, trajs, cfg.gamma,
                                           cfg.estimator)
        gm = svc_part.mask_agent_axis(grads, rw.mask)

        ssum = stale_next = None
        if stale_cfg is not None:
            ssum = svc_stale.replay_sum_stacked(state.stale, rw.rw)
            stale_next = svc_stale.advance(stale_cfg, state.stale, rw.mask,
                                           grads)
        gsum = {k: torch.sum(gm[k], dim=0) for k in tree_keys(gm)}
        if ssum is not None:
            gsum = {k: gsum[k] + ssum[k] for k in tree_keys(gsum)}
        mean_grad = {k: gsum[k] * rw.inv_w for k in tree_keys(gsum)}

        if ota_cfg is None:
            gain_mean = torch.ones((), device=dev)
            update = mean_grad
        else:
            h, seed = ota._round_draws(ota_cfg, generator, n, dev, d.gains,
                                       d.seed)
            hm = torch.where(rw.mask, h, torch.zeros_like(h))
            u_fresh = ota.aggregate(gm, ota_cfg, gains=hm, seed=seed,
                                    backend=ota_backend)[0]
            pf = svc_part.participation_factor(n, rw.w_norm)
            update = {k: u_fresh[k] * pf for k in tree_keys(u_fresh)}
            if ssum is not None:
                update = {k: update[k] + ssum[k] * rw.inv_w
                          for k in tree_keys(update)}
            gain_mean = _service_gain_mean(hm, rw)
        theta_next = {k: theta[k] - cfg.alpha * update[k]
                      for k in tree_keys(theta)}

        reward = _service_reward(discounted_return(trajs.losses, cfg.gamma),
                                 rw, cfg.batch_m)
        grad_sq = tree_global_norm_sq(mean_grad)
        state_next = state._replace(theta=theta_next,
                                    round_idx=state.round_idx + 1,
                                    stale=stale_next)
        return state_next, (reward, grad_sq, gain_mean)

    return service_round


def _make_streamed_service_round_fn(env, policy, cfg: FedPGConfig,
                                    ota_cfg: Optional[OTAConfig],
                                    agent_blocks: int, ota_backend: str,
                                    part: ParticipationConfig,
                                    stale_cfg: Optional[StalenessConfig]
                                    ) -> RoundFn:
    """The streamed service round (JAX ``fedpg.py:446-590``).  The mask,
    the replay weights and W come before the block loop; each block folds
    its masked estimates (gains: the mask), its stale rows (gains: the
    replay weights) and its channel signal (gains: the masked h) in three
    strict sequential folds, each its own K1 launch on the card; the server
    tail is K1's server pass with ``n_eff=W``, whose ``N / W`` reaches the
    kernel as a device factor (no host synchronisation)."""
    n = cfg.n_agents
    n_blocks, block, _ = ota.blocked_layout(n, agent_blocks)
    spec = ota.AggregateSpec(exact=ota_cfg is None, backend=ota_backend)

    def service_round(state: ServiceState,
                      generator: Optional[torch.Generator],
                      draws: Optional[RoundDraws] = None):
        d = draws or RoundDraws()
        theta = state.theta
        dev = theta_device(theta)
        be = ota._fold_backend(spec, dev)
        rw = _round_weights(part, stale_cfg, state, n, dev, d)
        pmask = rw.mask.float()
        pre = predraw(env, policy, generator, cfg, dev, d)
        if ota_cfg is not None:
            h, seed = ota._round_draws(ota_cfg, generator, n, dev, d.gains,
                                       d.seed)
            hm = torch.where(rw.mask, h, torch.zeros_like(h))
            wire = ota._wire_dtype(ota_cfg) if be == "cuda" else None
        gsum = ota.stream_zeros(theta, be)
        ssum = v = gsum
        returns, new_rows = [], []
        for b in range(n_blocks):
            lo, hi = b * block, min((b + 1) * block, n)
            trajs = block_rollout(env, policy, theta, cfg, pre, d, lo, hi)
            grads = gpomdp.per_agent_gradients(policy, theta, trajs,
                                               cfg.gamma, cfg.estimator)
            gsum = ota.stream_fold_block(gsum, grads, pmask[lo:hi],
                                         backend=be)
            if stale_cfg is not None:
                old = {k: x[lo:hi] for k, x in state.stale.grads.items()}
                ssum = ota.stream_fold_block(ssum, old, rw.rw[lo:hi],
                                             backend=be)
                keep = rw.mask[lo:hi]
                new_rows.append({k: torch.where(
                    keep.reshape((-1,) + (1,) * (g.ndim - 1)), g, old[k])
                    for k, g in grads.items()})
            if ota_cfg is not None:
                v = ota.stream_fold_block(v, grads, hm[lo:hi],
                                          wire_dtype=wire, backend=be)
            returns.append(discounted_return(trajs.losses, cfg.gamma))

        if stale_cfg is not None:
            gsum = {k: gsum[k] + ssum[k] for k in tree_keys(gsum)}
        mean_grad = {k: (gsum[k] * rw.inv_w).to(theta[k].dtype)
                     for k in tree_keys(theta)}
        grad_sq = tree_global_norm_sq(mean_grad)
        if ota_cfg is None:
            gain_mean = torch.ones((), device=dev)
            update = mean_grad
        else:
            update = ota.stream_finalize(ota_cfg, seed, v, n, backend=be,
                                         n_eff=rw.w_norm)
            if stale_cfg is not None:
                update = {k: update[k] + ssum[k] * rw.inv_w
                          for k in tree_keys(update)}
            gain_mean = _service_gain_mean(hm, rw)
        theta_next = {k: theta[k] - cfg.alpha * update[k].to(theta[k].dtype)
                      for k in tree_keys(theta)}
        reward = _service_reward(torch.cat(returns), rw, cfg.batch_m)

        stale_next = None
        if stale_cfg is not None:
            stale_next = svc_stale.StaleState(
                grads={k: torch.cat([r[k] for r in new_rows])
                       for k in tree_keys(theta)},
                age=svc_stale.next_age(state.stale.age, rw.mask))
        state_next = state._replace(theta=theta_next,
                                    round_idx=state.round_idx + 1,
                                    stale=stale_next)
        return state_next, (reward, grad_sq, gain_mean)

    return service_round


def env_on(env, dev):
    """Tabular tables and per-agent stacks follow the run to its device."""
    return env.to(dev) if hasattr(env, "to") else env


def run(env, policy, cfg: FedPGConfig, seed: int = 0, *,
        ota: Optional[OTAConfig] = None, theta0: Optional[Params] = None,
        ota_backend: str = "auto", agent_blocks: Optional[int] = None,
        participation: Optional[ParticipationConfig] = None,
        staleness: Optional[StalenessConfig] = None,
        device: DeviceLike = None) -> Tuple[Params, History]:
    """Run K rounds from ``torch.Generator(device).manual_seed(seed)``;
    returns ``(theta_K, History)``.  ``ota=None`` is Algorithm 1, an
    ``OTAConfig`` Algorithm 2.  ``agent_blocks`` streams the agent axis (see
    :func:`make_round_fn`).  ``participation`` / ``staleness`` run service
    rounds (a config that normalises away runs the plain rounds, bit for
    bit).  ``device=None`` means ``cuda`` and raises when no GPU is
    present."""
    dev = resolve_device(device)
    env = env_on(env, dev)
    gen = make_generator(seed, dev)
    theta = policy.init(gen, dev) if theta0 is None else {
        k: v.to(dev) for k, v in theta0.items()}
    part = svc_part.normalize(participation, cfg.n_agents)
    stale_cfg = svc_stale.normalize(staleness, part)
    round_fn = make_round_fn(env, policy, cfg, ota, ota_backend=ota_backend,
                             agent_blocks=agent_blocks, participation=part,
                             staleness=stale_cfg)
    # a service run draws its mask-stream seed once, after theta_0
    carry = theta if part is None else svc_part.init_state(
        theta, sample_seed(gen, dev), cfg.n_agents, stale_cfg)
    metrics = []
    for _ in range(cfg.n_rounds):
        carry, m = round_fn(carry, gen)
        metrics.append(m)
    theta = carry if part is None else carry.theta
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
                participation: Optional[ParticipationConfig] = None,
                staleness: Optional[StalenessConfig] = None,
                device: DeviceLike = None) -> History:
    """``n_runs`` independent repetitions (the paper uses 20), one generator
    each; the History fields gain a leading (n_runs,) axis."""
    hists = [run(env, policy, cfg, s, ota=ota, ota_backend=ota_backend,
                 agent_blocks=agent_blocks, participation=participation,
                 staleness=staleness, device=device)[1]
             for s in run_seeds(seed, n_runs)]
    return History(*(torch.stack(x) for x in zip(*hists)))
