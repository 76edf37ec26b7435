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

``agent_blocks`` streams the agent axis: rollouts, gradients and the
cross-agent sums run one block of agents at a time, so the gradients held at
once are O(agent_blocks x d).  The JAX package keeps O(N) key material and
re-derives each agent's draws; a ``torch.Generator`` is sequential, so the
streamed round makes exactly the stacked round's generator calls up front —
the initial states, every step's policy and environment noise, the gains,
the kernel seed — and slices them per block.  That costs
O(N*M*(obs + (T+1)*noise)) floats per round (9.6 MB at N = 10^5, M = 1,
T = 3 for the MLP policy) and buys the stacked round's exact draws for
every block size.

``participation`` / ``staleness`` (``repro_torch.service``) make the rounds
service rounds, ``(ServiceState, generator, draws) -> (ServiceState',
metrics)``: every agent still rolls out and forms its estimate (the draws
are the plain round's), the agents outside the round's mask are zeroed
before any cross-agent sum, and the update is renormalised by the round's
contribution weight W (:func:`repro_torch.service.participation.
participation_factor`).  A config that can never drop an agent normalises
away and the round is the plain one, bit for bit.  A ``HeterogeneousEnv``
runs each agent on its own lane of the per-agent stacks.

``telemetry`` (a :class:`repro_torch.telemetry.TelemetryConfig`) makes each
round also emit its :class:`~repro_torch.telemetry.RoundTelemetry` probes,
returned as ``History.telemetry``; the probes only read the round's values,
so the history is the same, bit for bit, with telemetry on or off.

Every round, stacked and streamed, plain and service, lives in
``core/lanes.py``, in the flat layout with a leading lane axis: :func:`run`
is one lane of it, and :func:`monte_carlo` runs its repetitions as the lanes
of one lane-batched run (one round per step for all runs, every lane bitwise
:func:`run` with its seed; on the card one K1 lane-form launch a stacked
round, ``2 n_blocks + 1`` a streamed one).  Every metric reduces in a fixed
order (``utils.tree.fixed_sum``), the same for a run alone and as a lane.

``agent_mesh`` (``launch.mesh.AgentMesh``, from ``distribute.
agent_mesh_for``) splits the fleet across the ranks of a
``torch.distributed`` group, the port's form of JAX's ``shard_map`` round:
every rank seeds the run's generator alike and makes every draw of the
round (so a mesh run's draws are the run's off the mesh: the initial
states, the noise, the gains, the kernel seed, the service mask), rolls out
and folds only its own agents through K1, and one ``all_reduce`` of the
packed ``(L, 2P)`` float32 sums and one ``all_gather`` of the per-agent
returns (and squared norms) a round join the ranks; every rank then runs
the same K1 server tail and ends with the same theta and history.  Reward,
``gain_mean``, the participation rate and the norm probes reduce over the
gathered fleet in the run's fixed order and are bitwise the run's off the
mesh; ``grad_sq``, the update, theta and the SNR carry the cross-rank
association.  Staleness does not compose with a mesh, participation needs
``agent_blocks``, and so does an N the ranks do not divide (JAX's guards).

:func:`run_jit` is JAX's compiled entry point in eager PyTorch: :func:`run`
after the same normalisation of the participation and staleness configs
that keys JAX's cache, so a full-participation config hits the same cached
lane program (``lanes.lanes_for``) as ``None``.  The port's caches (that
one, the moves tables of ``rl/env.py`` and ``rl/envs/gridworld.py``, the
power-control moments) are listed in one place, and
:func:`clear_compilation_cache` empties them all, modules' own registered
ones (:func:`register_compiled_cache`) included.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import gpomdp, ota, power_control
from repro_torch.core.ota import OTAConfig
from repro_torch.launch.mesh import AgentMesh
from repro_torch.rl.envs.heterogeneous import block_env, check_agent_count
from repro_torch.rl.sampler import rollout_batch
from repro_torch.service import participation as svc_part
from repro_torch.service import staleness as svc_stale
from repro_torch.service.participation import (
    ParticipationConfig, ServiceState,
)
from repro_torch.service.staleness import StalenessConfig
from repro_torch.telemetry import probes as _probes
from repro_torch.telemetry.probes import RoundTelemetry, TelemetryConfig
from repro_torch.utils.device import DeviceLike
from repro_torch.utils.tree import Params, fixed_sum


@dataclass(frozen=True)
class FedPGConfig:
    n_agents: int = 10           # N
    batch_m: int = 10            # M (trajectories per agent per round)
    horizon: int = 20            # T
    gamma: float = 0.99
    alpha: float = 1e-4          # step size
    n_rounds: int = 200          # K
    estimator: str = "gpomdp"    # or "reinforce"


class _Metrics(NamedTuple):
    rewards: torch.Tensor
    grad_sq: torch.Tensor
    gain_mean: torch.Tensor


class History(_Metrics):
    """Per-round training metrics, each (K,) (or (runs, K) from
    :func:`monte_carlo`), and ``telemetry``: the round probes
    (:class:`RoundTelemetry` of the same shapes) when the run had an active
    ``TelemetryConfig``, else None.  ``telemetry`` is an attribute, not a
    field, so a History iterates (and compares) as its three metrics."""

    def __new__(cls, rewards, grad_sq, gain_mean,
                telemetry: Optional[RoundTelemetry] = None):
        self = super().__new__(cls, rewards, grad_sq, gain_mean)
        self.telemetry = telemetry
        return self

    def lane(self, i) -> "History":
        """Lane (run, or scenario) ``i`` of a batched History."""
        return History(*(x[i] for x in self),
                       telemetry=_probes.index(self.telemetry, i))


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
                  staleness: Optional[StalenessConfig] = None,
                  telemetry: Optional[TelemetryConfig] = None,
                  agent_mesh: Optional[AgentMesh] = None) -> RoundFn:
    """One communication round:
    ``round_fn(theta, generator, draws=None) -> (theta', (reward, grad_sq,
    gain_mean))``.  ``ota_backend`` picks the uplink ("torch" | "cuda" |
    "auto", see :class:`repro_torch.core.ota.AggregateSpec`).
    ``agent_blocks`` streams the agent axis in blocks of that many agents:
    the history is bitwise the same for every block size, with the stacked
    round's draws (module docstring).  An active ``participation`` config
    makes it a service round over a :class:`ServiceState` (module
    docstring).  An active ``telemetry`` appends the round's
    :class:`RoundTelemetry` to the metrics.  ``agent_mesh`` runs the round
    on this rank's slice of the fleet (module docstring; injected draws are
    the whole fleet's).  The round is one lane of ``core/lanes.py``
    (:func:`lanes.lane_round_fn`)."""
    if cfg.estimator not in gpomdp.ESTIMATORS:
        raise ValueError(f"unknown estimator {cfg.estimator!r}")
    if ota_cfg is not None:
        power_control.check_agent_count(ota_cfg.channel, cfg.n_agents)
    check_agent_count(env, cfg.n_agents)
    part = svc_part.normalize(participation, cfg.n_agents)
    stale_cfg = svc_stale.normalize(staleness, part)
    telem = _probes.active(telemetry, part)
    if agent_blocks is not None:
        ota.blocked_layout(cfg.n_agents, agent_blocks)   # validates it
    from repro_torch.core import lanes

    return lanes.lane_round_fn(env, policy, cfg, ota_cfg, ota_backend, part,
                               stale_cfg, telem, agent_blocks, agent_mesh)


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


# ---------------------------------------------------------------------------
# Service rounds: participation masks, staleness replay, W renormalisation.
# ---------------------------------------------------------------------------

class _RoundWeights(NamedTuple):
    """A service round's mask and normaliser scalars, computed from the
    mask and age vectors before any agent work, so every round form (the
    stacked lanes, streamed at any block size) computes them alike."""

    mask: torch.Tensor          # (..., N) bool
    count_p: torch.Tensor       # participating count, float32
    rw: Optional[torch.Tensor]  # (..., N) replay weights (staleness)
    w_norm: torch.Tensor        # the normaliser W (realised or expected)
    inv_w: torch.Tensor         # 1 / W, 0 at W == 0


def _round_mask(part: ParticipationConfig, seed, round_idx: int, n: int,
                dev, d: RoundDraws, *, rate=None,
                deadline=None) -> torch.Tensor:
    """The round's participation mask, faults included, or the injected
    one (``svc_part.round_mask``; ``(L, 1)`` seeds give ``(L, N)``)."""
    if d.mask is not None:
        return d.mask.to(device=dev, dtype=torch.bool)
    return svc_part.round_mask(part, seed, round_idx,
                               torch.arange(n, device=dev), n, rate=rate,
                               deadline=deadline)


def _round_weights(part: ParticipationConfig,
                   stale_cfg: Optional[StalenessConfig], mask: torch.Tensor,
                   age: Optional[torch.Tensor], expected: torch.Tensor,
                   decay=None) -> _RoundWeights:
    """``expected``: the closed-form W as a float32 device value (no
    host-to-device copy a round), used under expected debias."""
    count_p = torch.sum(mask.float(), dim=-1)
    rw = None
    w_real = count_p
    if stale_cfg is not None:
        rw = svc_stale.replay_weights(stale_cfg, mask, age, decay)
        w_real = count_p + fixed_sum(rw, -1)
    w_norm = w_real if part.debias == "realized" else expected
    return _RoundWeights(mask, count_p, rw, w_norm, svc_part.safe_inv(w_norm))


def _service_reward(returns: torch.Tensor, rw: _RoundWeights,
                    batch_m: int) -> torch.Tensor:
    """Minus the participants' mean discounted loss."""
    kept = torch.where(rw.mask[..., None], returns, torch.zeros_like(returns))
    return -fixed_sum(kept.reshape(kept.shape[:-2] + (-1,)), -1) \
        * svc_part.safe_inv(rw.count_p) / batch_m


def _service_gain_mean(hm: torch.Tensor, rw: _RoundWeights) -> torch.Tensor:
    return fixed_sum(hm, -1) * svc_part.safe_inv(rw.count_p)


def _service_probes(telem: TelemetryConfig, probes: RoundTelemetry,
                    stale_cfg: Optional[StalenessConfig], rw: _RoundWeights,
                    age: Optional[torch.Tensor], n: int, rate_expected,
                    decay=None) -> RoundTelemetry:
    stale_age = None
    if stale_cfg is not None:
        stale_age = svc_stale.stats(stale_cfg, rw.mask, age, decay)[2]
    return _probes.participation_probes(
        telem, probes, rate_realized=rw.count_p / n,
        rate_expected=rate_expected, staleness_mean=stale_age)


def env_on(env, dev):
    """Tabular tables and per-agent stacks follow the run to its device."""
    return env.to(dev) if hasattr(env, "to") else env


def run(env, policy, cfg: FedPGConfig, seed: int = 0, *,
        ota: Optional[OTAConfig] = None, theta0: Optional[Params] = None,
        ota_backend: str = "auto", agent_blocks: Optional[int] = None,
        participation: Optional[ParticipationConfig] = None,
        staleness: Optional[StalenessConfig] = None,
        telemetry: Optional[TelemetryConfig] = None,
        agent_mesh: Optional[AgentMesh] = None,
        device: DeviceLike = None) -> Tuple[Params, History]:
    """Run K rounds from ``torch.Generator(device).manual_seed(seed)``;
    returns ``(theta_K, History)``.  ``ota=None`` is Algorithm 1, an
    ``OTAConfig`` Algorithm 2.  ``agent_blocks`` streams the agent axis (see
    :func:`make_round_fn`).  ``participation`` / ``staleness`` run service
    rounds (a config that normalises away runs the plain rounds, bit for
    bit).  ``telemetry`` fills ``History.telemetry`` with ``(K,)`` probes.
    ``device=None`` means ``cuda`` and raises when no GPU is present.
    ``agent_mesh`` splits the fleet across the mesh's ranks (module
    docstring): call it on every rank; the run is on the rank's device.
    The run is one lane of ``core/lanes.py``."""
    from repro_torch.core import lanes

    part = svc_part.normalize(participation, cfg.n_agents)
    stale_cfg = svc_stale.normalize(staleness, part)
    theta, hist = lanes.run_lanes(
        env, policy, cfg, [lanes.LaneSpec(seed, cfg.alpha, ota, None, part,
                                          stale_cfg)],
        theta0=theta0, telemetry=telemetry, ota_backend=ota_backend,
        agent_blocks=agent_blocks, agent_mesh=agent_mesh, device=device)
    return {k: v[0] for k, v in theta.items()}, hist.lane(0)


# every cache of the package that one reset must empty; other modules
# (core/lanes.py) register theirs
_COMPILED_CACHES: list = []


def register_compiled_cache(cache) -> None:
    """Add a cache (anything with ``cache_clear()``) to the ones
    :func:`clear_compilation_cache` empties."""
    _COMPILED_CACHES.append(cache)


def compiled_caches() -> list:
    """Every cache :func:`clear_compilation_cache` empties: the moves
    tables, the power-control moments, and the registered ones."""
    from repro_torch.rl import env as rl_env
    from repro_torch.rl.envs import gridworld

    return [rl_env._moves, gridworld._moves,
            power_control.effective_moments] + _COMPILED_CACHES


def clear_compilation_cache() -> None:
    """Drop every cached program and table (mainly for tests): the lane
    programs and whatever :func:`compiled_caches` lists."""
    for cache in compiled_caches():
        cache.cache_clear()


def run_jit(env, policy, cfg: FedPGConfig, seed: int = 0, *,
            ota: Optional[OTAConfig] = None, theta0: Optional[Params] = None,
            ota_backend: str = "auto", agent_blocks: Optional[int] = None,
            participation: Optional[ParticipationConfig] = None,
            staleness: Optional[StalenessConfig] = None,
            telemetry: Optional[TelemetryConfig] = None,
            agent_mesh: Optional[AgentMesh] = None,
            device: DeviceLike = None) -> Tuple[Params, History]:
    """JAX's compiled entry point: :func:`run`, bit for bit, with the
    participation and staleness configs normalised first, as JAX's
    ``run_jit`` normalises them before keying its compiled program (a
    full-participation config is the same run, and the same cached lane
    program, as ``None``).  Repeated calls with equal hashable settings
    reuse the lane program (``lanes.lanes_for``); eager PyTorch has no
    program to compile, so that reuse is all there is to cache."""
    part = svc_part.normalize(participation, cfg.n_agents)
    stale_cfg = svc_stale.normalize(staleness, part)
    return run(env, policy, cfg, seed, ota=ota, theta0=theta0,
               ota_backend=ota_backend, agent_blocks=agent_blocks,
               participation=part, staleness=stale_cfg, telemetry=telemetry,
               agent_mesh=agent_mesh, device=device)


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
                telemetry: Optional[TelemetryConfig] = None,
                agent_mesh: Optional[AgentMesh] = None,
                device: DeviceLike = None) -> History:
    """``n_runs`` independent repetitions (the paper uses 20), one generator
    each (seeds :func:`run_seeds`); the History fields gain a leading
    (n_runs,) axis.  The repetitions run as the lanes of one lane-batched
    run (``core/lanes.py``), stacked or streamed (``agent_blocks``), each
    lane bitwise :func:`run` with its seed.  With ``agent_mesh`` the runs
    times this rank's agents run as one lane-batched round."""
    from repro_torch.core import lanes

    part = svc_part.normalize(participation, cfg.n_agents)
    stale_cfg = svc_stale.normalize(staleness, part)
    specs = [lanes.LaneSpec(seed=s, alpha=cfg.alpha, ota=ota,
                            participation=part, staleness=stale_cfg)
             for s in run_seeds(seed, n_runs)]
    return lanes.run_lanes(env, policy, cfg, specs, telemetry=telemetry,
                           ota_backend=ota_backend, agent_blocks=agent_blocks,
                           agent_mesh=agent_mesh, device=device)[1]
