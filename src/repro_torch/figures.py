"""The paper's figure and table settings, as the port runs them.

Counterpart of the settings in the JAX package's ``benchmarks/`` (outside
that package, so the port keeps its own copy): each function is named after
its source and builds the same scenarios from the port's classes, so
``sweep.sweep``, ``event_triggered.run``, ``rollout_batch``, ``gpomdp`` and
``ota.aggregate`` run the published settings unchanged.

* :func:`fig12_scenarios` — ``benchmarks/fig12_rayleigh.py``: the five
  (N, M) settings of Figs. 1-2 (Rayleigh, debias).
* :func:`fig3_scenarios`, :func:`iters_to_90pct` —
  ``benchmarks/fig3_vs_vanilla.py``: the over-the-air uplink against the
  exact one, and the rounds each takes to reach 90 % of the exact uplink's
  improvement.
* :func:`fig45_scenarios`, :func:`aggregation_error_floor` —
  ``benchmarks/fig45_nakagami.py``: Nakagami(0.1, 1) against Rayleigh at
  M = 1 and 10, and the Lemma-3 aggregation error E||u - grad J||^2 at a
  fixed policy.
* :func:`et_setting`, :func:`et_scenario` — ``benchmarks/et_baseline.py``.
* :func:`theory_scenarios`, :func:`theory_bounds` —
  ``benchmarks/theory_table.py``: the Theorem 1/2 bounds beside the
  simulated ``avg_grad_sq`` on a tabular MDP.
* :func:`power_control_scenarios`, :func:`power_control_rows`,
  :func:`round_gain_variance`, :func:`floor_moves` —
  ``benchmarks/fig_power_control.py``: seven power policies over Rayleigh
  on a tabular MDP, each row's effective moments, applicable bound and
  variance floor, and the variance of a round's mean gain they imply.
* :func:`env_zoo_scenarios`, :func:`lbar_row` —
  ``benchmarks/fig_env_zoo.py``: seven environment families under the
  exact and the Rayleigh uplink, three wind lanes, and the Assumption-1
  envelope at the configured horizon.
* :func:`participation_grids`, :func:`participation_baseline`,
  :func:`participation_driver`, :func:`expected_replay_age` —
  ``benchmarks/fig_participation.py``: the Bernoulli rate x staleness
  sweeps at N = 10^4 streamed in blocks of 64, the full-participation
  baseline, the round-service driver's setting, and the mean replayed
  age a rate implies.
* :func:`hold` — the test that holds the port's per-run values to the
  reference's mean: a z in combined standard errors, ``|z| < HOLD_Z``.

The port's generators are not JAX's threefry, so no figure number is
bitwise the reference's: the runs are compared in distribution.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs.ota_pg_particle import NAKAGAMI, RAYLEIGH
from repro_torch.core import gpomdp, ota, theory
from repro_torch.core.channel import (
    NakagamiChannel, RayleighChannel, make_channel,
)
from repro_torch.core.fedpg import FedPGConfig
from repro_torch.core.ota import OTAConfig
from repro_torch.core.power_control import (
    ConstantReceived, FullInversion, HeterogeneousBudget, TruncatedInversion,
    make_controlled_channel,
)
from repro_torch.core.sweep import Scenario, grid
from repro_torch.rl.env import LandmarkNav, TabularMDP
from repro_torch.rl.envs import (
    CliffWalk, LQRTask, MultiLandmarkNav, WindyLandmarkNav,
    make_heterogeneous_env,
)
from repro_torch.service import (
    FaultConfig, ParticipationConfig, ServiceConfig, StalenessConfig,
    StragglerModel,
)
from repro_torch.rl.policy import MLPPolicy
from repro_torch.rl.sampler import rollout_batch
from repro_torch.telemetry.probes import TelemetryConfig
from repro_torch.utils.device import DeviceLike, make_generator, resolve_device
from repro_torch.utils.tree import Params, tree_global_norm_sq, tree_sub

HOLD_Z = 4.0                   # combined standard errors allowed
HEAVY_TAIL_RATIO = 10.0        # largest reference value over its median
FIG12_SETTINGS = [(1, 10), (5, 10), (10, 10), (10, 1), (10, 5)]  # (N, M)
FIG45_BATCHES = (1, 10)
ET_TAUS = (0.01, 0.1)


# ---------------------------------------------------------------------------
# Figs. 1-2 and 3
# ---------------------------------------------------------------------------

def fig12_scenarios(n_rounds, alpha):
    """``benchmarks/fig12_rayleigh.py``'s scenarios, from the port's copy of
    the RAYLEIGH preset: the five (N, M) settings, debias on."""
    ch = make_channel(RAYLEIGH.channel, **dict(RAYLEIGH.channel_kwargs))
    return [Scenario(channel=ch, noise_sigma=RAYLEIGH.noise_sigma,
                     alpha=alpha, n_agents=n, batch_m=m,
                     horizon=RAYLEIGH.horizon, gamma=RAYLEIGH.gamma,
                     n_rounds=n_rounds, debias=True, tag=f"N{n}_M{m}")
            for n, m in FIG12_SETTINGS]


def fig3_scenarios(n_rounds: int, n_agents: int, batch_m: int,
                   alpha: float) -> List[Scenario]:
    """``benchmarks/fig3_vs_vanilla.py:23``: the Rayleigh over-the-air
    uplink with debias (``ota``) and the exact uplink (``vanilla``)."""
    base = dict(noise_sigma=RAYLEIGH.noise_sigma, alpha=alpha,
                n_agents=n_agents, batch_m=batch_m, horizon=RAYLEIGH.horizon,
                gamma=RAYLEIGH.gamma, n_rounds=n_rounds)
    return [Scenario(channel=make_channel("rayleigh"), debias=True,
                     tag="ota", **base),
            Scenario(channel=None, tag="vanilla", **base)]


def iters_to_90pct(r_ota, r_van, n_rounds: int) -> Tuple[int, int]:
    """``benchmarks/fig3_vs_vanilla.py:46-58``: from ``(runs, K)`` reward
    arrays, the first round at which each run-mean trajectory reaches
    ``base + 0.9 (final - base)``, with ``base`` the exact uplink's mean
    over its first 10 rounds and ``final`` over its last 20; a trajectory
    that never reaches it gives ``n_rounds``.  Means in float32 and the
    target compared in float32, as the JAX package's ``jnp`` does."""
    r_ota = np.asarray(r_ota, np.float32)
    r_van = np.asarray(r_van, np.float32)
    base = float(np.mean(r_van[:, :10], dtype=np.float32))
    final = float(np.mean(r_van[:, -20:], dtype=np.float32))
    target = np.float32(base + 0.9 * (final - base))

    def first_hit(traj):
        hits = np.nonzero(traj >= target)[0]
        return int(hits[0]) if hits.size else int(n_rounds)

    return (first_hit(np.mean(r_ota, axis=0, dtype=np.float32)),
            first_hit(np.mean(r_van, axis=0, dtype=np.float32)))


def same_order(it_ota: int, it_van: int) -> bool:
    """Fig. 3's claim (``fig3_vs_vanilla.py:65``): the over-the-air uplink
    converges within twice the exact uplink's rounds."""
    return it_ota <= 2 * max(it_van, 1)


# ---------------------------------------------------------------------------
# Figs. 4-5
# ---------------------------------------------------------------------------

def fig45_scenarios(n_rounds: int, n_agents: int,
                    alpha: float = 1e-3) -> List[Scenario]:
    """``benchmarks/fig45_nakagami.py:18``: {Nakagami(0.1, 1), Rayleigh} x
    M in {1, 10}, debias on, tagged ``<channel>_M<m>``."""
    scens = []
    for setting in (NAKAGAMI, RAYLEIGH):
        ch = make_channel(setting.channel, **dict(setting.channel_kwargs))
        for m in FIG45_BATCHES:
            scens.append(Scenario(
                channel=ch, noise_sigma=setting.noise_sigma, alpha=alpha,
                n_agents=n_agents, batch_m=m, horizon=setting.horizon,
                gamma=setting.gamma, n_rounds=n_rounds, debias=True,
                tag=f"{setting.name}_M{m}"))
    return scens


def fig4_claim(final_reward: Dict[Tuple[str, int], float]) -> bool:
    """Fig. 4 (``fig45_nakagami.py:47``): Nakagami is no better than
    Rayleigh at M = 10, by the final reward, within 0.05."""
    return final_reward[("nakagami", 10)] < final_reward[("rayleigh", 10)] \
        + 0.05


def fig5_penalties(floor: Dict[Tuple[str, int], float]) -> Tuple[float,
                                                                 float]:
    """The Nakagami aggregation error over Rayleigh's at M = 1 and 10
    (``fig45_nakagami.py:71-72``)."""
    return tuple(floor[("nakagami", m)] / max(floor[("rayleigh", m)], 1e-9)
                 for m in FIG45_BATCHES)


def fig5_claim(floor: Dict[Tuple[str, int], float]) -> bool:
    """Fig. 5 (``fig45_nakagami.py:75``): increasing M does not buy back the
    channel's penalty: it stays above half its M = 1 value and above 3."""
    p1, p10 = fig5_penalties(floor)
    return p10 > 0.5 * p1 and p10 > 3.0


def floor_error(grads: Params, cfg: OTAConfig, g_ref: Params, *,
                generator: Optional[torch.Generator] = None,
                gains: Optional[torch.Tensor] = None, seed=None
                ) -> torch.Tensor:
    """One draw of the Lemma-3 aggregation error: ``||u - g_ref||^2`` with
    ``u`` the over-the-air aggregate of the ``(N, ...)`` stack ``grads``
    (``ota.aggregate``: one K1 launch on the card)."""
    u, _ = ota.aggregate(grads, cfg, generator=generator, gains=gains,
                         seed=seed)
    return tree_global_norm_sq(tree_sub(u, g_ref))


class FloorValue(NamedTuple):
    mean: float
    se: float
    per_draw: np.ndarray     # (n_draws,) float64


FLOOR_SEED = 3                 # fig45_nakagami.py: jax.random.key(3)
REF_BATCHES, REF_BATCH = 8, 4096   # grad J: 8 gradients of 4096 each
DRAW_BLOCK = 200               # draws rolled out at once


def aggregation_error_floor(theta, n_agents: int = 10, n_draws: int = 400,
                            *, device: DeviceLike = None
                            ) -> Dict[Tuple[str, int], FloorValue]:
    """``benchmarks/fig45_nakagami.py:80``: the Lemma-3 aggregation error
    E||u - grad J||^2 at the policy ``theta`` (a dict of arrays; the
    reference's are ``MLPPolicy().init(jax.random.key(0))``'s, carried as
    numpy), for each (channel, M) of Figs. 4-5.  ``grad J`` is the mean of
    :data:`REF_BATCHES` G(PO)MDP gradients of :data:`REF_BATCH` trajectories
    each; each draw rolls out N agents x M trajectories, forms their
    gradients and aggregates them (debias on; one K1 launch a draw on the
    card).  Every draw comes from one generator seeded :data:`FLOOR_SEED`,
    :data:`DRAW_BLOCK` draws rolled out at a time.  Returns each
    (channel, M)'s mean, standard error and per-draw values."""
    dev = resolve_device(device)
    env, pol = LandmarkNav(), MLPPolicy()
    theta = interop.from_numpy(theta, dev)
    gen = make_generator(FLOOR_SEED, dev)
    refs = [gpomdp.gpomdp_gradient(
        pol, theta, rollout_batch(env, pol, theta, gen, 20, (REF_BATCH,)),
        0.99) for _ in range(REF_BATCHES)]
    g_ref = {k: torch.mean(torch.stack([g[k] for g in refs]), 0)
             for k in theta}
    out = {}
    for setting in (RAYLEIGH, NAKAGAMI):
        ch = make_channel(setting.channel, **dict(setting.channel_kwargs))
        cfg = OTAConfig(channel=ch, noise_sigma=setting.noise_sigma,
                        debias=True)
        for m in FIG45_BATCHES:
            errs = []
            for lo in range(0, n_draws, DRAW_BLOCK):
                b = min(DRAW_BLOCK, n_draws - lo)
                trajs = rollout_batch(env, pol, theta, gen, 20,
                                      (b, n_agents, m))
                grads = gpomdp.per_agent_gradients(pol, theta, trajs, 0.99)
                errs += [floor_error({k: v[j] for k, v in grads.items()},
                                     cfg, g_ref, generator=gen)
                         for j in range(b)]
            e = torch.stack(errs).double().cpu().numpy()
            mean, se = mean_se(e)
            out[(setting.name, m)] = FloorValue(mean, se, e)
    return out


# ---------------------------------------------------------------------------
# The event-triggered baseline
# ---------------------------------------------------------------------------

def et_setting(n_rounds: int = 200, n_agents: int = 20, batch_m: int = 5,
               alpha: float = 3e-3) -> Tuple[FedPGConfig, OTAConfig]:
    """``benchmarks/et_baseline.py:26-31``: the rounds' config (T and gamma
    at ``FedPGConfig``'s defaults) and the Rayleigh uplink with debias."""
    cfg = FedPGConfig(n_agents=n_agents, batch_m=batch_m, n_rounds=n_rounds,
                      alpha=alpha)
    return cfg, OTAConfig(channel=make_channel("rayleigh"),
                          noise_sigma=RAYLEIGH.noise_sigma, debias=True)


def et_scenario(cfg: FedPGConfig, cfg_ota: OTAConfig) -> Scenario:
    """The over-the-air run of :func:`et_setting` as one sweep scenario, so
    its Monte-Carlo runs are the lanes of one batched run."""
    return Scenario(channel=cfg_ota.channel, noise_sigma=cfg_ota.noise_sigma,
                    alpha=cfg.alpha, n_agents=cfg.n_agents,
                    batch_m=cfg.batch_m, horizon=cfg.horizon,
                    gamma=cfg.gamma, n_rounds=cfg.n_rounds,
                    debias=cfg_ota.debias, tag="ota")


# ---------------------------------------------------------------------------
# The Theorem 1/2 table
# ---------------------------------------------------------------------------

THEORY_CONSTANTS = theory.MDPConstants(G=math.sqrt(2.0), F=0.5, l_bar=1.0,
                                       gamma=0.9)
THEORY_AGENTS, THEORY_BATCH = 8, 4
THEORY_NOISE_SIGMA, THEORY_NOISE_SIGMA2 = 1e-3, 1e-6


def tabular_mdp(arrays, gamma: float = 0.9, horizon: int = 3,
                device: DeviceLike = None) -> TabularMDP:
    """The tabular MDP from its ``P``, ``l``, ``rho`` arrays (the
    reference's ``TabularMDP.random(jax.random.key(0), 3, 2, 0.9, 3)``,
    carried as numpy: the port's ``random`` draws other tables)."""
    t = interop.from_numpy({k: arrays[k] for k in ("P", "l", "rho")},
                           device)
    return TabularMDP(P=t["P"], l=t["l"], rho=t["rho"], gamma=gamma,
                      horizon=horizon)


def theory_channels():
    """``theory_table.py:33-40``: (channel, tag, theorem) of each row —
    Rayleigh, Nakagami(0.1, 1) and Rayleigh under truncated inversion (the
    bound takes the controlled channel's effective moments)."""
    return [(RayleighChannel(), "rayleigh", 1),
            (NakagamiChannel(m=0.1, omega=1.0), "nakagami", 2),
            (make_controlled_channel(RayleighChannel(), TruncatedInversion()),
             "rayleigh_trunc_inv", 1)]


def theory_scenarios(mdp, n_rounds: int) -> List[Scenario]:
    """``theory_table.py:41-49``: one scenario a channel row, alpha =
    min(1e-2, the Theorem 1/2 step-size limit at the channel's mean)."""
    c = THEORY_CONSTANTS
    return [Scenario(channel=ch, noise_sigma=THEORY_NOISE_SIGMA,
                     alpha=min(1e-2, c.max_stepsize(ch.mean)),
                     n_agents=THEORY_AGENTS, batch_m=THEORY_BATCH,
                     horizon=mdp.horizon, gamma=mdp.gamma,
                     n_rounds=n_rounds, debias=True, tag=name)
            for ch, name, _ in theory_channels()]


def theory_bounds(scenarios: Sequence[Scenario], n_rounds: int
                  ) -> List[Dict[str, float]]:
    """``theory_table.py:52-60``: each row's theorem, alpha and bound, with
    Delta_J = 1 / (1 - gamma) and V from :data:`THEORY_CONSTANTS`."""
    c = THEORY_CONSTANTS
    rows = []
    for s, (ch, name, thm) in zip(scenarios, theory_channels()):
        kw = dict(K=n_rounds, n_agents=THEORY_AGENTS, batch_m=THEORY_BATCH,
                  alpha=s.alpha, m_h=ch.mean, sigma_h2=ch.var,
                  noise_sigma2=THEORY_NOISE_SIGMA2,
                  delta_J=1.0 / (1 - c.gamma), V=c.V())
        bound = (theory.theorem1_bound(**kw) if thm == 1
                 else theory.theorem2_bound(**kw))
        rows.append({"tag": name, "theorem": thm, "alpha": s.alpha,
                     "bound": bound})
    return rows


# ---------------------------------------------------------------------------
# Beyond the paper: power control, the environment zoo, participation
# ---------------------------------------------------------------------------

PC_AGENTS, PC_BATCH = 8, 4     # fig_power_control.py's N_AGENTS, BATCH_M
PC_NOISE_SIGMA, PC_NOISE_SIGMA2 = 1e-3, 1e-6


def power_control_policies():
    """``fig_power_control.py:41-52``: the (tag, policy) rows; None is no
    power control (h = c)."""
    return [
        ("unit", None),
        ("trunc_inv_t0.8", TruncatedInversion(target=0.8)),
        ("trunc_inv_t1.0", TruncatedInversion(target=1.0)),
        ("trunc_inv_t1.2", TruncatedInversion(target=1.2)),
        ("full_inv", FullInversion(target=1.0)),
        ("const_recv", ConstantReceived(target=1.0)),
        ("hetero_budget", HeterogeneousBudget(p_min=0.5, p_max=1.5)),
    ]


def power_control_scenarios(n_rounds: int, mdp, *,
                            n_agents: int = PC_AGENTS,
                            batch_m: int = PC_BATCH) -> List[Scenario]:
    """``fig_power_control.py:54-66``: each policy over Rayleigh, alpha =
    min(1e-2, the step-size limit at the controlled channel's mean), noise
    sigma 1e-3, debias on, the MDP's horizon and gamma."""
    base = RayleighChannel()
    out = []
    for tag, pol in power_control_policies():
        ch = base if pol is None else make_controlled_channel(
            base, pol, n_agents=n_agents)
        out.append(Scenario(
            channel=ch, noise_sigma=PC_NOISE_SIGMA,
            alpha=min(1e-2, THEORY_CONSTANTS.max_stepsize(float(ch.mean))),
            n_agents=n_agents, batch_m=batch_m, horizon=mdp.horizon,
            gamma=mdp.gamma, n_rounds=n_rounds, debias=True, tag=tag))
    return out


def power_control_rows(scenarios: Sequence[Scenario]
                       ) -> List[Dict[str, Any]]:
    """``fig_power_control.py:80-92``: each scenario's effective moments,
    the tighter applicable theorem and its bound after the scenario's K
    rounds, and that theorem's K -> inf floor, with Delta_J = 1 / (1 -
    gamma)."""
    c = THEORY_CONSTANTS
    rows = []
    for s in scenarios:
        m_h, v_h = s.effective_moments()
        which, bound = theory.applicable_bound(
            K=s.n_rounds, n_agents=s.n_agents, batch_m=s.batch_m,
            alpha=s.alpha, m_h=m_h, sigma_h2=v_h,
            noise_sigma2=PC_NOISE_SIGMA2,
            delta_J=1.0 / (1 - c.gamma), V=c.V())
        floor = (theory.theorem1_floor if which == "theorem1"
                 else theory.theorem2_floor)(
            n_agents=s.n_agents, batch_m=s.batch_m, m_h=m_h, sigma_h2=v_h,
            noise_sigma2=PC_NOISE_SIGMA2, V=c.V())
        rows.append({"tag": s.tag, "alpha": s.alpha, "m_h_eff": m_h,
                     "sigma_h2_eff": v_h, "which": which, "bound": bound,
                     "floor": floor})
    return rows


def round_gain_variance(s: Scenario, row: Dict[str, Any]) -> float:
    """The variance of one round's mean gain over the scenario's N agents,
    each agent's h drawn independently: sigma_h^2 / N where the agents are
    alike.  ``HeterogeneousBudget``'s sigma_h^2 is the mixture's over a
    random agent, so the spread of its agents' means, Var_i(b_i) m_c^2,
    leaves it first: the round mean sees only mean_i(b_i^2) Var(c) / N."""
    v = row["sigma_h2_eff"]
    pol = getattr(s.channel, "policy", None)
    if isinstance(pol, HeterogeneousBudget):
        b = np.linspace(pol.p_min, pol.p_max, s.n_agents)
        v -= float(b.var()) * float(s.channel.base.mean) ** 2
    return v / s.n_agents


def floor_moves(floors: Dict[str, float]) -> bool:
    """``fig_power_control.py:101-109``: phase-aware inversion's floor below
    truncated inversion's, below no power control's."""
    return floors["const_recv"] < floors["trunc_inv_t1.0"] < floors["unit"]


ZOO_AGENTS, ZOO_BATCH, ZOO_HORIZON = 4, 4, 10   # fig_env_zoo.py:38
ZOO_ALPHA, ZOO_NOISE_SIGMA = 1e-3, 1e-3
ZOO_WINDS = (0.0, 0.05, 0.1)
ZOO_TAIL = 10                  # fig_env_zoo.py:82: final_reward(i, tail=10)


def garnet_mdp(arrays, device: DeviceLike = None) -> TabularMDP:
    """The zoo's garnet from its ``P``, ``l``, ``rho`` arrays (the
    reference's ``garnet(jax.random.key(0), 6, 3, 2)``, carried as numpy:
    the port's generator draws other tables), at ``garnet``'s gamma 0.9
    and horizon 5."""
    return tabular_mdp(arrays, gamma=0.9, horizon=5, device=device)


def env_zoo_families(n_agents: int, garnet_env: TabularMDP):
    """``fig_env_zoo.py:41-54``: the (tag, env) rows, one a family."""
    return [
        ("landmark", LandmarkNav()),
        ("windy", WindyLandmarkNav(wind=0.05, gust_sigma=0.02)),
        ("multi", MultiLandmarkNav(n_landmarks=3)),
        ("cliff", CliffWalk(width=5, height=3, slip=0.1)),
        ("lqr", LQRTask()),
        ("garnet", garnet_env),
        ("hetero_windy", make_heterogeneous_env(
            [WindyLandmarkNav(wind=0.02 * i) for i in range(n_agents)])),
    ]


def env_zoo_scenarios(n_rounds: int, garnet_env: TabularMDP, *,
                      n_agents: int = ZOO_AGENTS, batch_m: int = ZOO_BATCH,
                      horizon: int = ZOO_HORIZON) -> List[Scenario]:
    """``fig_env_zoo.py:56-71``: each family under the exact uplink
    (``<tag>_exact``) and Rayleigh at noise 1e-3 (``<tag>_rayleigh``), then
    the three ``windlane_<w>`` scenarios."""
    base = dict(n_agents=n_agents, batch_m=batch_m, horizon=horizon,
                n_rounds=n_rounds, alpha=ZOO_ALPHA, debias=True)
    out = []
    for tag, env in env_zoo_families(n_agents, garnet_env):
        out.append(Scenario(env=env, channel=None, tag=f"{tag}_exact",
                            **base))
        out.append(Scenario(env=env, channel=RayleighChannel(),
                            noise_sigma=ZOO_NOISE_SIGMA,
                            tag=f"{tag}_rayleigh", **base))
    out.extend(Scenario(env=WindyLandmarkNav(wind=w),
                        channel=RayleighChannel(),
                        noise_sigma=ZOO_NOISE_SIGMA, tag=f"windlane_{w:g}",
                        **base)
               for w in ZOO_WINDS)
    return out


def lbar_row() -> Dict[str, Any]:
    """``fig_env_zoo.py:92-101``: the landmark envelope at the configured
    horizon against the fixed-T=20 one, and V from the former."""
    env = LandmarkNav()
    consts = theory.constants_for_env(env, horizon=ZOO_HORIZON, gamma=0.99,
                                      G=math.sqrt(2.0), F=0.5)
    stale = env.l_bar
    return {"l_bar_T10": consts.l_bar, "l_bar_T20": stale, "V": consts.V(),
            "pass": bool(consts.l_bar == env.l_bar_for(ZOO_HORIZON)
                         != stale)}


PART_AGENTS = 10_000           # fig_participation.py:42-45
PART_BLOCKS = 64
PART_RATES = (0.25, 0.5)
PART_STALE = (None, StalenessConfig(max_age=4, decay=0.8))
PART_ROUNDS = 5                # fig_participation.py:54, not --quick
PART_DRIVER_ROUNDS = 8


def participation_common(n_rounds: int = PART_ROUNDS, *,
                         n_agents: int = PART_AGENTS,
                         agent_blocks: int = PART_BLOCKS) -> Dict[str, Any]:
    """``fig_participation.py:55-57``: the axes every grid shares."""
    return dict(channel=[RayleighChannel()], noise_sigma=1e-3, debias=True,
                n_agents=n_agents, batch_m=1, horizon=3, n_rounds=n_rounds,
                agent_blocks=agent_blocks)


def participation_grids(n_rounds: int = PART_ROUNDS, **kw
                        ) -> List[Tuple[Optional[StalenessConfig],
                                        List[Scenario]]]:
    """``fig_participation.py:62-65``: one grid a staleness setting, the
    Bernoulli rates as its axis (``kw``: :func:`participation_common`'s)."""
    return [(stale, grid(staleness=stale,
                         participation=[ParticipationConfig(rate=r)
                                        for r in PART_RATES],
                         **participation_common(n_rounds, **kw)))
            for stale in PART_STALE]


def expected_replay_age(rate: float, max_age: int, n_rounds: int) -> float:
    """The run mean of the ``staleness_mean`` probe a Bernoulli-``rate``
    fleet expects over ``n_rounds`` rounds: round 0 replays nothing (0);
    at round r an agent that sat out is replayed from its last round r - a
    for a <= min(r, max_age), which it reached with weight rate (1 -
    rate)^(a - 1), so the round's mean age is that weight's mean of a."""
    ages = [0.0]
    for r in range(1, n_rounds):
        w = [rate * (1 - rate) ** (a - 1) for a in range(1, min(r, max_age)
                                                         + 1)]
        ages.append(sum(a * x for a, x in enumerate(w, 1)) / sum(w))
    return sum(ages) / n_rounds


def participation_baseline(n_rounds: int = PART_ROUNDS, **kw
                           ) -> List[Scenario]:
    """``fig_participation.py:85``: full participation, which
    normalises to the plain streamed round."""
    return grid(participation=[ParticipationConfig(kind="full")],
                **participation_common(n_rounds, **kw))


def participation_driver(max_rounds: int = PART_DRIVER_ROUNDS, *,
                         n_agents: int = PART_AGENTS,
                         agent_blocks: int = PART_BLOCKS) -> Dict[str, Any]:
    """``fig_participation.py:98-108``: the round-service driver's
    ``RoundService`` keyword arguments beyond env, policy and seed (rate
    0.5 with exp(1) stragglers closed at deadline 2, staleness (4, 0.8),
    two rounds a commit)."""
    part = ParticipationConfig(rate=0.5, faults=FaultConfig(
        stragglers=StragglerModel(dist="exp", mean=1.0), deadline=2.0))
    return dict(
        cfg=FedPGConfig(n_agents=n_agents, batch_m=1, horizon=3,
                        n_rounds=1),
        participation=part, staleness=StalenessConfig(max_age=4, decay=0.8),
        ota=OTAConfig(channel=RayleighChannel(), noise_sigma=1e-3,
                      debias=True),
        telemetry=TelemetryConfig(), agent_blocks=agent_blocks,
        service=ServiceConfig(rounds_per_commit=2, max_rounds=max_rounds,
                              round_deadline_s=600.0))


# ---------------------------------------------------------------------------
# Holding the port to the reference
# ---------------------------------------------------------------------------

def mean_se(x) -> Tuple[float, float]:
    """Mean and standard error over runs, in double."""
    x = np.asarray(x, np.float64)
    return float(x.mean()), float(x.std(ddof=1) / math.sqrt(x.size))


class Held(NamedTuple):
    mean: float
    se: float
    z: float

    @property
    def ok(self) -> bool:
        return abs(self.z) < HOLD_Z


def hold(port_runs, ref_mean: float, ref_se: float) -> Held:
    """The port's per-run values against the reference's mean and standard
    error: ``z = (mean - ref_mean) / hypot(se, ref_se)``.  Where neither
    side varies, z is 0 for equal means and infinite otherwise."""
    mean, se = mean_se(port_runs)
    den = math.hypot(se, ref_se)
    if den == 0.0:
        return Held(mean, se, 0.0 if mean == ref_mean else math.inf)
    return Held(mean, se, (mean - ref_mean) / den)


def heavy_tailed(ref_runs) -> bool:
    """Whether the reference's per-run values are positive and heavy
    tailed: the largest above :data:`HEAVY_TAIL_RATIO` times the median."""
    x = np.asarray(ref_runs, np.float64)
    return bool(x.min() > 0 and x.max() > HEAVY_TAIL_RATIO * np.median(x))


def hold_runs(port_runs, ref_runs) -> Tuple[str, Held]:
    """Hold the port's per-run values to the reference's: by their means,
    or by the means of their logs where the reference's values are heavy
    tailed (:func:`heavy_tailed`; decided from the reference alone).
    Returns the statistic's name and the result."""
    if heavy_tailed(ref_runs):
        lm, lse = mean_se(np.log(np.asarray(ref_runs, np.float64)))
        return "log_mean", hold(np.log(np.asarray(port_runs, np.float64)),
                                lm, lse)
    m, se = mean_se(ref_runs)
    return "mean", hold(port_runs, m, se)
