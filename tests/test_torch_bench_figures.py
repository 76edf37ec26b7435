"""The port's copies of the benchmarks beyond the paper (power control, the
environment zoo, participation at N = 10^4; ``repro_torch.figures``)
against the JAX package's, and a tiny run of each chip phase's code on the
CPU.

Scenario lists compare field for field (channels by their dataclass repr,
environments by their field values, service configs by their fields) and
partition alike (``partition_scenarios``, no run); the tabular MDPs the
reference files carry are bitwise JAX's draws from ``jax.random.key(0)``;
the closed-form columns and the l_bar row equal JAX's at rtol 1e-6; the
three reference files hold the port's declared settings.  The JAX scenario
lists are built once for the module, and no JAX sweep runs."""
import dataclasses
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from benchmarks import (  # noqa: E402
    fig_env_zoo, fig_participation, fig_power_control,
)
from repro.core import fedpg as jax_fedpg  # noqa: E402
from repro.core import ota as jax_ota  # noqa: E402
from repro.core import sweep as jax_sweep  # noqa: E402
from repro.core import theory as jax_theory  # noqa: E402
from repro.core.channel import RayleighChannel as JaxRayleigh  # noqa: E402
from repro.rl.env import LandmarkNav as JaxLandmarkNav  # noqa: E402
from repro.rl.env import TabularMDP as JaxTabularMDP  # noqa: E402
from repro.rl import sampler as jax_sampler  # noqa: E402
from repro.rl.envs import garnet as jax_garnet  # noqa: E402
from repro.rl.envs import make_env as jax_make_env  # noqa: E402
from repro.service import driver as jax_driver  # noqa: E402
from repro.service import faults as jax_faults  # noqa: E402
from repro.service import participation as jax_part  # noqa: E402
from repro.service import staleness as jax_stale  # noqa: E402
from repro.telemetry import probes as jax_probes  # noqa: E402
from repro_torch import figures, interop  # noqa: E402
from repro_torch.core import fedpg, sweep  # noqa: E402
from repro_torch.rl.envs import HeterogeneousEnv, make_env  # noqa: E402
from repro_torch.rl.policy import TabularSoftmaxPolicy  # noqa: E402
from repro_torch.service import RoundService  # noqa: E402
from repro_torch.service import participation as svc_part  # noqa: E402
from repro_torch.telemetry.probes import TelemetryConfig  # noqa: E402

N_TINY, M_TINY, T_TINY, K_TINY, RUNS_TINY = 3, 2, 3, 3, 2
PART_TINY_N, PART_TINY_BLOCKS = 64, 16


def _ref(name):
    return json.loads((ROOT / "perf" / name).read_text())


def _jax_mdp():
    return JaxTabularMDP.random(jax.random.key(0), n_states=3, n_actions=2,
                                gamma=0.9, horizon=3)


def _jax_consts():
    return jax_theory.MDPConstants(G=math.sqrt(2.0), F=0.5, l_bar=1.0,
                                   gamma=0.9)


def _jax_participation(n_agents=fig_participation.N_AGENTS,
                       agent_blocks=fig_participation.AGENT_BLOCKS,
                       n_rounds=5):
    """``fig_participation.py:55-65`` and ``:85``: the two rate grids and
    the baseline, as the benchmark builds them."""
    common = dict(channel=[JaxRayleigh()], noise_sigma=1e-3, debias=True,
                  n_agents=n_agents, batch_m=1, horizon=3,
                  n_rounds=n_rounds, agent_blocks=agent_blocks)
    grids = [(stale, jax_sweep.grid(
        staleness=stale, participation=[jax_part.ParticipationConfig(rate=r)
                                        for r in fig_participation.RATES],
        **common)) for stale in fig_participation.STALE]
    base = jax_sweep.grid(
        participation=[jax_part.ParticipationConfig(kind="full")], **common)
    return grids, base


@pytest.fixture(scope="module")
def jax_lists():
    """The benchmarks' own scenario lists, built once for the module."""
    grids, base = _jax_participation()
    return {"power": fig_power_control.scenarios(120, _jax_mdp(),
                                                 _jax_consts()),
            "zoo": fig_env_zoo.scenarios(120), "grids": grids,
            "baseline": base}


def _port_mdp(device="cpu"):
    ref = _ref("power_control_reference.json")
    return figures.tabular_mdp(ref["mdp"], ref["setting"]["gamma"],
                               ref["setting"]["horizon"], device=device)


def _port_garnet(device="cpu"):
    return figures.garnet_mdp(_ref("env_zoo_reference.json")["garnet"],
                              device=device)


def _same_env(port, ref):
    """An environment and the JAX one it copies: one type, equal fields
    (the JAX one carried across by ``interop.env_from_jax``)."""
    if ref is None:
        assert port is None
        return
    want = interop.env_from_jax(ref, "cpu")
    assert type(port) is type(want)
    if isinstance(want, HeterogeneousEnv):
        _same_env(port.base, ref.base)
        assert port.n_agents == want.n_agents
        assert sorted(port.params) == sorted(want.params)
        for k, v in want.params.items():
            assert torch.equal(port.params[k], v), k
        return
    for f in dataclasses.fields(want):
        x, y = getattr(port, f.name), getattr(want, f.name)
        if isinstance(y, torch.Tensor):
            assert torch.equal(x.cpu(), y), f.name
        else:
            assert x == y, f.name


def _fields(x):
    return None if x is None else dataclasses.asdict(x)


def _same_scenarios(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name in ("channel", "power_control"):
                assert repr(x) == repr(y), f.name
            elif f.name == "env":
                _same_env(x, y)
            elif f.name in ("participation", "staleness"):
                assert _fields(x) == _fields(y), f.name
            else:
                assert x == y, f.name


def _same_partitions(port, ref):
    assert [p.indices for p in sweep.partition_scenarios(port)] == \
        [p.indices for p in jax_sweep.partition_scenarios(ref)]


# ---------------------------------------------------------------------------
# the settings, field for field, and their partitions
# ---------------------------------------------------------------------------

def test_power_control_scenarios_equal_the_benchmarks(jax_lists):
    port = figures.power_control_scenarios(120, _port_mdp())
    _same_scenarios(port, jax_lists["power"])
    _same_partitions(port, jax_lists["power"])
    assert [t for t, _ in figures.power_control_policies()] == \
        [t for t, _ in fig_power_control._policies()]
    assert (figures.PC_AGENTS, figures.PC_BATCH) == (
        fig_power_control.N_AGENTS, fig_power_control.BATCH_M)
    assert dataclasses.asdict(figures.THEORY_CONSTANTS) == \
        dataclasses.asdict(_jax_consts())


def test_env_zoo_scenarios_equal_the_benchmarks(jax_lists):
    port = figures.env_zoo_scenarios(120, _port_garnet())
    _same_scenarios(port, jax_lists["zoo"])
    _same_partitions(port, jax_lists["zoo"])
    assert len(sweep.partition_scenarios(port)) < len(port)
    assert (figures.ZOO_AGENTS, figures.ZOO_BATCH, figures.ZOO_HORIZON) == (
        fig_env_zoo.N_AGENTS, fig_env_zoo.BATCH_M, fig_env_zoo.HORIZON)


def test_participation_grids_equal_the_benchmarks(jax_lists):
    port = figures.participation_grids()
    assert len(port) == len(jax_lists["grids"])
    for (stale, scens), (jstale, jscens) in zip(port, jax_lists["grids"]):
        assert _fields(stale) == _fields(jstale)
        _same_scenarios(scens, jscens)
        _same_partitions(scens, jscens)
    _same_scenarios(figures.participation_baseline(), jax_lists["baseline"])
    _same_partitions(figures.participation_baseline(),
                     jax_lists["baseline"])
    assert (figures.PART_AGENTS, figures.PART_BLOCKS, figures.PART_RATES) \
        == (fig_participation.N_AGENTS, fig_participation.AGENT_BLOCKS,
            fig_participation.RATES)
    # full participation normalises away in both packages
    for s, j in zip(figures.participation_baseline(), jax_lists["baseline"]):
        assert svc_part.normalize(s.participation, s.n_agents) is None
        assert jax_part.normalize(j.participation, j.n_agents) is None


def test_participation_driver_equals_the_benchmarks():
    """``fig_participation.py:98-108``."""
    kw = figures.participation_driver()
    want_cfg = jax_fedpg.FedPGConfig(n_agents=fig_participation.N_AGENTS,
                                     batch_m=1, horizon=3, n_rounds=1)
    want_part = jax_part.ParticipationConfig(
        rate=0.5, faults=jax_faults.FaultConfig(
            stragglers=jax_faults.StragglerModel(dist="exp", mean=1.0),
            deadline=2.0))
    want_svc = jax_driver.ServiceConfig(rounds_per_commit=2, max_rounds=8,
                                        round_deadline_s=600.0)
    assert dataclasses.asdict(kw["cfg"]) == dataclasses.asdict(want_cfg)
    assert _fields(kw["participation"]) == _fields(want_part)
    assert _fields(kw["staleness"]) == _fields(
        jax_stale.StalenessConfig(max_age=4, decay=0.8))
    assert _fields(kw["service"]) == _fields(want_svc)
    assert _fields(kw["telemetry"]) == _fields(jax_probes.TelemetryConfig())
    assert kw["agent_blocks"] == fig_participation.AGENT_BLOCKS
    assert repr(kw["ota"].channel) == repr(JaxRayleigh())
    assert (kw["ota"].noise_sigma, kw["ota"].debias,
            kw["ota"].power_control) == (1e-3, True, None)
    n = fig_participation.N_AGENTS
    assert svc_part.expected_count(kw["participation"], n) == \
        pytest.approx(jax_part.expected_count(want_part, n), rel=1e-12)


# ---------------------------------------------------------------------------
# the carried tables, the closed forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["power_control", "garnet"])
def test_carried_tables_are_jaxs_draws_bitwise(which):
    if which == "power_control":
        want, port = _jax_mdp(), _port_mdp()
        carried = _ref("power_control_reference.json")["mdp"]
    else:
        want = jax_garnet(jax.random.key(0), n_states=6, n_actions=3,
                          branching=2)
        port = _port_garnet()
        carried = _ref("env_zoo_reference.json")["garnet"]
    assert (port.gamma, port.horizon) == (want.gamma, want.horizon)
    for k in ("P", "l", "rho"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_array_equal(np.asarray(carried[k], np.float32), w)
        np.testing.assert_array_equal(getattr(port, k).numpy(), w)


def test_power_control_rows_equal_jax_closed_forms(jax_lists):
    """``fig_power_control.py:80-92`` with the JAX package, each column at
    rtol 1e-6, and the benchmark's ``floor_moves``."""
    consts = _jax_consts()
    V, delta_j = consts.V(), 1.0 / (1 - 0.9)
    rows = figures.power_control_rows(
        figures.power_control_scenarios(120, _port_mdp()))
    floors = {}
    for row, s in zip(rows, jax_lists["power"]):
        m_h, v_h = s.effective_moments()
        which, bound = jax_theory.applicable_bound(
            K=120, n_agents=8, batch_m=4, alpha=s.alpha, m_h=m_h,
            sigma_h2=v_h, noise_sigma2=1e-6, delta_J=delta_j, V=V)
        floor = (jax_theory.theorem1_floor if which == "theorem1"
                 else jax_theory.theorem2_floor)(
            n_agents=8, batch_m=4, m_h=m_h, sigma_h2=v_h, noise_sigma2=1e-6,
            V=V)
        assert (row["tag"], row["which"]) == (s.tag, which)
        for k, v in (("alpha", s.alpha), ("m_h_eff", m_h),
                     ("sigma_h2_eff", v_h), ("bound", bound),
                     ("floor", floor)):
            assert math.isclose(row[k], v, rel_tol=1e-6), (s.tag, k)
        floors[s.tag] = floor
    assert figures.floor_moves({r["tag"]: r["floor"] for r in rows})
    assert figures.floor_moves(floors)


def test_lbar_row_equals_jax():
    """``fig_env_zoo.py:92-101`` with the JAX package."""
    env = JaxLandmarkNav()
    consts = jax_theory.constants_for_env(env, horizon=10, gamma=0.99,
                                          G=math.sqrt(2.0), F=0.5)
    row = figures.lbar_row()
    for k, v in (("l_bar_T10", consts.l_bar), ("l_bar_T20", env.l_bar),
                 ("V", consts.V())):
        assert math.isclose(row[k], v, rel_tol=1e-6), k
    assert row["pass"] is bool(consts.l_bar == env.l_bar_for(10)
                               != env.l_bar) is True


# ---------------------------------------------------------------------------
# the reference files
# ---------------------------------------------------------------------------

def test_reference_files_hold_the_ports_settings():
    cs = chip_smoke
    pc = _ref("power_control_reference.json")
    s = pc["setting"]
    assert (s["n_rounds"], s["runs"], s["seed"], s["n_agents"], s["batch_m"],
            s["noise_sigma"], s["noise_sigma2"]) == (
        cs.PC_ROUNDS, cs.FIG_RUNS, cs.PC_SEED, figures.PC_AGENTS,
        figures.PC_BATCH, figures.PC_NOISE_SIGMA, figures.PC_NOISE_SIGMA2)
    scens = figures.power_control_scenarios(cs.PC_ROUNDS, _port_mdp())
    assert [r["tag"] for r in pc["rows"]] == [x.tag for x in scens]
    assert pc["n_partitions"] == len(sweep.partition_scenarios(scens))
    assert all(len(r["per_run_avg_grad_sq"]) == cs.FIG_RUNS
               for r in pc["rows"])
    for row, w in zip(figures.power_control_rows(scens),
                      pc["rows"]):
        assert row["which"] == w["which"]
        for k in ("alpha", "m_h_eff", "sigma_h2_eff", "bound", "floor"):
            assert math.isclose(row[k], w[k], rel_tol=1e-6), (w["tag"], k)
    assert pc["floor_moves"]

    z = _ref("env_zoo_reference.json")
    s = z["setting"]
    assert (s["n_rounds"], s["runs"], s["seed"], s["n_agents"], s["batch_m"],
            s["horizon"], s["alpha"], s["noise_sigma"],
            s["final_reward_tail"]) == (
        cs.ZOO_REF_ROUNDS, cs.FIG_RUNS, cs.ZOO_SEED, figures.ZOO_AGENTS,
        figures.ZOO_BATCH, figures.ZOO_HORIZON, figures.ZOO_ALPHA,
        figures.ZOO_NOISE_SIGMA, figures.ZOO_TAIL)
    scens = figures.env_zoo_scenarios(cs.ZOO_REF_ROUNDS, _port_garnet())
    assert [r["tag"] for r in z["rows"]] == [x.tag for x in scens]
    parts = sweep.partition_scenarios(scens)
    assert z["n_partitions"] == len(parts) < z["n_scenarios"] == len(scens)
    where = {i: j for j, p in enumerate(parts) for i in p.indices}
    assert [r["partition"] for r in z["rows"]] == [where[i] for i in
                                                   range(len(scens))]
    assert z["partitions_fewer"] and z["lbar"]["pass"]

    p = _ref("participation_reference.json")
    s = p["setting"]
    assert (s["n_rounds"], s["runs"], s["seed"], s["n_agents"],
            s["agent_blocks"], tuple(s["rates"]), s["driver_rounds"]) == (
        figures.PART_ROUNDS, cs.FIG_RUNS, cs.PART_SEED, figures.PART_AGENTS,
        figures.PART_BLOCKS, figures.PART_RATES, figures.PART_DRIVER_ROUNDS)
    for (stale, scens), w in zip(figures.participation_grids(), p["sweeps"]):
        assert w["staleness"] == (None if stale is None
                                  else [stale.max_age, stale.decay])
        assert w["n_partitions"] == len(sweep.partition_scenarios(scens))
        assert [r["rate"] for r in w["rows"]] == list(figures.PART_RATES)
        for r in w["rows"]:
            assert len(r["per_run_participation_rate"]) == cs.FIG_RUNS
    last = p["driver"]["last"]
    assert last["round_end"] == figures.PART_DRIVER_ROUNDS
    assert len(last["staleness_hist"]) == 4 + 2


# ---------------------------------------------------------------------------
# a tiny run of each chip phase's code on the CPU
# ---------------------------------------------------------------------------

def _finite(hist):
    return all(np.isfinite(np.asarray(x, np.float64)).all() for x in hist)


def test_power_control_phase_tiny():
    mdp = _port_mdp()
    scens = figures.power_control_scenarios(K_TINY, mdp, n_agents=N_TINY,
                                            batch_m=M_TINY)
    res = sweep.sweep(mdp, TabularSoftmaxPolicy(3, 2), scens, 1, RUNS_TINY,
                      device="cpu")
    assert _finite(res.history) and res.n_partitions == 5
    rows = figures.power_control_rows(scens)
    assert [r["tag"] for r in rows] == [s.tag for s in scens]
    assert all(res.avg_grad_sq(i) <= r["bound"] for i, r in enumerate(rows))
    assert isinstance(figures.floor_moves({r["tag"]: r["floor"]
                                           for r in rows}), bool)
    ref = _ref("power_control_reference.json")["rows"][0]
    stat, h = figures.hold_runs(res.history.grad_sq[0].mean(axis=1),
                                ref["per_run_avg_grad_sq"])
    assert stat == "mean" and math.isfinite(h.z)


@pytest.mark.parametrize("tag", [t for t, _ in
                                 figures.power_control_policies()])
def test_round_gain_variance_is_the_sampled_one(tag):
    """``figures.round_gain_variance`` against the variance of 2 10^4
    sampled rounds' mean gain (N=8) within 5 standard errors of a sample
    variance; const_recv's round means within 4 float32 ulps of m_h."""
    scens = figures.power_control_scenarios(120, _port_mdp())
    s, row = next((s, r) for s, r in zip(
        scens, figures.power_control_rows(scens)) if s.tag == tag)
    gen = torch.Generator().manual_seed(3)
    gm = s.channel.sample(gen, (20_000, s.n_agents), "cpu").double().mean(1)
    want = figures.round_gain_variance(s, row)
    if want == 0.0:
        assert (gm - row["m_h_eff"]).abs().max() <= 4 * 2 ** -23
        return
    var = gm.var().item()
    m4 = ((gm - gm.mean()) ** 4).mean().item()
    assert abs(var - want) < 5 * ((m4 - var ** 2) / gm.numel()) ** 0.5


def test_env_zoo_phase_tiny():
    scens = figures.env_zoo_scenarios(K_TINY, _port_garnet(),
                                      n_agents=N_TINY, batch_m=M_TINY,
                                      horizon=T_TINY)
    res = sweep.sweep(None, None, scens, 1, RUNS_TINY, device="cpu")
    assert _finite(res.history) and res.n_partitions == 14
    assert res.history.rewards.shape == (len(scens), RUNS_TINY, K_TINY)
    for i in range(len(scens)):
        assert math.isfinite(res.final_reward(i, tail=figures.ZOO_TAIL))


def _per_run_rate(hist):
    tel = hist.telemetry.participation_rate
    return np.asarray(tel, np.float64).mean(axis=-1)


def test_participation_phase_tiny():
    """The rate x staleness sweeps at N=64 in blocks of 16 with telemetry,
    the baseline bitwise the participation-off sweep, and the driver."""
    env = make_env("landmark")
    pol = env.default_policy()
    kw = dict(n_agents=PART_TINY_N, agent_blocks=PART_TINY_BLOCKS)
    for stale, scens in figures.participation_grids(K_TINY, **kw):
        res = sweep.sweep(env, pol, scens, 7, RUNS_TINY, device="cpu",
                          telemetry=TelemetryConfig())
        assert _finite(res.history) and res.n_partitions == 1
        for i, s in enumerate(scens):
            h = res.history.lane(i)
            rates = _per_run_rate(h)
            assert rates.shape == (RUNS_TINY,) and np.isfinite(rates).all()
            assert (chip_smoke.run_means(h.telemetry, "staleness_mean")
                    is None) == (stale is None)
    base = figures.participation_baseline(K_TINY, **kw)
    off = [dataclasses.replace(s, participation=None) for s in base]
    hb, ho = (sweep.sweep(env, pol, x, 7, RUNS_TINY, device="cpu",
                          telemetry=TelemetryConfig()).history.lane(0)
              for x in (base, off))
    assert _finite(hb) and chip_smoke.histories_bitwise(hb, ho)

    dk = figures.participation_driver(2, **kw)
    cfg = dk.pop("cfg")
    records = RoundService(env, pol, cfg, 7, device="cpu", **dk).run()
    assert [r["round_end"] for r in records] == [2]
    rec = records[0]
    assert 0.0 < rec["participation_rate"] < 1.0
    assert len(rec["staleness_hist"]) == 4 + 2
    assert sum(rec["staleness_hist"]) == PART_TINY_N


# ---------------------------------------------------------------------------
# fig_participation's streamed service round, fed JAX's draws
# ---------------------------------------------------------------------------

SVC_N, SVC_BLOCKS, SVC_ROUNDS = 8, 3, 6
SVC_TOL = dict(rtol=1e-5, atol=1e-6)     # test_torch_service.py's chain


def _jax_service_replay(js, seed=7):
    """The JAX service rounds of scenario ``js`` with telemetry on, from
    ``jax.random.key(seed)`` as ``run`` derives them: theta_0, each
    round's draws (initial states, actions, gains, kernel seed, mask) as
    ``fedpg.RoundDraws``, each round's metrics and the final theta."""
    env = jax_make_env("landmark")
    pol = env.default_policy()
    cfg, ocfg = js.fedpg_config(), js.ota_config()
    part, scfg = js.participation, js.staleness
    key_init, key_scan, key_svc = jax.random.split(jax.random.key(seed), 3)
    theta = pol.init(key_init)
    theta0 = {k: np.asarray(v) for k, v in theta.items()}
    state = jax_part.init_state(theta, key_svc, cfg.n_agents, scfg)
    round_fn = jax.jit(jax_fedpg.make_round_fn(
        env, pol, cfg, ocfg, ota_backend="pallas", participation=part,
        staleness=scfg, telemetry=jax_probes.TelemetryConfig()))
    rollouts = jax.jit(lambda th, keys: jax.vmap(
        lambda k: jax_sampler.rollout_batch(env, pol, th, k, cfg.horizon,
                                            cfg.batch_m))(keys))
    ids = jnp.arange(cfg.n_agents, dtype=jnp.int32)
    draws, metrics = [], []
    for r, key in enumerate(jax.random.split(key_scan, cfg.n_rounds)):
        key_samp, key_chan = jax.random.split(key)
        trajs = rollouts(state.theta,
                         jax.random.split(key_samp, cfg.n_agents))
        key_h, key_n = jax.random.split(key_chan)
        mask = jax_part.round_mask(part, state.part_key, state.sched_key,
                                   jnp.int32(r), ids, cfg.n_agents)
        draws.append(fedpg.RoundDraws(
            s0=torch.from_numpy(np.array(trajs.obs[:, :, 0])),
            actions=torch.from_numpy(np.array(trajs.actions, np.int64)),
            gains=torch.from_numpy(np.array(
                jax_ota.sample_gains(ocfg, key_h, cfg.n_agents))),
            seed=int(jax.random.bits(key_n, (), jnp.uint32)),
            mask=torch.from_numpy(np.array(mask))))
        state, m = round_fn(state, key)
        metrics.append(m)
    return theta0, draws, metrics, {k: np.asarray(v)
                                    for k, v in state.theta.items()}


def _replayed_ages(masks, max_age):
    """Each round's mean age over the agents replayed from their buffers,
    those who sat the round out and made one of its last ``max_age``
    rounds (0 where there are none), from the ``(K, N)`` masks."""
    last = np.full(masks.shape[1], -(10 ** 9))
    out = []
    for r, m in enumerate(masks):
        age = r - last
        replay = ~m & (age <= max_age)
        out.append(float(age[replay].mean()) if replay.any() else 0.0)
        last = np.where(m, r, last)
    return out


@pytest.mark.parametrize("rate,max_age,n_rounds",
                         [(0.25, 4, 5), (0.5, 4, 5), (0.25, 2, 6)])
def test_expected_replay_age_is_the_sampled_one(rate, max_age, n_rounds):
    """``figures.expected_replay_age`` against 10^6 Bernoulli agents'
    replayed ages (the probe's rule, held to it below): within 3e-3, about
    5 standard errors."""
    masks = np.random.default_rng(0).random((n_rounds, 10 ** 6)) < rate
    got = np.mean(_replayed_ages(masks, max_age))
    assert abs(got - figures.expected_replay_age(rate, max_age,
                                                 n_rounds)) < 3e-3


@pytest.mark.parametrize("stale_i", [0, 1], ids=["fresh", "stale"])
def test_participation_round_matches_jax_with_its_draws(stale_i):
    """``fig_participation``'s rate-0.25 scenario (debias on, Rayleigh at
    noise 1e-3, M=1 T=3) at N=8 streamed in blocks of 3, K=6 rounds with
    telemetry, the port fed JAX's draws and masks: the history, every
    probe (the realised rate, the debias drift, the mean replayed age
    among them) and theta within the chained-round tolerance."""
    grids, _ = _jax_participation(SVC_N, SVC_BLOCKS, SVC_ROUNDS)
    js = grids[stale_i][1][0]
    stale, scens = figures.participation_grids(
        SVC_ROUNDS, n_agents=SVC_N, agent_blocks=SVC_BLOCKS)[stale_i]
    s = scens[0]
    assert s.participation.rate == js.participation.rate == 0.25
    theta0, draws, want, theta_j = _jax_service_replay(js)
    env = make_env("landmark")
    round_fn = fedpg.make_round_fn(
        env, env.default_policy(), s.fedpg_config(), s.ota_config(),
        agent_blocks=SVC_BLOCKS, participation=s.participation,
        staleness=stale, telemetry=TelemetryConfig())
    state = svc_part.init_state(interop.from_numpy(theta0, "cpu"),
                                torch.tensor(0), SVC_N, stale)
    ages = []
    for d, m_j in zip(draws, want):
        state, m = round_fn(state, None, d)
        ages.append(m[3].staleness_mean)
        np.testing.assert_allclose([x.item() for x in m[:3]],
                                   [float(x) for x in m_j[:3]], **SVC_TOL)
        for name, a, b in zip(m[3]._fields, m[3], m_j[3]):
            assert (a is None) == (b is None), name
            if b is not None:
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           **SVC_TOL, err_msg=name)
    for k in theta_j:
        np.testing.assert_allclose(state.theta[k].numpy(), theta_j[k],
                                   **SVC_TOL)
    counts = [int(d.mask.sum()) for d in draws]
    assert any(0 < c < SVC_N for c in counts)
    if stale is not None:
        masks = np.stack([d.mask.numpy().astype(bool) for d in draws])
        np.testing.assert_allclose(
            [float(x) for x in ages], _replayed_ages(masks, stale.max_age),
            rtol=1e-6)
