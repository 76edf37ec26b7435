"""The port's copies of the paper's figure settings (``repro_torch.figures``)
against the JAX package's benchmarks, and a tiny run of each chip phase's
code on the CPU.

Scenario lists compare field for field (channels and power policies by
their dataclass repr, which lists every parameter and the effective
moments); ``iters_to_90pct`` against the benchmark's lines on made-up
rewards; ``tree_sub`` bitwise; the floor's inner step against JAX's
``ota.aggregate`` and norm with the same gradients and injected gains
(rtol 1e-6); the Theorem 1/2 bounds against JAX's closed forms; the four
reference files' settings against the port's declarations."""
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
from benchmarks import fig3_vs_vanilla, fig12_rayleigh, fig45_nakagami  # noqa: E402
from repro.core import channel as jax_channel  # noqa: E402
from repro.core import fedpg as jax_fedpg  # noqa: E402
from repro.core import ota as jax_ota  # noqa: E402
from repro.core import power_control as jax_pc  # noqa: E402
from repro.core import sweep as jax_sweep  # noqa: E402
from repro.core import theory as jax_theory  # noqa: E402
from repro.configs.ota_pg_particle import RAYLEIGH as JAX_RAYLEIGH  # noqa: E402
from repro.rl.env import TabularMDP as JaxTabularMDP  # noqa: E402
from repro.utils import tree as jax_tree  # noqa: E402
from repro_torch import figures  # noqa: E402
from repro_torch.core import event_triggered as et  # noqa: E402
from repro_torch.core import ota, sweep  # noqa: E402
from repro_torch.core.channel import make_channel  # noqa: E402
from repro_torch.rl.env import LandmarkNav  # noqa: E402
from repro_torch.rl.policy import MLPPolicy, TabularSoftmaxPolicy  # noqa: E402
from repro_torch.utils import tree  # noqa: E402

SHAPES = {"w1": (4, 16), "b1": (16,), "w2": (16, 5), "b2": (5,)}


def _ref(name):
    return json.loads((ROOT / "perf" / name).read_text())


def _same_scenarios(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name in ("channel", "power_control"):
                assert repr(x) == repr(y), f.name
            else:
                assert x == y, f.name


def _jax_theory_scenarios(mdp, n_rounds):
    """``benchmarks/theory_table.py:30-49`` with the JAX package."""
    consts = jax_theory.MDPConstants(G=math.sqrt(2.0), F=0.5, l_bar=1.0,
                                     gamma=0.9)
    channels = [
        (jax_channel.RayleighChannel(), "rayleigh", 1),
        (jax_channel.NakagamiChannel(m=0.1, omega=1.0), "nakagami", 2),
        (jax_pc.make_controlled_channel(jax_channel.RayleighChannel(),
                                        jax_pc.TruncatedInversion()),
         "rayleigh_trunc_inv", 1)]
    scens = [jax_sweep.Scenario(
        channel=ch, noise_sigma=1e-3,
        alpha=min(1e-2, consts.max_stepsize(ch.mean)), n_agents=8, batch_m=4,
        horizon=mdp.horizon, gamma=mdp.gamma, n_rounds=n_rounds, debias=True,
        tag=name) for ch, name, _ in channels]
    return scens, channels, consts


def _port_mdp(device="cpu"):
    ref = _ref("theory_reference.json")
    return figures.tabular_mdp(ref["mdp"], ref["setting"]["gamma"],
                               ref["setting"]["horizon"], device=device)


# ---------------------------------------------------------------------------
# the settings, field for field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(250, 10, 10, 1e-3), (7, 3, 2, 2e-3)])
def test_fig3_scenarios_equal_the_benchmarks(args):
    _same_scenarios(figures.fig3_scenarios(*args),
                    fig3_vs_vanilla.scenarios(*args))


@pytest.mark.parametrize("args", [(250, 10), (7, 3)])
def test_fig45_scenarios_equal_the_benchmarks(args):
    _same_scenarios(figures.fig45_scenarios(*args),
                    fig45_nakagami.scenarios(*args))


def test_fig12_scenarios_equal_the_benchmarks():
    assert figures.FIG12_SETTINGS == list(fig12_rayleigh.SETTINGS)
    _same_scenarios(figures.fig12_scenarios(250, 1e-3),
                    fig12_rayleigh.scenarios(250, 1e-3))


def test_theory_scenarios_equal_the_benchmarks():
    mdp = _port_mdp()
    jmdp = JaxTabularMDP.random(jax.random.key(0), n_states=3, n_actions=2,
                                gamma=0.9, horizon=3)
    scens, _, consts = _jax_theory_scenarios(jmdp, 150)
    _same_scenarios(figures.theory_scenarios(mdp, 150), scens)
    assert dataclasses.asdict(figures.THEORY_CONSTANTS) == \
        dataclasses.asdict(consts)


def test_et_setting_equals_the_benchmarks():
    cfg, cfg_ota = figures.et_setting()
    want = jax_fedpg.FedPGConfig(n_agents=20, batch_m=5, n_rounds=200,
                                 alpha=3e-3)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert repr(cfg_ota.channel) == repr(jax_channel.make_channel("rayleigh"))
    assert (cfg_ota.noise_sigma, cfg_ota.debias) == (
        JAX_RAYLEIGH.noise_sigma, True)
    s = figures.et_scenario(cfg, cfg_ota)
    assert s.fedpg_config() == cfg and s.ota_config() == cfg_ota


# ---------------------------------------------------------------------------
# iters_to_90pct, tree_sub, the floor's inner step, the bounds
# ---------------------------------------------------------------------------

def _jax_iters(r_ota, r_van, n_rounds):
    """``benchmarks/fig3_vs_vanilla.py:46-58`` as the benchmark runs them."""
    r_ota, r_van = jnp.asarray(r_ota), jnp.asarray(r_van)
    f_van = float(jnp.mean(r_van[:, -20:]))
    base = float(jnp.mean(r_van[:, :10]))
    target = base + 0.9 * (f_van - base)

    def first_hit(traj):
        hits = jnp.nonzero(traj >= target, size=1, fill_value=n_rounds)[0]
        return int(hits[0])

    return (first_hit(jnp.mean(r_ota, axis=0)),
            first_hit(jnp.mean(r_van, axis=0)))


@pytest.mark.parametrize("case", ["ramps", "ota_never", "falling",
                                  "noisy"])
def test_iters_to_90pct_matches_the_benchmark(case):
    k = 60
    rng = np.random.default_rng(4)
    ramp = np.minimum(np.arange(k) / 30.0, 1.0)
    r_van = np.tile(-20 + 5 * ramp, (3, 1)).astype(np.float32)
    r_ota = np.tile(-20 + 5 * np.minimum(np.arange(k) / 40.0, 1.0),
                    (3, 1)).astype(np.float32)
    if case == "ota_never":
        r_ota = np.full((3, k), -20.0, np.float32)
    elif case == "falling":
        # the target lies above the exact uplink's end: round 0 reaches it,
        # and the OTA run, 6 below it throughout, never does
        r_van = (-15 - 5 * np.tile(ramp, (3, 1))).astype(np.float32)
        r_ota = r_van - 6.0
    elif case == "noisy":
        r_van = r_van + rng.normal(0, 0.5, r_van.shape).astype(np.float32)
        r_ota = r_ota + rng.normal(0, 0.5, r_ota.shape).astype(np.float32)
    got = figures.iters_to_90pct(r_ota, r_van, k)
    assert got == _jax_iters(r_ota, r_van, k)
    if case == "ramps":
        assert got == (37, 28)
    if case == "ota_never":
        assert got[0] == k
    if case == "falling":
        assert got == (k, 0)
    assert figures.same_order(*got) == (got[0] <= 2 * max(got[1], 1))


def test_tree_sub_bitwise_jax():
    rng = np.random.default_rng(0)
    a = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in SHAPES.items()}
    b = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in SHAPES.items()}
    got = tree.tree_sub({k: torch.from_numpy(v) for k, v in a.items()},
                        {k: torch.from_numpy(v) for k, v in b.items()})
    want = jax_tree.tree_sub({k: jnp.asarray(v) for k, v in a.items()},
                             {k: jnp.asarray(v) for k, v in b.items()})
    for k in SHAPES:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    nested = tree.tree_sub({"x": {"y": torch.ones(3)}},
                           {"x": {"y": torch.full((3,), 0.25)}})
    assert torch.equal(nested["x"]["y"], torch.full((3,), 0.75))


def _floor_inputs(seed, n_agents):
    rng = np.random.default_rng(seed)
    g = {k: rng.standard_normal((n_agents,) + s).astype(np.float32) * 5
         for k, s in SHAPES.items()}
    ref = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in SHAPES.items()}
    h = (np.abs(rng.standard_normal(n_agents)) + 0.1).astype(np.float32)
    return g, ref, h


@pytest.mark.parametrize("name,kw", [("rayleigh", {}),
                                     ("nakagami", {"m": 0.1, "omega": 1.0})])
@pytest.mark.parametrize("noisy", [False, True])
def test_floor_step_matches_jax(name, kw, noisy):
    """``floor_error`` against ``fig45_nakagami.py:123-124``: JAX's
    aggregate then ``tree_global_norm_sq(tree_sub(u, g_ref))``, with the
    same gradients and gains; noiseless through ``backend="xla"``, noisy
    through the kernel path, whose counter-PRNG noise both packages
    share (the seed injected)."""
    g, ref, h = _floor_inputs(7 if noisy else 3, 10)
    sigma = JAX_RAYLEIGH.noise_sigma * 100 if noisy else 0.0
    jcfg = jax_ota.OTAConfig(jax_channel.make_channel(name, **kw),
                             noise_sigma=sigma, debias=True)
    tcfg = ota.OTAConfig(make_channel(name, **kw),
                         noise_sigma=sigma, debias=True)
    key = jax.random.key(5)
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    rj = {k: jnp.asarray(v) for k, v in ref.items()}
    u, _ = jax_ota.aggregate(gj, jcfg, key=key,
                             backend="pallas" if noisy else "xla",
                             gains=jnp.asarray(h))
    want = float(jax_tree.tree_global_norm_sq(jax_tree.tree_sub(u, rj)))
    seed = (int(jax.random.bits(jax.random.split(key)[1], (), jnp.uint32))
            if noisy else None)
    got = figures.floor_error({k: torch.from_numpy(v) for k, v in g.items()},
                              tcfg, {k: torch.from_numpy(v)
                                     for k, v in ref.items()},
                              generator=torch.Generator().manual_seed(0),
                              gains=torch.from_numpy(h), seed=seed)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_theory_bounds_equal_jax_closed_forms():
    mdp = _port_mdp()
    scens = figures.theory_scenarios(mdp, 150)
    jmdp = JaxTabularMDP.random(jax.random.key(0), n_states=3, n_actions=2,
                                gamma=0.9, horizon=3)
    jscens, channels, consts = _jax_theory_scenarios(jmdp, 150)
    rows = figures.theory_bounds(scens, 150)
    for row, s, (ch, name, thm) in zip(rows, jscens, channels):
        kw = dict(K=150, n_agents=8, batch_m=4, alpha=s.alpha, m_h=ch.mean,
                  sigma_h2=ch.var, noise_sigma2=1e-6, delta_J=1 / (1 - 0.9),
                  V=consts.V())
        want = (jax_theory.theorem1_bound(**kw) if thm == 1
                else jax_theory.theorem2_bound(**kw))
        assert (row["tag"], row["theorem"], row["alpha"]) == (name, thm,
                                                               s.alpha)
        assert row["bound"] == want


# ---------------------------------------------------------------------------
# the reference files
# ---------------------------------------------------------------------------

def test_reference_files_hold_the_ports_settings():
    cs = chip_smoke
    f3 = _ref("fig3_reference.json")
    assert {k: f3["setting"][k] for k in ("n_rounds", "n_agents", "batch_m",
                                          "alpha", "runs", "seed")} == dict(
        n_rounds=cs.FIG3_ROUNDS, n_agents=cs.FIG3_AGENTS,
        batch_m=cs.FIG3_BATCH, alpha=cs.FIG12_ALPHA, runs=cs.FIG_RUNS,
        seed=cs.FIG3_SEED)
    assert [r["tag"] for r in f3["rows"]] == [
        s.tag for s in figures.fig3_scenarios(1, 1, 1, 1e-3)]

    f45 = _ref("fig45_reference.json")
    assert {k: f45["setting"][k] for k in ("n_rounds", "n_agents", "alpha",
                                           "runs", "seed", "n_draws")} == \
        dict(n_rounds=cs.FIG45_ROUNDS, n_agents=cs.FIG45_AGENTS,
             alpha=cs.FIG12_ALPHA, runs=cs.FIG_RUNS, seed=cs.FIG45_SEED,
             n_draws=cs.FLOOR_DRAWS)
    assert [r["tag"] for r in f45["rows"]] == [
        s.tag for s in figures.fig45_scenarios(1, 1)]
    assert sorted((r["channel"], r["batch_m"]) for r in f45["floor"]) == \
        sorted((c, m) for c in ("rayleigh", "nakagami")
               for m in figures.FIG45_BATCHES)
    assert all(len(r["per_draw"]) == cs.FLOOR_DRAWS for r in f45["floor"])
    theta = {k: np.asarray(v) for k, v in f45["theta"].items()}
    assert {k: v.shape for k, v in theta.items()} == SHAPES

    e = _ref("et_reference.json")
    cfg, cfg_ota = figures.et_setting()
    s = e["setting"]
    assert (s["n_rounds"], s["n_agents"], s["batch_m"], s["alpha"],
            s["horizon"], s["gamma"], tuple(s["taus"]), s["runs"],
            s["noise_sigma"]) == (cfg.n_rounds, cfg.n_agents, cfg.batch_m,
                                  cfg.alpha, cfg.horizon, cfg.gamma,
                                  figures.ET_TAUS, cs.ET_REF_RUNS,
                                  cfg_ota.noise_sigma)
    assert [r["run"] for r in e["rows"]] == ["ota"] + [
        f"et_{t:g}" for t in figures.ET_TAUS]

    t = _ref("theory_reference.json")
    s = t["setting"]
    assert (s["n_rounds"], s["runs"], s["seed"], s["n_agents"],
            s["batch_m"], s["noise_sigma"], s["noise_sigma2"]) == (
        cs.THEORY_ROUNDS, cs.FIG_RUNS, cs.THEORY_SEED, figures.THEORY_AGENTS,
        figures.THEORY_BATCH, figures.THEORY_NOISE_SIGMA,
        figures.THEORY_NOISE_SIGMA2)
    assert np.asarray(t["mdp"]["P"]).shape == (3, 2, 3)
    rows = figures.theory_bounds(figures.theory_scenarios(_port_mdp(), 150),
                                 150)
    for row, w in zip(rows, t["rows"]):
        assert (row["tag"], row["theorem"], row["alpha"]) == (
            w["tag"], w["theorem"], w["alpha"])
        assert math.isclose(row["bound"], w["bound"], rel_tol=1e-6)


def test_statistic_follows_the_reference_alone():
    """The rows PERF.md names as heavy-tailed are the ones ``hold_runs``
    holds by the mean of logs: the floor's Rayleigh M=1 and both Nakagami
    rows; no trajectory row, no reward row."""
    f45 = _ref("fig45_reference.json")
    heavy = {(r["channel"], r["batch_m"]): figures.heavy_tailed(r["per_draw"])
             for r in f45["floor"]}
    assert heavy == {("rayleigh", 1): True, ("rayleigh", 10): False,
                     ("nakagami", 1): True, ("nakagami", 10): True}
    for name in ("fig3_reference.json", "fig45_reference.json",
                 "theory_reference.json"):
        for r in _ref(name)["rows"]:
            assert not figures.heavy_tailed(r["per_run_avg_grad_sq"])
            assert not figures.heavy_tailed(r.get("per_run_final_reward",
                                                  [-1.0]))


def test_hold():
    h = figures.hold([1.0, 2.0, 3.0], 1.0, 0.0)
    assert (h.mean, h.se) == (2.0, 1 / math.sqrt(3))
    assert h.z == pytest.approx(math.sqrt(3)) and h.ok
    assert figures.hold([20.0] * 4, 20.0, 0.0) == (20.0, 0.0, 0.0)
    assert not figures.hold([19.0] * 4, 20.0, 0.0).ok
    assert not figures.hold([10.0, 10.1], 0.0, 0.01).ok
    stat, h = figures.hold_runs([1.0, 2.0, 4.0], [1.0, 2.0, 40.0])
    assert stat == "log_mean"
    assert h.mean == pytest.approx(math.log(8) / 3)
    assert figures.hold_runs([1.0, 2.0], [1.0, 3.0])[0] == "mean"


# ---------------------------------------------------------------------------
# a tiny run of each chip phase's code on the CPU
# ---------------------------------------------------------------------------

def _finite(res):
    return all(np.isfinite(np.asarray(x, np.float64)).all()
               for x in res.history)


def test_fig3_phase_tiny():
    scens = figures.fig3_scenarios(3, 3, 2, 1e-3)
    res = sweep.sweep(LandmarkNav(), MLPPolicy(), scens, 1, 2, device="cpu")
    assert _finite(res) and res.history.rewards.shape == (2, 2, 3)
    it = figures.iters_to_90pct(res.history.rewards[res.index(tag="ota")],
                                res.history.rewards[res.index(
                                    tag="vanilla")], 3)
    assert all(0 <= i <= 3 for i in it)
    ref = _ref("fig3_reference.json")["rows"][0]
    stat, h = figures.hold_runs(res.history.grad_sq[0].mean(axis=1),
                                ref["per_run_avg_grad_sq"])
    assert stat == "mean" and math.isfinite(h.z)


def test_fig45_phase_tiny():
    scens = figures.fig45_scenarios(3, 3)
    res = sweep.sweep(LandmarkNav(), MLPPolicy(), scens, 2, 2, device="cpu")
    assert _finite(res) and len(res.partitions) == 4
    final = {(s.tag.rsplit("_M", 1)[0], s.batch_m): res.final_reward(i)
             for i, s in enumerate(scens)}
    assert isinstance(figures.fig4_claim(final), bool)
    theta = _ref("fig45_reference.json")["theta"]
    floor = figures.aggregation_error_floor(theta, 3, 4, device="cpu")
    assert sorted(floor) == sorted((c, m) for c in ("rayleigh", "nakagami")
                                   for m in (1, 10))
    for v in floor.values():
        assert v.per_draw.shape == (4,) and (v.per_draw > 0).all()
        assert v.mean == pytest.approx(v.per_draw.mean())
    assert isinstance(figures.fig5_claim({k: v.mean
                                          for k, v in floor.items()}), bool)


def test_floor_carries_the_reference_policy():
    """The floor rolls out at the reference's weights, not the port's
    ``init``: its gradients are those of ``interop.from_numpy(theta)``."""
    theta = _ref("fig45_reference.json")["theta"]
    seen = []
    real = figures.rollout_batch

    def spy(env, pol, params, *a, **k):
        seen.append({kk: vv.clone() for kk, vv in params.items()})
        return real(env, pol, params, *a, **k)

    figures.rollout_batch = spy
    try:
        figures.aggregation_error_floor(theta, 2, 2, device="cpu")
    finally:
        figures.rollout_batch = real
    for p in seen:
        for k, v in theta.items():
            np.testing.assert_array_equal(p[k].numpy(),
                                          np.asarray(v, np.float32))


def test_et_phase_tiny_taus_bitwise():
    """At the ET benchmark's width every agent uploads every round at both
    taus, and one seed's two tau runs are the same run, bit for bit."""
    cfg, cfg_ota = figures.et_setting(n_rounds=3)
    env, pol = LandmarkNav(), MLPPolicy()
    runs = [et.run(env, pol, cfg, et.ETConfig(tau), 0, device="cpu")[1]
            for tau in figures.ET_TAUS]
    assert bool((runs[0].uploads == cfg.n_agents).all())
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    res = sweep.sweep(env, pol, [figures.et_scenario(cfg, cfg_ota)], 0, 2,
                      device="cpu")
    assert _finite(res) and res.history.rewards.shape == (1, 2, 3)


def test_theory_phase_tiny():
    mdp = _port_mdp()
    scens = figures.theory_scenarios(mdp, 3)
    res = sweep.sweep(mdp, TabularSoftmaxPolicy(3, 2), scens, 1, 2,
                      device="cpu")
    assert _finite(res) and len(res.partitions) == 3
    rows = figures.theory_bounds(scens, 3)
    assert [r["theorem"] for r in rows] == [1, 2, 1]
    assert all(res.avg_grad_sq(i) <= r["bound"] for i, r in enumerate(rows))
    ref = _ref("theory_reference.json")
    np.testing.assert_array_equal(mdp.P.numpy(), np.asarray(ref["mdp"]["P"],
                                                            np.float32))

