"""The scenario-sweep engine of the PyTorch port (``repro_torch.core.sweep``
and the lane-batched run of ``repro_torch.core.lanes``) against the JAX
package, and its own bitwise contract.

Against JAX, on the host side (no rollouts): ``grid``, the partition index
groups, ``describe`` and ``to_csv`` (the same text for the same
histories), ``final_reward`` / ``avg_grad_sq`` on the same arrays (rtol
1e-6: both reduce in float32, in orders of their own), and the packers —
``batched_env_arrays``, ``batched_channel_arrays``, ``_pack_controlled``
(float64, exact) and ``_pack_partition`` (float32, bitwise).  Env steps of
``build_lane_env`` equal JAX's lane envs on the same states, actions and
draws (rtol 1e-6, the zoo's step tolerance).

Within the port, at the golden suite's SMALL size (N=3, M=2, T=6, K=4),
bitwise: ``BatchedChannel``'s lane l is the concrete channel's draw from
the same generator; every lane of the lane-batched run and of
``sweep(mode="vmap")`` is ``fedpg.run`` of its scenario and seed (plain,
power control, env parameters, service with staleness, exact uplink; LQR
too, so no JAX exception is needed here); ``monte_carlo`` is the per-run
loop.  ``"vmap"`` refuses a streamed partition and ``"sharded"`` refuses
outright, both naming ROADMAP.md.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jax_channel
from repro.core import power_control as jax_pc
from repro.core import sweep as jax_sweep
from repro.core.fedpg import History as JaxHistory
from repro.rl import envs as jax_envs
from repro.service.faults import FaultConfig as JaxFaults
from repro.service.faults import StragglerModel as JaxStraggler
from repro.service.participation import ParticipationConfig as JaxPart
from repro.service.staleness import StalenessConfig as JaxStale
from repro_torch import interop
from repro_torch.core import channel, fedpg, lanes, power_control, sweep
from repro_torch.core.fedpg import History
from repro_torch.rl import envs
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy
from repro_torch.service.faults import FaultConfig, StragglerModel
from repro_torch.service.participation import ParticipationConfig
from repro_torch.service.staleness import StalenessConfig

SMALL = dict(n_agents=3, batch_m=2, horizon=6, n_rounds=4)


# ---------------------------------------------------------------------------
# Twin grids: the same scenarios built in both packages.
# ---------------------------------------------------------------------------

def _twin(kind, **kw):
    """(port object, JAX object) of one named setting."""
    if kind == "rayleigh":
        return channel.RayleighChannel(**kw), jax_channel.RayleighChannel(**kw)
    if kind == "nakagami":
        return channel.NakagamiChannel(**kw), jax_channel.NakagamiChannel(**kw)
    if kind == "lognormal":
        return (channel.LogNormalChannel(**kw),
                jax_channel.LogNormalChannel(**kw))
    if kind == "fixed":
        return (channel.FixedGainChannel(**kw),
                jax_channel.FixedGainChannel(**kw))
    if kind == "trunc":
        return (power_control.TruncatedInversion(**kw),
                jax_pc.TruncatedInversion(**kw))
    if kind == "windy":
        return envs.WindyLandmarkNav(**kw), jax_envs.WindyLandmarkNav(**kw)
    if kind == "bern":
        return ParticipationConfig(**kw), JaxPart(**kw)
    if kind == "stale":
        return StalenessConfig(**kw), JaxStale(**kw)
    raise KeyError(kind)


def _straggled(deadline, debias="realized"):
    return (ParticipationConfig(rate=0.9, debias=debias, faults=FaultConfig(
                stragglers=StragglerModel(mean=1.0), deadline=deadline)),
            JaxPart(rate=0.9, debias=debias, faults=JaxFaults(
                stragglers=JaxStraggler(mean=1.0), deadline=deadline)))


def _grids():
    """Named twin axis sets: {axis: [(port, jax), ...] or (v, v)}."""
    r1, r2 = _twin("rayleigh", scale=1.0), _twin("rayleigh", scale=2.0)
    n1, n2 = (_twin("nakagami", m=0.1, omega=1.0),
              _twin("nakagami", m=0.5, omega=2.0))
    t1, t2 = _twin("trunc", p_max=5.0), _twin("trunc", p_max=8.0)
    w1, w2 = _twin("windy", wind=0.05), _twin("windy", wind=0.1)
    b1, b2 = _twin("bern", rate=0.5), _twin("bern", rate=0.8)
    st = _twin("stale", max_age=4, decay=0.8)
    return {
        "channel_noise_alpha": dict(channel=[r1, r2],
                                    noise_sigma=[1e-3, 1e-2],
                                    alpha=[1e-2, 2e-2], debias=True),
        "nakagami": dict(channel=[n1, n2], noise_sigma=1e-3, debias=True),
        "power_control": dict(channel=r1, power_control=[t1, t2],
                              noise_sigma=1e-3, debias=True),
        "fleet_and_exact": dict(channel=[None, r1], n_agents=[2, 3],
                                alpha=1e-2),
        "env": dict(channel=r1, noise_sigma=1e-3, env=[w1, w2]),
        "service": dict(channel=r1, noise_sigma=1e-3,
                        participation=[b1, b2],
                        staleness=[st, _twin("stale", max_age=4,
                                             decay=0.5)]),
        "deadline": dict(channel=r1, participation=[_straggled(1.0),
                                                    _straggled(2.0)]),
    }


def _side(axes, i):
    """Axis values of one package (0: port, 1: JAX)."""
    def pick(v):
        return v[i] if isinstance(v, tuple) else v
    out = {}
    for k, v in axes.items():
        out[k] = [pick(x) for x in v] if isinstance(v, list) else pick(v)
    return out


def _both(name):
    axes = {**SMALL, **_grids()[name]}
    return sweep.grid(**_side(axes, 0)), jax_sweep.grid(**_side(axes, 1))


@pytest.mark.parametrize("name", list(_grids()))
def test_grid_partitions_and_describe_match_jax(name):
    port, jx = _both(name)
    assert len(port) == len(jx)
    assert [p.indices for p in sweep.partition_scenarios(port)] == \
        [p.indices for p in jax_sweep.partition_scenarios(jx)]
    for a, b in zip(port, jx):
        assert a.describe() == b.describe()


def _packed_np(tree):
    return {k: (_packed_np(v) if isinstance(v, dict)
                else np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name", list(_grids()))
def test_pack_partition_matches_jax(name):
    """The same axes packed, float32 values bitwise."""
    port, jx = _both(name)
    for pp, pj in zip(sweep.partition_scenarios(port),
                      jax_sweep.partition_scenarios(jx)):
        got = _packed_np(sweep._pack_partition(pp))
        want = _packed_np(jax_sweep._pack_partition(pj))
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], dict):
                assert got[k].keys() == want[k].keys(), k
                for f in want[k]:
                    assert got[k][f].dtype == np.float32
                    np.testing.assert_array_equal(got[k][f], want[k][f])
            else:
                assert got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k])


def _histories(n_s, runs=3, k=25, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n_s, runs, k)).astype(np.float32) * s + m
            for s, m in ((1.0, -18.0), (30.0, 150.0), (0.3, 1.2))]


def test_csv_and_table_metrics_match_jax():
    """Same scenarios, same histories: the same CSV text; final_reward and
    avg_grad_sq within rtol 1e-6."""
    port, jx = _both("channel_noise_alpha")
    r, g, m = _histories(len(port))
    res_p = sweep.SweepResult(scenarios=port, history=History(r, g, m),
                              mc_runs=3)
    res_j = jax_sweep.SweepResult(scenarios=jx, history=JaxHistory(
        rewards=jnp.asarray(r), grad_sq=jnp.asarray(g),
        gain_mean=jnp.asarray(m)), mc_runs=3)
    assert res_p.to_csv() == res_j.to_csv()
    for i in range(len(port)):
        for tail in (20, 5):
            np.testing.assert_allclose(res_p.final_reward(i, tail),
                                       res_j.final_reward(i, tail),
                                       rtol=1e-6)
        np.testing.assert_allclose(res_p.avg_grad_sq(i),
                                   res_j.avg_grad_sq(i), rtol=1e-6)
    assert res_p.index(alpha=2e-2, noise_sigma=1e-2) == \
        res_j.index(alpha=2e-2, noise_sigma=1e-2)


@pytest.mark.parametrize("kind,kws", [
    ("rayleigh", [dict(scale=1.0), dict(scale=0.5)]),
    ("nakagami", [dict(m=0.1, omega=1.0), dict(m=0.5, omega=2.0)]),
    ("lognormal", [dict(mu=0.0, sigma=0.25), dict(mu=0.1, sigma=0.5)]),
    ("fixed", [dict(gain=0.7), dict(gain=1.3)]),
])
def test_channel_packer_matches_jax(kind, kws):
    pairs = [_twin(kind, **kw) for kw in kws]
    kp, ap = channel.batched_channel_arrays([p for p, _ in pairs])
    kj, aj = jax_channel.batched_channel_arrays([j for _, j in pairs])
    assert kp == kj and ap.keys() == aj.keys()
    for k in aj:
        np.testing.assert_array_equal(ap[k], aj[k])


def test_controlled_packer_matches_jax():
    chans = [(power_control.make_controlled_channel(
        channel.RayleighChannel(s), power_control.TruncatedInversion(p_max=p)),
        jax_pc.make_controlled_channel(
            jax_channel.RayleighChannel(s), jax_pc.TruncatedInversion(p_max=p)))
        for s, p in ((1.0, 5.0), (2.0, 8.0))]
    kp, ap = channel.batched_channel_arrays([p for p, _ in chans])
    kj, aj = jax_channel.batched_channel_arrays([j for _, j in chans])
    assert kp == kj == "controlled:rayleigh:TruncatedInversion"
    assert ap.keys() == aj.keys()
    for k in aj:    # closed-form moments: the same double arithmetic
        np.testing.assert_allclose(ap[k], aj[k], rtol=1e-15)
    np.testing.assert_array_equal(
        power_control._pack_controlled([p for p, _ in chans])["pc.p_max"],
        jax_pc._pack_controlled([j for _, j in chans])["pc.p_max"])


def _env_twins():
    g = jax_envs.garnet(jax.random.key(0), 4, 2, branching=2)
    g2 = jax_envs.garnet(jax.random.key(1), 4, 2, branching=2)
    fleets = [jax_envs.make_heterogeneous_env(
        [jax_envs.WindyLandmarkNav(wind=w * s) for w in (0.0, 0.1, 0.2)])
        for s in (1.0, 2.0)]
    return {
        "windy": [jax_envs.WindyLandmarkNav(wind=0.05, gust_sigma=0.02),
                  jax_envs.WindyLandmarkNav(wind=0.1, gust_sigma=0.05)],
        "lqr": [jax_envs.LQRTask(drift=0.9), jax_envs.LQRTask(drift=0.8)],
        "cliffwalk": [jax_envs.CliffWalk(width=4, height=3, slip=s)
                      for s in (0.1, 0.3)],
        "tabular": [g, g2],
        "hetero": fleets,
    }


@pytest.mark.parametrize("name", list(_env_twins()))
def test_env_packer_and_lane_steps_match_jax(name):
    jx = _env_twins()[name]
    port = [interop.env_from_jax(e, "cpu") for e in jx]
    kp, ap = envs.batched_env_arrays(port)
    kj, aj = jax_envs.batched_env_arrays(jx)
    assert kp == kj and ap.keys() == aj.keys()
    for k in aj:
        np.testing.assert_allclose(ap[k], aj[k], rtol=0, atol=0)
    # lane envs: one step of each lane on the same states, actions, draws
    lanes_t = envs.build_lane_env(kp, port[0], {
        k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in ap.items()})
    n_lanes, n_agents = len(jx), (3 if name == "hetero" else 1)
    batch = 8
    keys = jax.random.split(jax.random.key(3), n_lanes * n_agents * batch)
    keys = keys.reshape(n_lanes, n_agents, batch)
    rng = np.random.default_rng(0)
    want, states, acts, noises = [], [], [], []
    for li, ej in enumerate(jx):
        lane_j = jax_envs.build_lane_env(kj, jx[0], {
            k: jnp.asarray(v[li], jnp.float32) for k, v in aj.items()})
        per_agent = []
        for ai in range(n_agents):
            e = lane_j.lane({k: v[ai] for k, v in lane_j.params.items()}) \
                if name == "hetero" else lane_j
            ks = keys[li, ai]
            s = jax.vmap(e.reset)(ks)
            a = (rng.standard_normal((batch, e.dim)).astype(np.float32)
                 if name == "lqr" else rng.integers(0, e.n_actions, batch))
            step_keys = jax.random.split(jax.random.key(50 + li * 7 + ai),
                                         batch)
            nxt, loss = jax.vmap(e.step)(step_keys, s, jnp.asarray(a))
            per_agent.append((s, a, step_keys, nxt, loss, e))
        want.append(per_agent)
    from test_torch_envs import _jax_step_noise
    s_t = torch.stack([torch.stack([torch.from_numpy(np.array(p[0]))
                                    for p in lane]) for lane in want])
    a_t = torch.stack([torch.stack([torch.from_numpy(np.array(p[1]))
                                    for p in lane]) for lane in want])
    first = _jax_step_noise(want[0][0][5], want[0][0][2][0])
    n_t = None
    if first is not None:
        n_t = torch.stack([torch.stack([torch.from_numpy(np.array(
            jax.vmap(lambda k, e=p[5]: _jax_step_noise(e, k))(p[2])))
            for p in lane]) for lane in want])
    nxt_t, loss_t = lanes_t.step(s_t, a_t, n_t)
    nxt_j = np.stack([np.stack([np.asarray(p[3]) for p in lane])
                      for lane in want])
    loss_j = np.stack([np.stack([np.asarray(p[4]) for p in lane])
                       for lane in want])
    np.testing.assert_allclose(nxt_t.numpy(), nxt_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(loss_t.numpy(), loss_j, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Within the port: bitwise lanes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chans", [
    [channel.RayleighChannel(1.0), channel.RayleighChannel(0.5)],
    [channel.NakagamiChannel(0.1, 1.0), channel.NakagamiChannel(0.5, 2.0)],
    [channel.LogNormalChannel(0.0, 0.25), channel.LogNormalChannel(0.1, 0.5)],
    [channel.FixedGainChannel(0.7), channel.FixedGainChannel(1.3)],
    [power_control.make_controlled_channel(
        channel.RayleighChannel(s), power_control.TruncatedInversion(p_max=p))
     for s, p in ((1.0, 5.0), (2.0, 8.0))],
], ids=["rayleigh", "nakagami", "lognormal", "fixed", "controlled"])
def test_batched_channel_lane_is_the_concrete_draw(chans):
    kind, arrays = channel.batched_channel_arrays(chans)
    bc = channel.BatchedChannel(kind=kind, params={
        k: torch.tensor(v, dtype=torch.float32) for k, v in arrays.items()})
    gens = [torch.Generator().manual_seed(11 + i) for i in range(len(chans))]
    got = bc.sample(gens, (16,), "cpu")
    for i, ch in enumerate(chans):
        want = ch.sample(torch.Generator().manual_seed(11 + i), (16,), "cpu")
        assert torch.equal(got[i], want), i
    shared = channel.sample_lanes(chans[0], [torch.Generator().manual_seed(
        11)], (16,), "cpu")
    assert torch.equal(shared[0], chans[0].sample(
        torch.Generator().manual_seed(11), (16,), "cpu"))


def _o(scale=1.0, sigma=1e-3, pc=None):
    from repro_torch.core.ota import OTAConfig
    return OTAConfig(channel.RayleighChannel(scale), noise_sigma=sigma,
                     debias=True, power_control=pc)


def _norm(p, s):
    from repro_torch.service import participation, staleness
    p = participation.normalize(p, SMALL["n_agents"])
    return p, staleness.normalize(s, p)


def _lane_cases():
    w1, w2 = envs.WindyLandmarkNav(wind=0.05), envs.WindyLandmarkNav(wind=0.1)
    tp = power_control.TruncatedInversion
    p1, st = _norm(ParticipationConfig(rate=0.5), StalenessConfig(4, 0.8))
    p2, _ = _norm(ParticipationConfig(rate=0.8), StalenessConfig(4, 0.8))
    lqr = envs.make_env("lqr")
    return {
        "plain": [lanes.LaneSpec(s, 1e-2, _o()) for s in (1, 2, 3)],
        "channel_noise_alpha": [lanes.LaneSpec(1, 1e-2, _o(1.0, 1e-3)),
                                lanes.LaneSpec(2, 2e-2, _o(2.0, 1e-2))],
        "power_control": [lanes.LaneSpec(1, 1e-2, _o(pc=tp(p_max=5.0))),
                          lanes.LaneSpec(2, 1e-2, _o(pc=tp(p_max=8.0)))],
        "env": [lanes.LaneSpec(1, 1e-2, _o(), env=w1),
                lanes.LaneSpec(2, 1e-2, _o(), env=w2)],
        "service_stale": [lanes.LaneSpec(1, 1e-2, _o(), participation=p1,
                                         staleness=st),
                          lanes.LaneSpec(2, 1e-2, _o(), participation=p2,
                                         staleness=st)],
        "exact": [lanes.LaneSpec(1, 1e-2), lanes.LaneSpec(2, 3e-2)],
        "lqr": [lanes.LaneSpec(s, 1e-3, _o(), env=lqr) for s in (1, 2)],
    }


def _run_of(spec, cfg, env, pol, **kw):
    c = fedpg.FedPGConfig(**{**cfg.__dict__, "alpha": spec.alpha})
    return fedpg.run(spec.env or env, pol, c, spec.seed, ota=spec.ota,
                     participation=spec.participation,
                     staleness=spec.staleness, device="cpu", **kw)


@pytest.mark.parametrize("case", list(_lane_cases()))
def test_every_lane_is_bitwise_its_run(case):
    specs = _lane_cases()[case]
    cfg = fedpg.FedPGConfig(**SMALL, alpha=1e-2)
    env = specs[0].env or LandmarkNav()
    pol = envs.default_policy(env)
    theta, hist = lanes.run_lanes(LandmarkNav(), pol, cfg, specs,
                                  device="cpu")
    for i, spec in enumerate(specs):
        t1, h1 = _run_of(spec, cfg, LandmarkNav(), pol)
        for x, y in zip(h1, hist):
            assert torch.equal(x, y[i]), (case, i)
        for k in t1:
            assert torch.equal(t1[k], theta[k][i]), (case, i, k)


def test_monte_carlo_is_the_per_run_loop():
    cfg = fedpg.FedPGConfig(**SMALL, alpha=1e-2)
    p, st = ParticipationConfig(rate=0.5), StalenessConfig(2, 0.5)
    for kw in (dict(ota=_o()), dict(ota=_o(), participation=p,
                                    staleness=st)):
        hist = fedpg.monte_carlo(LandmarkNav(), MLPPolicy(), cfg, 5, 3,
                                 device="cpu", **kw)
        for i, s in enumerate(fedpg.run_seeds(5, 3)):
            h1 = fedpg.run(LandmarkNav(), MLPPolicy(), cfg, s, device="cpu",
                           **kw)[1]
            for x, y in zip(h1, hist):
                assert torch.equal(x, y[i])


def test_sweep_vmap_lanes_are_bitwise_fedpg_run():
    """A mixed grid (5 partitions): every (scenario, run) of ``"vmap"`` is
    ``fedpg.run`` with the scenario's settings and seed."""
    r = channel.RayleighChannel
    sc = (sweep.grid(channel=[r(1.0), r(2.0)], noise_sigma=[1e-3, 1e-2],
                     alpha=1e-2, debias=True, **SMALL)
          + sweep.grid(channel=r(), power_control=[
              power_control.TruncatedInversion(p_max=5.0),
              power_control.TruncatedInversion(p_max=8.0)],
              noise_sigma=1e-3, debias=True, **SMALL)
          + sweep.grid(channel=None, alpha=[1e-2, 3e-2], **SMALL)
          + sweep.grid(channel=r(), noise_sigma=1e-3, env=[
              envs.WindyLandmarkNav(wind=0.05),
              envs.WindyLandmarkNav(wind=0.1)], **SMALL)
          + sweep.grid(channel=r(), noise_sigma=1e-3, participation=[
              ParticipationConfig(rate=0.5), ParticipationConfig(rate=0.8)],
              staleness=StalenessConfig(4, 0.8), **SMALL))
    res = sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 2, device="cpu")
    assert res.n_partitions == 5 and res.history.rewards.shape == (12, 2, 4)
    seeds = fedpg.run_seeds(0, 2)
    for i, s in enumerate(sc):
        e, p = sweep.resolve_env_policy(s, LandmarkNav(), MLPPolicy())
        for j, seed in enumerate(seeds):
            h = fedpg.run(e, p, s.fedpg_config(), seed, ota=s.ota_config(),
                          participation=s.participation,
                          staleness=s.staleness, device="cpu")[1]
            for x, y in zip(h, res.history):
                np.testing.assert_array_equal(x.numpy(), y[i, j])
    assert all(res.scenario_time_us(i) > 0 for i in range(len(sc)))


def test_replicated_partition_and_lane_program():
    """Scenarios that differ only in their tag pack to nothing: one lane
    set runs and every scenario gets its history; lane_program exposes
    exactly the varying axes."""
    sc = [sweep.Scenario(channel=channel.RayleighChannel(), noise_sigma=1e-3,
                         tag=t, **SMALL) for t in ("a", "b")]
    res = sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 1, 2, device="cpu")
    np.testing.assert_array_equal(res.history.grad_sq[0],
                                  res.history.grad_sq[1])
    part = sweep.partition_scenarios(
        sweep.grid(channel=channel.RayleighChannel(), alpha=[1e-2, 2e-2],
                   **SMALL))[0]
    packed, fn, seeds = sweep.lane_program(LandmarkNav(), MLPPolicy(), part,
                                           2, device="cpu")
    assert list(packed) == ["alpha"] and len(seeds) == 2
    assert fn(seeds).grad_sq.shape == (2, 2, SMALL["n_rounds"])


def test_vmap_refuses_streamed_partitions_and_sharded_refuses():
    sc = sweep.grid(channel=channel.RayleighChannel(), agent_blocks=2,
                    **SMALL)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 1, mode="sharded",
                    device="cpu")
    res = sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 1, mode="map",
                      device="cpu")
    h = fedpg.run(LandmarkNav(), MLPPolicy(), sc[0].fedpg_config(),
                  fedpg.run_seeds(0, 1)[0], ota=sc[0].ota_config(),
                  agent_blocks=2, device="cpu")[1]
    np.testing.assert_array_equal(h.grad_sq.numpy(), res.history.grad_sq[0, 0])
    with pytest.raises(ValueError, match="mode"):
        sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 1, mode="pmap",
                    device="cpu")


def _controlled(base):
    from repro_torch.core.ota import OTAConfig
    return OTAConfig(power_control.ControlledChannel(
        base=base, policy=power_control.TruncatedInversion()),
        noise_sigma=1e-3)


@pytest.mark.parametrize("second", ["exact", "controlled_base"])
def test_lanes_refuse_mixed_structure(second):
    """``run_lanes`` refuses lanes whose ``lanes.structure_key`` differs,
    the key the sweep partitions by: the exact uplink beside Algorithm 2,
    and two controlled channels over different base channels."""
    cfg = fedpg.FedPGConfig(**SMALL)
    if second == "exact":
        pair = [lanes.LaneSpec(1, 1e-2, _o()), lanes.LaneSpec(2, 1e-2, None)]
    else:
        pair = [lanes.LaneSpec(1, 1e-2, _controlled(
                    channel.RayleighChannel())),
                lanes.LaneSpec(2, 1e-2, _controlled(
                    channel.NakagamiChannel()))]
    assert lanes.structure_key(pair[0]) != lanes.structure_key(pair[1])
    with pytest.raises(ValueError, match="structure"):
        lanes.run_lanes(LandmarkNav(), MLPPolicy(), cfg, pair, device="cpu")


def test_norm_const64_is_the_channel_mean():
    assert math.isclose(sweep._norm_const64(sweep.Scenario(
        channel=channel.RayleighChannel(), debias=True)),
        math.sqrt(math.pi / 2))
    assert math.isclose(sweep._norm_const64(sweep.Scenario(
        channel=channel.RayleighChannel(), debias=True)),
        math.sqrt(math.pi / 2))


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    sc = sweep.grid(channel=channel.RayleighChannel(), **SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        lanes.run_lanes(LandmarkNav(), MLPPolicy(), fedpg.FedPGConfig(**SMALL),
                        [lanes.LaneSpec(1, 1e-2, _o())])
    with pytest.raises(RuntimeError, match="CUDA"):
        fedpg.monte_carlo(LandmarkNav(), MLPPolicy(),
                          fedpg.FedPGConfig(**SMALL), 0, 2, ota=_o())


@pytest.mark.parametrize("name", ["mlp", "tabular", "gaussian"])
def test_grad_log_prob_is_autograd_of_log_prob(name):
    """Each policy's closed-form ``grad_log_prob`` (what G(PO)MDP sums)
    against ``torch.func.grad`` of its ``log_prob`` on a handful of rows,
    flat in sorted-key order; rounding apart (rtol 1e-5, atol 1e-6)."""
    from torch.func import grad, vmap

    from repro_torch.rl.policy import GaussianPolicy, TabularSoftmaxPolicy
    gen = torch.Generator().manual_seed(3)
    if name == "mlp":
        pol = MLPPolicy()
        obs = torch.randn((6, pol.obs_dim), generator=gen)
    elif name == "tabular":
        pol = TabularSoftmaxPolicy(n_states=5, n_actions=4)
        obs = torch.nn.functional.one_hot(
            torch.randint(0, 5, (6,), generator=gen), 5).float()
    else:
        pol = GaussianPolicy()
        obs = torch.randn((6, pol.obs_dim), generator=gen)
    theta = pol.init(gen, "cpu")
    acts = pol.sample(theta, obs, gen)
    got = pol.grad_log_prob(theta, obs, acts)
    per_row = vmap(grad(pol.log_prob), in_dims=(None, 0, 0))(theta, obs, acts)
    want = torch.cat([per_row[k].reshape(obs.shape[0], -1)
                      for k in sorted(per_row)], dim=1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
