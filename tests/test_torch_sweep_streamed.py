"""The rest of the sweep engine of the PyTorch port: streamed lanes
(``lanes.run_lanes(agent_blocks=)``, ``monte_carlo(agent_blocks=)``,
streamed partitions in ``sweep(mode="vmap")``), ``HeterogeneousBudget``
lanes whose parameters vary, and ``sweep(mode="sharded")`` over
``core/distribute.py`` and ``launch/mesh.py``.

At the golden suite's SMALL size (N=3, M=2, T=6, K=4) on the CPU, bitwise:
every lane of a streamed lane-batched run is ``fedpg.run`` of its settings
and seed at ``agent_blocks`` 1, 2 and 3 (blocks of 2 leave a short tail
block; 3 is capped at ceil(N / 2) = 2, as in the JAX package), for the
plain round, the exact uplink, the service round with staleness (4, 0.8),
with telemetry on and under ``HeterogeneousBudget`` lanes; ``monte_carlo``
is the per-run loop; a streamed partition's
``"vmap"`` lanes are ``"map"``'s; ``"sharded"`` is ``"vmap"`` on a
four-device CPU mesh with a masked pad lane, on the replicate path and with
a run count the ``mc`` axis does not divide.  Against the JAX package: the
partition index groups of a grid with streamed and power-controlled
scenarios, ``pad_lanes`` on the same arrays, and the placement's padding
rule.
"""
import numpy as np
import pytest
import torch

from repro.core import channel as jax_channel
from repro.core import distribute as jax_distribute
from repro.core import power_control as jax_pc
from repro.core import sweep as jax_sweep
from repro_torch.core import distribute, fedpg, lanes, power_control, sweep
from repro_torch.core.channel import BatchedChannel, RayleighChannel
from repro_torch.core.ota import OTAConfig
from repro_torch.core.power_control import HeterogeneousBudget
from repro_torch.launch.mesh import Mesh, make_sweep_mesh
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy
from repro_torch.service.participation import ParticipationConfig
from repro_torch.service.staleness import StalenessConfig
from repro_torch.telemetry import trace as rtrace
from repro_torch.telemetry.probes import TelemetryConfig

SMALL = dict(n_agents=3, batch_m=2, horizon=6, n_rounds=4)
CPU4 = [torch.device("cpu")] * 4


def _ota(sigma=1e-3, pc=None):
    return OTAConfig(RayleighChannel(), noise_sigma=sigma, debias=True,
                     power_control=pc)


def _budget_ota(p_max):
    """Debiased by the budget mixture's effective mean, as a Scenario."""
    return sweep.Scenario(channel=RayleighChannel(), noise_sigma=1e-3,
                          debias=True, power_control=HeterogeneousBudget(
                              p_max=p_max), **SMALL).ota_config()


FORMS = {
    "plain": dict(ota=[_ota(1e-3), _ota(2e-3)]),
    "exact": dict(ota=[None, None]),
    "service_stale": dict(ota=[_ota(1e-3), _ota(2e-3)],
                          participation=ParticipationConfig(rate=0.5),
                          staleness=StalenessConfig(4, 0.8)),
    "telemetry": dict(ota=[_ota(1e-3), _ota(2e-3)],
                      participation=ParticipationConfig(rate=0.5),
                      staleness=StalenessConfig(4, 0.8),
                      telemetry=TelemetryConfig()),
    "budgets": dict(ota=[_budget_ota(1.5), _budget_ota(3.0)]),
}


def _same(a, b):
    """Histories (and their probes) bitwise equal, NaN equal to NaN."""
    assert all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))
    if a.telemetry is None:
        assert b.telemetry is None
        return
    for x, y in zip(a.telemetry, b.telemetry):
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(np.asarray(x), np.asarray(y),
                                  equal_nan=True)


@pytest.mark.parametrize("agent_blocks", [1, 2, 3])
@pytest.mark.parametrize("form", list(FORMS))
def test_streamed_lanes_are_their_runs(form, agent_blocks):
    """Two settings x two seeds as four lanes of one streamed run: each lane
    bitwise ``fedpg.run(agent_blocks=)`` of its settings and seed, history,
    probes and theta_K."""
    kw = dict(FORMS[form])
    otas = kw.pop("ota")
    telem = kw.pop("telemetry", None)
    part, stale = kw.get("participation"), kw.get("staleness")
    cfg = fedpg.FedPGConfig(alpha=1e-2, **SMALL)
    specs = [lanes.LaneSpec(seed, cfg.alpha, o, None, part, stale)
             for o in otas for seed in (3, 11)]
    theta, hist = lanes.run_lanes(LandmarkNav(), MLPPolicy(), cfg, specs,
                                  telemetry=telem, agent_blocks=agent_blocks,
                                  device="cpu")
    for i, s in enumerate(specs):
        t1, h1 = fedpg.run(LandmarkNav(), MLPPolicy(), cfg, s.seed,
                           ota=s.ota, agent_blocks=agent_blocks,
                           telemetry=telem, device="cpu", **kw)
        _same(h1, hist.lane(i))
        assert all(torch.equal(t1[k], theta[k][i]) for k in t1)


def test_streamed_history_does_not_depend_on_the_lanes():
    """A streamed lane's history is the same alone and among others, and
    the same for every block size: the round is a strict fold."""
    cfg = fedpg.FedPGConfig(alpha=1e-2, **SMALL)
    specs = [lanes.LaneSpec(s, cfg.alpha, _ota()) for s in (1, 2, 3)]
    alone = lanes.run_lanes(LandmarkNav(), MLPPolicy(), cfg, specs[1:2],
                            agent_blocks=1, device="cpu")[1]
    for b in (1, 2):
        among = lanes.run_lanes(LandmarkNav(), MLPPolicy(), cfg, specs,
                                agent_blocks=b, device="cpu")[1]
        _same(alone.lane(0), among.lane(1))


@pytest.mark.parametrize("service", [False, True])
def test_monte_carlo_streamed_is_the_per_run_loop(service):
    cfg = fedpg.FedPGConfig(alpha=1e-2, **SMALL)
    kw = dict(participation=ParticipationConfig(rate=0.5),
              staleness=StalenessConfig(4, 0.8)) if service else {}
    mc = fedpg.monte_carlo(LandmarkNav(), MLPPolicy(), cfg, 5, 3, ota=_ota(),
                           agent_blocks=2, device="cpu", **kw)
    for i, seed in enumerate(fedpg.run_seeds(5, 3)):
        h = fedpg.run(LandmarkNav(), MLPPolicy(), cfg, seed, ota=_ota(),
                      agent_blocks=2, device="cpu", **kw)[1]
        _same(h, mc.lane(i))


def _grid():
    """A streamed partition, a stacked and a streamed HeterogeneousBudget
    partition, and a streamed exact uplink."""
    return (sweep.grid(channel=RayleighChannel(), noise_sigma=[1e-3, 2e-3],
                       debias=True, agent_blocks=2, **SMALL)
            + sweep.grid(channel=RayleighChannel(), noise_sigma=1e-3,
                         debias=True, agent_blocks=[None, 2],
                         power_control=[HeterogeneousBudget(p_max=1.5),
                                        HeterogeneousBudget(p_max=3.0)],
                         **SMALL)
            + sweep.grid(channel=None, alpha=[1e-3, 2e-3], agent_blocks=1,
                         **SMALL))


def test_vmap_streamed_and_budget_partitions_are_map():
    sc = _grid()
    env, pol = LandmarkNav(), MLPPolicy()
    res_v = sweep.sweep(env, pol, sc, 0, 2, device="cpu",
                        telemetry=TelemetryConfig())
    res_m = sweep.sweep(env, pol, sc, 0, 2, mode="map", device="cpu",
                        telemetry=TelemetryConfig())
    assert res_v.n_partitions == res_m.n_partitions == 4
    _same(res_m.history, res_v.history)
    # the budgets vary across the lanes of a partition: they are packed
    part = sweep.partition_scenarios(sc)[1]
    assert sorted(sweep._pack_partition(part)) == ["power_control",
                                                   "update_scale"]


def test_partitions_match_jax():
    """Both packages split a grid with streamed and budget scenarios
    alike: the partition key keeps the raw ``agent_blocks``."""
    axes = dict(noise_sigma=1e-3, debias=True, agent_blocks=[None, 1, 2],
                **SMALL)
    port = sweep.grid(channel=RayleighChannel(), power_control=[
        HeterogeneousBudget(p_max=1.5), HeterogeneousBudget(p_max=3.0)],
        **axes)
    jx = jax_sweep.grid(channel=jax_channel.RayleighChannel(), power_control=[
        jax_pc.HeterogeneousBudget(p_max=1.5),
        jax_pc.HeterogeneousBudget(p_max=3.0)], **axes)
    assert [p.indices for p in sweep.partition_scenarios(port)] == \
        [p.indices for p in jax_sweep.partition_scenarios(jx)]


@pytest.mark.parametrize("agent_blocks", [None, 2])
def test_budget_lanes_take_the_runs_linspace(agent_blocks):
    """``LaneBudgets`` rows are the runs' ``linspace`` bits, and a
    controlled channel over a varying budget samples as its channels do."""
    pols = [HeterogeneousBudget(0.3, 1.5), HeterogeneousBudget(0.1, 3.0)]
    table = power_control.LaneBudgets.of(pols, 7, "cpu").table
    c = torch.rand(7)
    for i, p in enumerate(pols):
        assert torch.equal(table[i] * c, p.apply(c) * c)
    chans = [power_control.make_controlled_channel(RayleighChannel(), p,
                                                   n_agents=3)
             for p in pols]
    kind, arrays = power_control._channel.batched_channel_arrays(chans)
    batched = BatchedChannel(kind=kind, params={
        k: torch.as_tensor(np.float32(v)) for k, v in arrays.items()})
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    got = batched.sample(gens, (3,), "cpu")
    for i, ch in enumerate(chans):
        want = ch.sample(torch.Generator().manual_seed(i + 1), (3,), "cpu")
        assert torch.equal(got[i], want)
    # and as lanes of a run over the controlled channels
    cfg = fedpg.FedPGConfig(alpha=1e-2, **SMALL)
    specs = [lanes.LaneSpec(4, cfg.alpha, OTAConfig(ch, noise_sigma=1e-3))
             for ch in chans]
    hist = lanes.run_lanes(LandmarkNav(), MLPPolicy(), cfg, specs,
                           agent_blocks=agent_blocks, device="cpu")[1]
    for i, s in enumerate(specs):
        _same(fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 4, ota=s.ota,
                        agent_blocks=agent_blocks, device="cpu")[1],
              hist.lane(i))


# ---------------------------------------------------------------------------
# mode="sharded": the mesh, the placement, the bitwise contract
# ---------------------------------------------------------------------------

def test_make_sweep_mesh_shapes():
    mesh = make_sweep_mesh(devices=CPU4)
    assert tuple(mesh.axis_names) == ("lane", "mc")
    assert mesh.shape == {"lane": 4, "mc": 1} and mesh.size == 4
    assert make_sweep_mesh(lane_shards=1, devices=CPU4).size == 1
    two = make_sweep_mesh(lane_shards=2, mc_shards=2, devices=CPU4)
    assert two.shape == {"lane": 2, "mc": 2}
    with pytest.raises(ValueError, match="devices"):
        make_sweep_mesh(lane_shards=3, mc_shards=2, devices=CPU4)
    with pytest.raises(ValueError, match="mc_shards"):
        make_sweep_mesh(mc_shards=0, devices=CPU4)
    with pytest.raises(ValueError, match="lane_shards"):
        make_sweep_mesh(lane_shards=0, devices=CPU4)
    if not torch.cuda.is_available():   # the default is the CUDA devices
        with pytest.raises(ValueError, match="CUDA"):
            make_sweep_mesh()
        with pytest.raises(ValueError, match="CUDA"):
            distribute.default_sweep_mesh()


def test_plan_placement():
    mesh = make_sweep_mesh(lane_shards=2, mc_shards=2, devices=CPU4)
    p = distribute.plan_placement
    uneven = p(mesh, n_lanes=3, mc_runs=4)
    assert (uneven.n_lanes, uneven.n_pad, uneven.n_devices) == (3, 1, 4)
    assert [(c.lanes.start, c.lanes.stop, c.runs.start, c.runs.stop)
            for c in uneven.cells] == [(0, 2, 0, 2), (0, 2, 2, 4),
                                       (2, 4, 0, 2), (2, 4, 2, 4)]
    # runs the mc axis does not divide: each lane row's first device
    odd = p(mesh, n_lanes=4, mc_runs=3)
    assert [(c.lanes.start, c.runs.stop) for c in odd.cells] == [(0, 3),
                                                                 (2, 3)]
    # the replicate path spreads the runs over the whole mesh when it can
    assert len(p(mesh, n_lanes=0, mc_runs=8).cells) == 4
    assert len(p(mesh, n_lanes=0, mc_runs=5).cells) == 1
    # the padding rule is the JAX package's
    for n_lanes in (1, 2, 3, 5):
        assert p(mesh, n_lanes, 2).n_pad == -n_lanes % 2
    bad = Mesh(np.array([torch.device("cpu")], dtype=object), ("agents",))
    with pytest.raises(ValueError, match="lane"):
        distribute.plan_placement(bad, 4, 2)


def test_pad_lanes_replicates_last_lane():
    arrays = {"a": np.arange(3.0), "b": {"c": np.arange(6.0).reshape(3, 2)}}
    padded = distribute.pad_lanes(
        {"a": torch.arange(3.0),
         "b": {"c": torch.arange(6.0).reshape(3, 2)}}, 2)
    want = jax_distribute.pad_lanes(arrays, 2)
    np.testing.assert_array_equal(padded["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(padded["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))
    assert distribute.pad_lanes(arrays, 0) is arrays
    assert distribute.pad_lanes(["x", "y"], 2) == ["x", "y", "y", "y"]


@pytest.mark.parametrize("case", ["pad_lane", "replicate", "odd_runs"])
def test_sharded_is_vmap(case):
    """``sweep(mode="sharded")`` on a four-device CPU mesh (2 lane x 2 mc)
    is bitwise ``mode="vmap"``: three scenarios, one pad lane masked; a
    partition that packs to nothing; three runs the mc axis does not
    divide.  Each partition records ``dispatch`` and ``materialize``."""
    sc = sweep.grid(channel=RayleighChannel(), debias=True,
                    noise_sigma=[1e-3, 2e-3, 5e-3], agent_blocks=2, **SMALL)
    runs = 2
    if case == "replicate":
        sc = [sweep.Scenario(channel=RayleighChannel(), noise_sigma=1e-3,
                             tag=t, **SMALL) for t in "ab"]
        runs = 4
    elif case == "odd_runs":
        runs = 3
    mesh = make_sweep_mesh(lane_shards=2, mc_shards=2, devices=CPU4)
    env, pol = LandmarkNav(), MLPPolicy()
    rv = sweep.sweep(env, pol, sc, 1, runs, device="cpu")
    rtrace.reset()
    rs = sweep.sweep(env, pol, sc, 1, runs, mode="sharded", mesh=mesh)
    _same(rv.history, rs.history)
    assert (rs.mode, rs.n_devices, rv.n_devices) == ("sharded", 4, 1)
    assert all(p.wall_time_us > 0 for p in rs.partitions)
    names = [s.name for s in rtrace.spans()]
    assert names.count("dispatch") == names.count("materialize") == 1
    assert "partition" not in names


def test_sharded_on_one_device_and_mesh_refusals():
    """``device=`` alone is a one-device mesh; ``mesh=`` needs
    ``mode="sharded"`` and excludes ``device=``."""
    sc = sweep.grid(channel=RayleighChannel(), alpha=[1e-2, 2e-2],
                    agent_blocks=2, **SMALL)
    env, pol = LandmarkNav(), MLPPolicy()
    rs = sweep.sweep(env, pol, sc, 0, 2, mode="sharded", device="cpu")
    assert rs.n_devices == 1
    _same(sweep.sweep(env, pol, sc, 0, 2, device="cpu").history, rs.history)
    mesh = make_sweep_mesh(devices=CPU4[:1])
    with pytest.raises(ValueError, match="mode='sharded'"):
        sweep.sweep(env, pol, sc, 0, 2, mesh=mesh)
    with pytest.raises(ValueError, match="not both"):
        sweep.sweep(env, pol, sc, 0, 2, mode="sharded", mesh=mesh,
                    device="cpu")
