"""The agent-mesh forms of the PyTorch port on four CPU ranks (``gloo``).

One group of four spawned ranks (``launch.mesh.run_local``) runs every case
of this module once (the module-scoped fixture); the tests read its
results.  At the golden suite's SMALL size (M=2, T=6, K=4; N=8 stacked, two
agents a rank; N=10 streamed, padded to 12 so the last rank holds one
agent), against the port's own runs off the mesh with the same seed:

* round by round from a common state (``make_round_fn(agent_mesh=)`` fed
  the unmeshed chain's theta and a generator in the same state): reward,
  ``gain_mean``, the participation rate and the norm probes bitwise;
  ``grad_sq``, the SNR probe and theta' within rtol 1e-5, atol 1e-6 (the
  ranks' partial sums meet in one ``all_reduce``, another association than
  the fold off the mesh);
* K=4 chained rounds through ``fedpg.run(agent_mesh=)``: ``gain_mean``
  bitwise (the draws do not depend on theta), the rest and theta_K within
  the same tolerance;
* stacked and streamed (blocks 1/2/3 bitwise each other), the exact uplink,
  the streamed service round (Bernoulli 0.5), ``HeterogeneousBudget``,
  ``HeterogeneousEnv`` fleets, ``monte_carlo(agent_mesh=)`` as lanes, and
  telemetry;
* every rank's theta and history bitwise the same;
* the guards, ``agent_mesh_for``'s subgroup (N=6: ranks 0-2, rank 3 sits
  out), the axis forms of ``ota.aggregate`` against the stacked form, the
  psum train step's exact form against ``make_train_step``'s (smoke llama,
  granite-moe and mamba2), and the launcher's error paths.

This file imports nothing of JAX: the spawned ranks import it to find
their functions.  ``test_torch_agent_mesh_parity.py`` holds the mesh forms
to the JAX package's.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.core import distribute, fedpg, ota
from repro_torch.core.channel import RayleighChannel
from repro_torch.core.power_control import HeterogeneousBudget
from repro_torch.launch import mesh as mesh_lib
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.envs import WindyLandmarkNav, make_heterogeneous_env
from repro_torch.rl.policy import MLPPolicy
from repro_torch.service.participation import ParticipationConfig
from repro_torch.service.staleness import StalenessConfig
from repro_torch.telemetry.probes import TelemetryConfig

RANKS = 4
SMALL = dict(batch_m=2, horizon=6, n_rounds=4, alpha=0.05, gamma=0.99)
N_STACKED, N_STREAMED = 8, 10
SEED = 3
TOL = dict(rtol=1e-5, atol=1e-6)
BERNOULLI = ParticipationConfig(kind="bernoulli", rate=0.5)
# the probes that are functions of the per-agent norms and the gains alone
EXACT_PROBES = ("grad_norm_pre", "moment_drift", "dispersion",
                "participation_rate", "participation_drift")


def _cfg(n):
    return fedpg.FedPGConfig(n_agents=n, **SMALL)


def _ota(sigma=1e-2, pc=None):
    return ota.OTAConfig(RayleighChannel(), noise_sigma=sigma, debias=True,
                         power_control=pc)


def _fleet(n):
    return make_heterogeneous_env(
        [WindyLandmarkNav(wind=0.02 * i, gust_sigma=0.01) for i in range(n)])


# (N, env factory, run kwargs) of every chained case
RUNS = {
    "stacked": (N_STACKED, LandmarkNav, dict(ota=_ota())),
    "stacked_exact": (N_STACKED, LandmarkNav, dict()),
    "stacked_telemetry": (N_STACKED, LandmarkNav,
                          dict(ota=_ota(), telemetry=TelemetryConfig())),
    "budget": (N_STACKED, LandmarkNav,
               dict(ota=_ota(pc=HeterogeneousBudget(p_max=3.0)))),
    "fleet": (N_STACKED, lambda: _fleet(N_STACKED), dict(ota=_ota())),
    "streamed_1": (N_STREAMED, LandmarkNav, dict(ota=_ota(), agent_blocks=1)),
    "streamed_2": (N_STREAMED, LandmarkNav, dict(ota=_ota(), agent_blocks=2)),
    "streamed_3": (N_STREAMED, LandmarkNav, dict(ota=_ota(), agent_blocks=3)),
    "streamed_exact": (N_STREAMED, LandmarkNav, dict(agent_blocks=2)),
    "streamed_fleet": (N_STREAMED, lambda: _fleet(N_STREAMED),
                       dict(ota=_ota(), agent_blocks=2)),
    "service": (N_STREAMED, LandmarkNav,
                dict(ota=_ota(), agent_blocks=2, participation=BERNOULLI,
                     telemetry=TelemetryConfig())),
}
# (N, run kwargs) of the round-by-round cases
ROUNDS = {
    "stacked": (N_STACKED, dict(ota_cfg=_ota(), telemetry=TelemetryConfig())),
    "streamed": (N_STREAMED, dict(ota_cfg=_ota(), agent_blocks=3,
                                  telemetry=TelemetryConfig())),
    "service": (N_STREAMED, dict(ota_cfg=_ota(), agent_blocks=2,
                                 participation=BERNOULLI,
                                 telemetry=TelemetryConfig())),
}
MC_RUNS = 3
DRAW_CASES = ("stacked", "streamed_3", "budget", "service")


def _run(name, mesh):
    n, env, kw = RUNS[name]
    return fedpg.run(env(), MLPPolicy(), _cfg(n), SEED, agent_mesh=mesh,
                     device="cpu", **kw)


def _round_by_round(name, mesh):
    """K rounds of the unmeshed round (``mesh=None``) from theta_0; with a
    mesh, each round from the unmeshed chain's theta_k.  Both draw round k
    from a generator seeded 100 + k.  Returns the per-round metrics and
    theta' of each round."""
    n, kw = ROUNDS[name]
    kw = dict(kw)
    part = kw.get("participation")
    cfg, pol = _cfg(n), MLPPolicy()
    ota_cfg = kw.pop("ota_cfg")
    plain = fedpg.make_round_fn(LandmarkNav(), pol, cfg, ota_cfg, **kw)
    meshed = plain if mesh is None else fedpg.make_round_fn(
        LandmarkNav(), pol, cfg, ota_cfg, agent_mesh=mesh, **kw)
    theta = pol.init(torch.Generator().manual_seed(SEED), "cpu")
    carry = theta
    if part is not None:
        from repro_torch.service import participation as svc_part

        carry = svc_part.init_state(theta, torch.tensor(7), n)
    out = []
    for k in range(cfg.n_rounds):
        nxt, metrics = meshed(carry, torch.Generator().manual_seed(100 + k))
        out.append((metrics, nxt if part is None else nxt.theta))
        carry, _ = plain(carry, torch.Generator().manual_seed(100 + k))
    return out


def _draws(name, mesh):
    """Every tensor a run's rounds draw (initial states, policy and env
    noise, gains, kernel seeds, service masks), recorded as the run makes
    them."""
    from unittest import mock

    from repro_torch.core import lanes

    seen = []

    def record(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen.extend(x.clone() for x in (out if isinstance(out, tuple)
                                            else (out,))
                        if isinstance(x, torch.Tensor))
            return out
        return wrapped

    with mock.patch.object(lanes, "_draw_rollouts",
                           record(lanes._draw_rollouts)), \
            mock.patch.object(lanes, "_uplink_draws",
                              record(lanes._uplink_draws)), \
            mock.patch.object(lanes, "_round_mask", record(lanes._round_mask)):
        _run(name, mesh)
    return seen


def _raises(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _guards(mesh):
    env, pol = LandmarkNav(), MLPPolicy()
    return {
        "staleness": _raises(lambda: fedpg.run(
            env, pol, _cfg(N_STACKED), 0, ota=_ota(), agent_blocks=2,
            participation=BERNOULLI, staleness=StalenessConfig(4, 0.8),
            agent_mesh=mesh, device="cpu")),
        "participation": _raises(lambda: fedpg.make_round_fn(
            env, pol, _cfg(N_STACKED), _ota(), participation=BERNOULLI,
            agent_mesh=mesh)),
        "divide": _raises(lambda: fedpg.run(
            env, pol, _cfg(N_STREAMED), 0, ota=_ota(), agent_mesh=mesh,
            device="cpu")),
        "too_many": _raises(lambda: mesh_lib.make_agent_mesh(RANKS + 1)),
        "local_stack": _raises(lambda: ota.aggregate(
            {"w": torch.ones(2, 3)}, None, local_stack=True)),
    }


def _subgroup():
    """``agent_mesh_for(6)`` on four ranks: a mesh of ranks 0-2; the
    stacked run on it (rank 3 gets None and runs nothing)."""
    sub = distribute.agent_mesh_for(6)
    if sub is None:
        return None
    return sub.size, fedpg.run(LandmarkNav(), MLPPolicy(), _cfg(6), SEED,
                               ota=_ota(), agent_mesh=sub, device="cpu")


def _stack(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(n, 3, 4, generator=gen),
            "b": torch.randn(n, 5, generator=gen)}


def _aggregates(mesh):
    """``ota.aggregate``'s axis forms on this rank's rows of an (N, ...)
    stack drawn alike on every rank (rank r holds rows [3r, 3r + 3), N=10
    pads the last rank with two phantom rows); gains and seed injected."""
    n, n_local = N_STREAMED, 3
    stack = _stack(RANKS * n_local, 11)
    mine = {k: v[mesh.rank * n_local:(mesh.rank + 1) * n_local]
            for k, v in stack.items()}
    gains = torch.rand(n, generator=torch.Generator().manual_seed(12)) + 0.5
    kw = dict(gains=gains, seed=1234, mesh=mesh, local_stack=True,
              n_agents=n)
    one = {k: v[mesh.rank] for k, v in stack.items()}
    return {
        "noisy": ota.aggregate(mine, _ota(), **kw)[0],
        "noisy_blocks": ota.aggregate(mine, _ota(), agent_blocks=2, **kw)[0],
        "exact": ota.aggregate(mine, None, mesh=mesh, local_stack=True,
                               n_agents=n)[0],
        "exact_blocks": ota.aggregate(mine, None, mesh=mesh, local_stack=True,
                                      n_agents=n, agent_blocks=2)[0],
        "h_local": ota.aggregate(mine, _ota(), **kw)[1],
        "axis": ota.aggregate(one, _ota(), gains=gains[:RANKS], seed=1234,
                              mesh=mesh)[0],
        "axis_exact": ota.aggregate(one, None, mesh=mesh)[0],
        # a bf16 wire over a mixed tree: one bf16 row, summed in bf16
        "axis_wire": ota.aggregate(
            {"a": one["a"].bfloat16(), "b": one["b"]},
            dataclasses.replace(_ota(), wire_dtype="bfloat16"),
            gains=gains[:RANKS], seed=1234, mesh=mesh)[0],
    }


PSUM_LR = 1e-2


PSUM_ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "mamba2-130m",
              "seamless-m4t-large-v2")


def smoke_model(arch="llama3.2-3b"):
    """SMOKE ``arch`` in float32, as ``test_torch_trainer.py`` trains it.
    The moe family's capacity and load-balance loss are functions of one
    forward's tokens: a rank's forward sees its own sequences, the unmeshed
    step's every agent's (as in the JAX package's psum step), so the two
    steps agree where nothing drops (capacity factor 4.0) and without the
    load-balance term (coefficient 0; the mean of the ranks' aux is not the
    aux of all their tokens)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib

    cfg = get_smoke_config(arch).with_(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0, load_balance_coef=0.0))
    return model_lib.build(cfg)


def _psum_exact_step(mesh, arch="llama3.2-3b"):
    """One exact step of the psum form on every rank of the mesh (or,
    without one, of ``make_train_step`` over as many agents)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_batch
    from repro_torch.train import trainer

    model = smoke_model(arch)
    tcfg = trainer.TrainConfig(aggregator="exact", n_agents=RANKS,
                               lr=PSUM_LR, warmup=2, total_steps=10)
    state = trainer.init_state(model, tcfg, device="cpu")
    batch = make_batch(model.cfg, InputShape("t", 16, 2 * RANKS, "train"), 0,
                       device="cpu")     # seamless: with its memory stub
    step = (trainer.make_train_step(model, tcfg) if mesh is None
            else trainer.make_psum_train_step(model, tcfg, mesh))
    state, m = step(state, batch)
    return state.params, {k: float(v) for k, v in m.items()}


def params_close(have, want, lr_t):
    """``test_torch_trainer.py``'s rule for one AdamW step taken from the
    same state by two reductions of the same gradient: rtol 1e-5, atol 1e-6
    on all but 5e-4 of the elements, every element within ``2 lr_t`` (AdamW
    divides each element by its own RMS, so a gradient element at the level
    of float32 rounding moves by rounding over rounding)."""
    n_out = n_all = 0
    for k, w in want.items():
        diff = (have[k].float() - w.float()).abs()
        n_out += int((diff > 1e-6 + 1e-5 * w.float().abs()).sum())
        n_all += w.numel()
        assert float(diff.max()) <= 2 * lr_t * 1.01 + 1e-6, k
    assert n_out <= 5e-4 * n_all, (n_out, n_all)


def _mesh_cases(mesh):
    """Every case of the module on this rank of the four-rank mesh."""
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(mesh.device)}
    out["runs"] = {name: _run(name, mesh) for name in RUNS}
    out["draws"] = {name: _draws(name, mesh) for name in DRAW_CASES}
    out["monte_carlo"] = fedpg.monte_carlo(
        LandmarkNav(), MLPPolicy(), _cfg(N_STREAMED), SEED, MC_RUNS,
        ota=_ota(), agent_blocks=2, agent_mesh=mesh, device="cpu")
    out["rounds"] = {name: _round_by_round(name, mesh) for name in ROUNDS}
    out["guards"] = _guards(mesh)
    out["subgroup"] = _subgroup()
    out["aggregates"] = _aggregates(mesh)
    out["psum_exact"] = {a: _psum_exact_step(mesh, a) for a in PSUM_ARCHS}
    mesh_lib.ALL_REDUCES = mesh_lib.ALL_GATHERS = 0
    _run("streamed_3", mesh)
    out["collectives"] = (mesh_lib.ALL_REDUCES, mesh_lib.ALL_GATHERS)
    return out


@pytest.fixture(scope="module")
def ranks():
    return mesh_lib.run_local(_mesh_cases, RANKS, device="cpu", timeout=600)


@pytest.fixture(scope="module")
def plain():
    """The unmeshed runs of every case, in this process."""
    return {name: _run(name, None) for name in RUNS}


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=what,
                               **TOL)


def _close_at(a, b, rtol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=rtol, err_msg=what)


def _bitwise(a, b, what):
    assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True), what


def _theta_close(a, b):
    for k in a:
        _close(a[k], b[k], k)


def test_the_group_is_four_cpu_ranks(ranks):
    assert [r["rank"] for r in ranks] == list(range(RANKS))
    assert all(r["size"] == RANKS and r["device"] == "cpu" for r in ranks)


@pytest.mark.parametrize("name", list(RUNS))
def test_chained_runs_match_the_unmeshed_run(ranks, plain, name):
    """K=4 chained rounds: the gains (and ``gain_mean``) are the run's own
    draws, bitwise; the rest within the tolerance of one association."""
    theta, hist = ranks[0]["runs"][name]
    theta_p, hist_p = plain[name]
    _bitwise(hist.gain_mean, hist_p.gain_mean, "gain_mean")
    _close(hist.rewards, hist_p.rewards, "reward")
    _close(hist.grad_sq, hist_p.grad_sq, "grad_sq")
    _theta_close(theta, theta_p)
    if hist_p.telemetry is not None:
        for f, a, b in zip(hist.telemetry._fields, hist.telemetry,
                           hist_p.telemetry):
            if b is not None:
                _close(a, b, f)
    else:
        assert hist.telemetry is None


@pytest.mark.parametrize("name", DRAW_CASES)
def test_every_rank_draws_the_runs_draws(ranks, name):
    """Every rank makes every draw of the round, bitwise the run off the
    mesh: the initial states, the noise, the gains (per-agent budgets
    too), the kernel seeds and the service masks."""
    want = _draws(name, None)
    for r in ranks:
        got = r["draws"][name]
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            _bitwise(a, b, f"rank {r['rank']} draw {i}")


@pytest.mark.parametrize("name", list(RUNS))
def test_every_rank_ends_bitwise_the_same(ranks, name):
    theta0, hist0 = ranks[0]["runs"][name]
    for r in ranks[1:]:
        theta, hist = r["runs"][name]
        for k in theta0:
            _bitwise(theta[k], theta0[k], f"rank {r['rank']} theta {k}")
        for f, a, b in zip(hist0._fields, hist, hist0):
            _bitwise(a, b, f"rank {r['rank']} {f}")
        if hist0.telemetry is not None:
            for f, a, b in zip(hist0.telemetry._fields, hist.telemetry,
                               hist0.telemetry):
                if b is not None:
                    _bitwise(a, b, f"rank {r['rank']} {f}")


def test_streamed_mesh_runs_are_bitwise_across_block_sizes(ranks):
    """Blocks 1, 2 and 3 over a rank's three agents (the last rank's one):
    the same strict fold on every rank, bitwise each other."""
    t1, h1 = ranks[0]["runs"]["streamed_1"]
    for name in ("streamed_2", "streamed_3"):
        t, h = ranks[0]["runs"][name]
        for f, a, b in zip(h1._fields, h, h1):
            _bitwise(a, b, f"{name} {f}")
        for k in t1:
            _bitwise(t[k], t1[k], f"{name} theta {k}")


@pytest.mark.parametrize("name", list(ROUNDS))
def test_round_by_round_from_a_common_state(ranks, name):
    """From the unmeshed chain's theta_k with the same generator state:
    reward, gain_mean, the participation rate and the norm probes bitwise;
    grad_sq, the SNR and theta' within the tolerance."""
    mesh_rounds = ranks[0]["rounds"][name]
    plain_rounds = _round_by_round(name, None)
    for k, ((m, theta), (mp, theta_p)) in enumerate(zip(mesh_rounds,
                                                         plain_rounds)):
        _bitwise(m[0], mp[0], f"round {k} reward")
        _bitwise(m[2], mp[2], f"round {k} gain_mean")
        _close(m[1], mp[1], f"round {k} grad_sq")
        _theta_close(theta, theta_p)
        tel, tel_p = m[3], mp[3]
        for f in EXACT_PROBES:
            if getattr(tel_p, f) is not None:
                _bitwise(getattr(tel, f), getattr(tel_p, f), f"round {k} {f}")
        _close(tel.snr, tel_p.snr, f"round {k} snr")
        _close(tel.grad_norm_post, tel_p.grad_norm_post,
               f"round {k} grad_norm_post")


def test_monte_carlo_on_the_mesh_runs_its_runs_as_lanes(ranks):
    hist = ranks[0]["monte_carlo"]
    want = fedpg.monte_carlo(LandmarkNav(), MLPPolicy(), _cfg(N_STREAMED),
                             SEED, MC_RUNS, ota=_ota(), agent_blocks=2,
                             device="cpu")
    assert hist.rewards.shape == (MC_RUNS, SMALL["n_rounds"])
    _bitwise(hist.gain_mean, want.gain_mean, "gain_mean")
    _close(hist.rewards, want.rewards, "reward")
    _close(hist.grad_sq, want.grad_sq, "grad_sq")
    # each lane is that run on the mesh, bitwise
    seeds = fedpg.run_seeds(SEED, MC_RUNS)
    one = fedpg.run(LandmarkNav(), MLPPolicy(), _cfg(N_STREAMED), seeds[1],
                    ota=_ota(), agent_blocks=2, device="cpu")[1]
    _close(hist.lane(1).rewards, one.rewards, "lane 1 reward")
    for r in ranks[1:]:
        for a, b in zip(r["monte_carlo"], hist):
            _bitwise(a, b, "monte_carlo across ranks")


def test_one_all_reduce_and_one_all_gather_a_round(ranks):
    for r in ranks:
        assert r["collectives"] == (SMALL["n_rounds"], SMALL["n_rounds"])


@pytest.mark.parametrize("guard,words", [
    ("staleness", "staleness replay does not compose"),
    ("participation", "needs agent_blocks"),
    ("divide", "does not divide"),
    ("too_many", "out of range"),
    ("local_stack", "needs an agent mesh")])
def test_the_guards_raise(ranks, guard, words):
    for r in ranks:
        assert r["guards"][guard] is not None and words in \
            r["guards"][guard], r["guards"][guard]


def test_agent_mesh_for_takes_the_largest_dividing_group(ranks):
    assert ranks[3]["subgroup"] is None
    size, (theta, hist) = ranks[0]["subgroup"]
    assert size == 3
    theta_p, hist_p = fedpg.run(LandmarkNav(), MLPPolicy(), _cfg(6), SEED,
                                ota=_ota(), device="cpu")
    _bitwise(hist.gain_mean, hist_p.gain_mean, "gain_mean")
    _close(hist.rewards, hist_p.rewards, "reward")
    _theta_close(theta, theta_p)
    for r in ranks[1:3]:
        _bitwise(r["subgroup"][1][1].rewards, hist.rewards, "subgroup ranks")
    assert [distribute.agent_mesh_size(n, 4) for n in (8, 6, 9, 7, 10)] \
        == [4, 3, 3, 1, 2]


def test_aggregate_axis_forms_match_the_stacked_form(ranks):
    """The padded stack's real rows through the axis-stacked forms (fold,
    blocked fold, exact) against ``aggregate`` over the same N rows off the
    mesh; the one-agent-a-rank form against the stack of the four rows."""
    n = N_STREAMED
    stack = {k: v[:n] for k, v in _stack(RANKS * 3, 11).items()}
    gains = torch.rand(n, generator=torch.Generator().manual_seed(12)) + 0.5
    want, _ = ota.aggregate(stack, _ota(), gains=gains, seed=1234,
                            backend="torch")
    exact, _ = ota.aggregate(stack, None)
    four = {k: v[:RANKS] for k, v in _stack(RANKS * 3, 11).items()}
    want_axis, _ = ota.aggregate(four, _ota(), gains=gains[:RANKS],
                                 seed=1234, backend="torch")
    exact_axis, _ = ota.aggregate(four, None)
    for r in ranks:
        got = r["aggregates"]
        for k in want:
            _close(got["noisy"][k], want[k], f"noisy {k}")
            _bitwise(got["noisy_blocks"][k], got["noisy"][k],
                     f"blocks {k}")
            _close(got["exact"][k], exact[k], f"exact {k}")
            _close(got["exact_blocks"][k], exact[k], f"exact blocks {k}")
            _close(got["axis"][k], want_axis[k], f"axis {k}")
            _close(got["axis_exact"][k], exact_axis[k], f"axis exact {k}")
        # the bf16 wire: the rows and their sum rounded to bf16 on the way
        wire = got["axis_wire"]
        assert wire["a"].dtype == torch.bfloat16
        assert wire["b"].dtype == torch.float32
        for k in want_axis:
            _close_at(wire[k].float(), want_axis[k], 2e-2, f"axis wire {k}")
    h_last = ranks[-1]["aggregates"]["h_local"]
    assert h_last.shape == (3,) and torch.equal(h_last[1:], torch.zeros(2))
    _bitwise(h_last[0], gains[9], "the last rank's one real gain")


def test_psum_exact_step_matches_the_plain_exact_step(ranks):
    """Four ranks of two sequences each against ``make_train_step`` over
    four agents of two, from the same state: the same mean gradient,
    another association; metrics at rtol 1e-5, parameters by
    :func:`params_close`."""
    _check_psum_exact(ranks, "llama3.2-3b")


@pytest.mark.parametrize("arch", PSUM_ARCHS[1:3])
def test_psum_exact_step_of_the_moe_and_ssm_families(ranks, arch):
    """The same for the moe family (routing and dispatch in each rank's
    forward; see :func:`smoke_model`) and the ssm family (the plain scan):
    the psum step takes every trained family."""
    _check_psum_exact(ranks, arch)


def test_psum_exact_step_of_the_encdec_family(ranks):
    """The same for the encdec family: each rank's slice of the batch
    carries its sequences' frame embeddings through the encoder and the
    cross attention."""
    _check_psum_exact(ranks, "seamless-m4t-large-v2")


def _check_psum_exact(ranks, arch):
    from repro_torch.optim.optimizers import warmup_cosine
    from repro_torch.utils.tree import flatten_paths

    params, metrics = ranks[0]["psum_exact"][arch]
    params_p, metrics_p = _psum_exact_step(None, arch)
    for k in ("loss", "grad_norm", "update_norm"):
        np.testing.assert_allclose(metrics[k], metrics_p[k], rtol=1e-5,
                                   err_msg=k)
    lr_t = warmup_cosine(PSUM_LR, 2, 10)(torch.tensor(1)).item()
    flat = flatten_paths(params)
    params_close(flat, flatten_paths(params_p), lr_t)
    for r in ranks[1:]:
        for k, v in flatten_paths(r["psum_exact"][arch][0]).items():
            _bitwise(v, flat[k], f"rank {r['rank']} {k}")


# ---------------------------------------------------------------------------
# The port's side of test_torch_agent_mesh_parity.py: JAX-free, so the
# spawned ranks of that file import only this module.
# ---------------------------------------------------------------------------

PARITY_ROUNDS = {  # name: (N, agent_blocks, over the air)
    "stacked": (8, None, True),
    "stacked_exact": (8, None, False),
    "streamed": (10, 2, True),
}


def parity_ota(channel="rayleigh"):
    """Noise off, debias: the mesh forms' deterministic part."""
    from repro_torch.core.channel import FixedGainChannel

    chan = RayleighChannel() if channel == "rayleigh" \
        else FixedGainChannel(gain=1.3)
    return ota.OTAConfig(chan, noise_sigma=0.0, debias=True)


def _namespace_state(st):
    """A JAX TrainState sent as plain dicts -> ``interop``'s duck type."""
    from types import SimpleNamespace

    from repro_torch import interop

    return interop.train_state_from_jax(SimpleNamespace(
        params=st["params"], step=st["step"], opt_state=SimpleNamespace(
            step=st["opt_step"], mu=st["mu"], nu=st["nu"])), "cpu")


def parity_cases(mesh, refs):
    """This rank's side of every parity case, fed the JAX package's draws
    (``refs``, numpy only): the fedpg mesh rounds chained from JAX's
    theta_0, the axis forms of ``ota.aggregate`` on this rank's rows, and
    the psum train step on the first two ranks (ranks 2 and 3 sit out)."""
    from repro_torch import interop
    from repro_torch.train import trainer

    out = {"rounds": {}, "aggregates": {}}
    for name, (n, blocks, on_air) in PARITY_ROUNDS.items():
        ref = refs["rounds"][name]
        round_fn = fedpg.make_round_fn(
            LandmarkNav(), MLPPolicy(), _cfg(n),
            parity_ota() if on_air else None, agent_blocks=blocks,
            agent_mesh=mesh)
        theta = interop.from_numpy(ref["theta0"], "cpu")
        metrics = []
        for d in ref["draws"]:
            theta, m = round_fn(theta, None, fedpg.RoundDraws(
                s0=torch.from_numpy(d["s0"]),
                actions=torch.from_numpy(d["actions"]),
                gains=torch.from_numpy(d["gains"]), seed=0))
            metrics.append([x.item() for x in m])
        out["rounds"][name] = (metrics, interop.to_numpy(theta))
    agg = refs["aggregates"]
    rows = {k: torch.from_numpy(v) for k, v in agg["stack"].items()}
    n_local = agg["n_local"]
    mine = {k: v[mesh.rank * n_local:(mesh.rank + 1) * n_local]
            for k, v in rows.items()}
    for name, (chan, n, blocks) in agg["cases"].items():
        cfg = None if chan is None else parity_ota(chan)
        kw = dict(mesh=mesh, n_agents=n, agent_blocks=blocks,
                  generator=torch.Generator().manual_seed(0))
        if name.startswith("axis"):
            u, _ = ota.aggregate({k: v[mesh.rank] for k, v in rows.items()},
                                 cfg, mesh=mesh,
                                 generator=torch.Generator().manual_seed(0))
        else:
            u, _ = ota.aggregate(mine, cfg, local_stack=True, **kw)
        out["aggregates"][name] = interop.to_numpy(u)
    pair = mesh_lib.make_agent_mesh(2)
    if pair is not None:
        model = smoke_model()
        tcfg = trainer.TrainConfig(**refs["psum"]["config"])
        step = trainer.make_psum_train_step(model, tcfg, pair)
        steps = []
        for st in refs["psum"]["steps"]:
            state, m = step(_namespace_state(st["state"]),
                            {k: torch.from_numpy(v).long()
                             for k, v in st["batch"].items()},
                            (torch.from_numpy(st["gains"]), 0))
            steps.append(({k: float(v) for k, v in m.items()},
                          interop.params_to_jax(state.params)))
        out["psum"] = steps
    return out


def _raise_on_rank_two(mesh):
    if mesh.rank == 2:
        raise KeyError("rank two fails")
    mesh.all_reduce(torch.ones(1))   # the others wait in a collective
    return mesh.rank


def _die_on_rank_one(mesh):
    if mesh.rank == 1:
        os._exit(3)
    mesh.all_reduce(torch.ones(1))
    return mesh.rank


def test_launcher_reraises_a_ranks_exception_with_its_traceback():
    with pytest.raises(mesh_lib.RankError) as err:
        mesh_lib.run_local(_raise_on_rank_two, 3, device="cpu", timeout=60)
    assert err.value.rank == 2
    assert isinstance(err.value.__cause__, KeyError)
    assert "_raise_on_rank_two" in str(err.value)
    assert "rank two fails" in err.value.rank_traceback


def test_launcher_fails_when_a_rank_dies():
    with pytest.raises(mesh_lib.RankError, match="exited with code 3"):
        mesh_lib.run_local(_die_on_rank_one, 2, device="cpu", timeout=60)


def test_launcher_and_make_agent_mesh_refuse_bad_requests():
    with pytest.raises(ValueError, match="world_size"):
        mesh_lib.run_local(_raise_on_rank_two, 0, device="cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        mesh_lib.run_local(_raise_on_rank_two, 1, device="meta")
    with pytest.raises(RuntimeError, match="initialised"):
        mesh_lib.make_agent_mesh()
    with pytest.raises(RuntimeError, match="initialised"):
        distribute.agent_mesh_for(4)
