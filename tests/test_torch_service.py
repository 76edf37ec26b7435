"""The round service of the PyTorch port (``repro_torch.service`` and the
service rounds of ``fedpg``) against the JAX package, and its own
contracts.

Against JAX: K=4 chained rounds at the golden suite's SMALL size (N=3, M=2,
T=6) of ``repro.core.fedpg.run(..., ota_backend="pallas",
participation=, staleness=, agent_blocks=)``, the port fed each round's JAX
draws — initial states, actions, gains, kernel seed, and the mask JAX's
``round_mask`` draws from the run's keys (torch cannot replay threefry).
rtol=1e-5, atol=1e-6 on the history and theta, the chained-round tolerance
of ``test_torch_fedpg.py``.  The subset mask is PRNG-free and is not
injected: the port's own mask must equal JAX's exactly.  Closed forms,
masks and counts: exact.

Within the port: the streamed service round is bitwise invariant to
``agent_blocks`` (a padded fleet's stale buffer included); full
participation is bitwise the plain round; a round nobody makes leaves theta
bitwise unchanged; the mask stream is right in distribution (5 standard
errors over 10^5 draws) and bitwise the same over any slicing of the agent
ids.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedpg as jax_fedpg
from repro.core import ota as jax_ota
from repro.core.channel import RayleighChannel as JaxRayleigh
from repro.rl import sampler as jax_sampler
from repro.rl.env import LandmarkNav as JaxLandmarkNav
from repro.rl.policy import MLPPolicy as JaxMLPPolicy
from repro.service import faults as jax_faults
from repro.service import participation as jax_part
from repro.service import staleness as jax_stale
from repro_torch import interop
from repro_torch.core import fedpg, ota
from repro_torch.core.channel import RayleighChannel
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy
from repro_torch.service import faults, participation, staleness, stream
from repro_torch.service.participation import ParticipationConfig
from repro_torch.service.staleness import StalenessConfig

CFG = fedpg.FedPGConfig(n_agents=3, batch_m=2, horizon=6, n_rounds=4,
                        alpha=0.05, gamma=0.99)
SIGMA = 1e-2
TOL = dict(rtol=1e-5, atol=1e-6)
STALE = (2, 0.5)


def _jax_ota():
    return jax_ota.OTAConfig(JaxRayleigh(), noise_sigma=SIGMA, debias=True)


def _port_ota():
    return ota.OTAConfig(RayleighChannel(), noise_sigma=SIGMA, debias=True)


def _jax_part(kind, debias):
    if kind == "subset":
        return jax_part.ParticipationConfig(kind="subset", subset=2,
                                            debias=debias)
    return jax_part.ParticipationConfig(rate=0.5, debias=debias)


def _port_part(kind, debias):
    if kind == "subset":
        return ParticipationConfig(kind="subset", subset=2, debias=debias)
    return ParticipationConfig(rate=0.5, debias=debias)


@functools.lru_cache(maxsize=None)
def _jax_service_chain(kind, debias, stale, noisy, seed=2):
    """theta_0 and every round's draws (and mask) of the JAX service run
    from ``jax.random.key(seed)``, replayed round by round as ``run``
    derives them, with the stacked round's metrics and final theta."""
    env, pol = JaxLandmarkNav(), JaxMLPPolicy()
    part = _jax_part(kind, debias)
    scfg = None if stale is None else jax_stale.StalenessConfig(*stale)
    ocfg = _jax_ota() if noisy else None
    key_init, key_scan, key_svc = jax.random.split(jax.random.key(seed), 3)
    theta = pol.init(key_init)
    theta0 = {k: np.asarray(v) for k, v in theta.items()}
    state = jax_part.init_state(theta, key_svc, CFG.n_agents, scfg)
    round_fn = jax.jit(jax_fedpg.make_round_fn(
        env, pol, CFG, ocfg, ota_backend="pallas", participation=part,
        staleness=scfg))
    rollouts = jax.jit(lambda th, keys: jax.vmap(
        lambda k: jax_sampler.rollout_batch(env, pol, th, k, CFG.horizon,
                                            CFG.batch_m))(keys))
    ids = jnp.arange(CFG.n_agents, dtype=jnp.int32)
    draws, metrics = [], []
    for r, key in enumerate(jax.random.split(key_scan, CFG.n_rounds)):
        key_samp, key_chan = jax.random.split(key)
        trajs = rollouts(state.theta,
                         jax.random.split(key_samp, CFG.n_agents))
        key_h, key_n = jax.random.split(key_chan)
        mask = jax_part.round_mask(part, state.part_key, state.sched_key,
                                   jnp.int32(r), ids, CFG.n_agents)
        draws.append(fedpg.RoundDraws(
            s0=torch.from_numpy(np.array(trajs.obs[:, :, 0])),
            actions=torch.from_numpy(np.array(trajs.actions, np.int64)),
            gains=torch.from_numpy(np.array(
                jax_ota.sample_gains(_jax_ota(), key_h, CFG.n_agents))),
            seed=int(jax.random.bits(key_n, (), jnp.uint32)),
            mask=torch.from_numpy(np.array(mask))))
        state, m = round_fn(state, key)
        metrics.append([float(x) for x in m])
    return (theta0, draws,
            {k: np.asarray(v) for k, v in state.theta.items()},
            np.array(metrics))


def _jax_run(kind, debias, stale, noisy, agent_blocks, seed=2):
    """The JAX history and theta: the replayed stacked rounds', or a
    streamed ``run``'s."""
    if agent_blocks is None:
        return _jax_service_chain(kind, debias, stale, noisy, seed)[2:]
    scfg = None if stale is None else jax_stale.StalenessConfig(*stale)
    theta, hist = jax_fedpg.run(
        JaxLandmarkNav(), JaxMLPPolicy(), CFG, jax.random.key(seed),
        ota=_jax_ota() if noisy else None, ota_backend="pallas",
        participation=_jax_part(kind, debias), staleness=scfg,
        agent_blocks=agent_blocks)
    return ({k: np.asarray(v) for k, v in theta.items()},
            np.stack([np.asarray(x) for x in hist[:3]], axis=1))


def _port_chain(kind, debias, stale, noisy, agent_blocks, inject_mask=True):
    theta0, draws = _jax_service_chain(kind, debias, stale, noisy)[:2]
    scfg = None if stale is None else StalenessConfig(*stale)
    round_fn = fedpg.make_round_fn(
        LandmarkNav(), MLPPolicy(), CFG, _port_ota() if noisy else None,
        agent_blocks=agent_blocks, participation=_port_part(kind, debias),
        staleness=scfg)
    state = participation.init_state(interop.from_numpy(theta0, "cpu"),
                                     torch.tensor(0), CFG.n_agents, scfg)
    got = []
    for d in draws:
        if not inject_mask:
            d = d._replace(mask=None)
        state, m = round_fn(state, None, d)
        got.append([x.item() for x in m])
    return state.theta, np.array(got), draws


@pytest.mark.parametrize("agent_blocks", [None, 2])
@pytest.mark.parametrize("stale", [None, STALE], ids=["fresh", "stale"])
def test_service_rounds_match_jax(agent_blocks, stale):
    """Bernoulli 0.5, realised debias, Algorithm 2: stacked and streamed."""
    theta_j, want = _jax_run("bernoulli", "realized", stale, True,
                             agent_blocks)
    theta, got, draws = _port_chain("bernoulli", "realized", stale, True,
                                    agent_blocks)
    np.testing.assert_allclose(got, want, **TOL)
    for k in theta_j:
        np.testing.assert_allclose(theta[k].numpy(), theta_j[k], **TOL)
    counts = [int(d.mask.sum()) for d in draws]
    assert 0 in counts and any(0 < c < CFG.n_agents for c in counts)


@pytest.mark.parametrize("noisy,agent_blocks", [(True, None), (False, 2)],
                         ids=["alg2-stacked", "alg1-streamed"])
def test_subset_service_matches_jax_with_its_own_mask(noisy, agent_blocks):
    """The round-robin subset is PRNG-free: the port draws its own mask,
    which must be JAX's; debias "expected" (the closed-form W)."""
    theta_j, want = _jax_run("subset", "expected", STALE, noisy,
                             agent_blocks)
    theta, got, _ = _port_chain("subset", "expected", STALE, noisy,
                                agent_blocks, inject_mask=False)
    np.testing.assert_allclose(got, want, **TOL)
    for k in theta_j:
        np.testing.assert_allclose(theta[k].numpy(), theta_j[k], **TOL)


@pytest.mark.parametrize("n_agents", [1, 3, 7, 10])
@pytest.mark.parametrize("subset", [1, 2, 3, 5])
def test_subset_mask_equals_jax(n_agents, subset):
    p = ParticipationConfig(kind="subset", subset=subset)
    pj = jax_part.ParticipationConfig(kind="subset", subset=subset)
    keys = jax.random.split(jax.random.key(0))
    for r in range(12):
        got = participation.round_mask(p, 0, r, torch.arange(n_agents),
                                       n_agents)
        want = jax_part.round_mask(pj, keys[0], keys[1], jnp.int32(r),
                                   jnp.arange(n_agents, dtype=jnp.int32),
                                   n_agents)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


FAULTS = [
    None,
    dict(stragglers=("exp", 1.0, 2.5), deadline=2.0),
    dict(stragglers=("pareto", 1.0, 2.5), deadline=0.5),
    dict(crashes=(0.3, 5, 2)),
    dict(stragglers=("exp", 2.0, 2.5), deadline=1.0, crashes=(1.0, 4, 1)),
    dict(stragglers=("exp", 1.0, 2.5)),               # deadline inf: inactive
]


def _faults(mod, spec):
    if spec is None:
        return None
    kw = {}
    if "stragglers" in spec:
        dist, mean, shape = spec["stragglers"]
        kw["stragglers"] = mod.StragglerModel(dist, mean, shape)
    if "deadline" in spec:
        kw["deadline"] = spec["deadline"]
    if "crashes" in spec:
        kw["crashes"] = mod.CrashSchedule(*spec["crashes"])
    return mod.FaultConfig(**kw)


@pytest.mark.parametrize("spec", FAULTS, ids=str)
@pytest.mark.parametrize("kind", ["bernoulli", "subset", "full"])
def test_closed_forms_equal_jax(spec, kind):
    f, fj = _faults(faults, spec), _faults(jax_faults, spec)
    p = ParticipationConfig(kind=kind, rate=0.3, subset=4, faults=f)
    pj = jax_part.ParticipationConfig(kind=kind, rate=0.3, subset=4,
                                      faults=fj)
    for n in (3, 10, 10_000):
        assert participation.expected_count(p, n) == \
            jax_part.expected_count(pj, n)
        assert (participation.normalize(p, n) is None) == \
            (jax_part.normalize(pj, n) is None)
    if f is not None:
        assert f.active == fj.active
        assert f.availability() == fj.availability()
        if f.stragglers is not None:
            for dl in (0.0, 0.5, 2.0, math.inf):
                assert f.stragglers.prob_within(dl) == \
                    fj.stragglers.prob_within(dl)
        if f.crashes is not None:
            assert f.crashes.up_prob() == fj.crashes.up_prob()


def test_normalisers_match_jax():
    """safe_inv, participation_factor, the staleness weights and stats, the
    buffer advance: exact, as both compute them in float32 elementwise
    (the power ``decay ** (age - 1)`` to 1 ulp)."""
    for w in (0.0, 1.0, 3.0, 2.75, 1e-3):
        assert participation.safe_inv(w).item() == \
            float(jax_part.safe_inv(w))
        assert participation.participation_factor(7, w).item() == \
            float(jax_part.participation_factor(7, w))
        assert ota._participation_rescale(7, w).item() == \
            float(jax_ota._participation_rescale(7, w))
    rng = np.random.default_rng(0)
    mask = rng.random(9) < 0.5
    age = np.array([1, 2, 3, 4, 2 ** 30, 1, 2, 5, 3], np.int32)
    scfg, scj = StalenessConfig(3, 0.8), jax_stale.StalenessConfig(3, 0.8)
    tm, ta = torch.from_numpy(mask), torch.from_numpy(age)
    np.testing.assert_allclose(
        staleness.replay_weights(scfg, tm, ta).numpy(),
        np.asarray(jax_stale.replay_weights(scj, mask, age)), rtol=2e-7)
    for a, b in zip(staleness.stats(scfg, tm, ta),
                    jax_stale.stats(scj, mask, age)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7)
    g = {"w": rng.standard_normal((9, 4)).astype(np.float32)}
    st = staleness.StaleState({"w": torch.zeros(9, 4)}, ta)
    stj = jax_stale.StaleState({"w": jnp.zeros((9, 4))}, jnp.asarray(age))
    got = staleness.advance(scfg, st, tm, {"w": torch.from_numpy(g["w"])})
    want = jax_stale.advance(scj, stj, jnp.asarray(mask),
                             {"w": jnp.asarray(g["w"])})
    np.testing.assert_array_equal(got.grads["w"].numpy(),
                                  np.asarray(want.grads["w"]))
    np.testing.assert_array_equal(got.age.numpy(), np.asarray(want.age))


@pytest.mark.parametrize("spec", FAULTS[:5], ids=str)
def test_mask_stream_in_distribution_and_slice_invariant(spec):
    """10^5 agents: the realised rate of each round within 5 standard
    errors of ``expected_count / N``, and any slicing of the agent ids gets
    exactly those rows of the fleet's mask."""
    n = 100_000
    p = ParticipationConfig(rate=0.5, faults=_faults(faults, spec))
    seed = torch.tensor(0xC0FFEE)
    ids = torch.arange(n)
    rate = participation.expected_count(p, n) / n
    for r in (0, 1, 7):
        mask = participation.round_mask(p, seed, r, ids, n)
        se = math.sqrt(rate * (1 - rate) / n)
        assert abs(mask.float().mean().item() - rate) <= 5 * se, (r, rate)
        for lo, hi in ((0, 1), (5, 17), (n - 3, n), (40_000, 60_000)):
            part = participation.round_mask(p, seed, r, ids[lo:hi], n)
            assert torch.equal(part, mask[lo:hi])
    # an int seed and a tensor seed are the same stream
    assert torch.equal(
        stream.agent_bits(0xC0FFEE, 3, ids[:100], stream.SALT_DELAY),
        stream.agent_bits(seed, 3, ids[:100], stream.SALT_DELAY))


def test_uniform_stream_moments():
    u = stream.agent_uniform(7, 2, torch.arange(100_000),
                             stream.SALT_BERNOULLI).double()
    se = math.sqrt(1 / 12 / 1e5)
    assert abs(u.mean().item() - 0.5) < 5 * se
    assert 0.0 <= u.min().item() and u.max().item() < 1.0


def _run(agent_blocks, ota_cfg, p, s=None, n_agents=5, seed=4, theta0=None):
    cfg = fedpg.FedPGConfig(n_agents=n_agents, batch_m=2, horizon=5,
                            n_rounds=3, alpha=0.05)
    return fedpg.run(LandmarkNav(), MLPPolicy(), cfg, seed, ota=ota_cfg,
                     agent_blocks=agent_blocks, participation=p, staleness=s,
                     theta0=theta0, device="cpu")


@pytest.mark.parametrize("noisy", [False, True], ids=["alg1", "alg2"])
@pytest.mark.parametrize("stale", [None, (3, 0.8)], ids=["fresh", "stale"])
def test_streamed_service_is_bitwise_invariant_to_agent_blocks(noisy, stale):
    """N=5, Bernoulli 0.5 with stragglers: blocks of 1 and 5 divide it, 2
    and 3 do not, 8 exceeds it."""
    p = ParticipationConfig(rate=0.5, faults=_faults(faults, FAULTS[1]))
    s = None if stale is None else StalenessConfig(*stale)
    o = _port_ota() if noisy else None
    theta_1, hist_1 = _run(1, o, p, s)
    for b in (2, 3, 5, 8):
        theta_b, hist_b = _run(b, o, p, s)
        for x, y in zip(hist_1, hist_b):
            assert torch.equal(x, y), b
        for k in theta_1:
            assert torch.equal(theta_1[k], theta_b[k]), b
    # the stacked service round: the same draws and masks, so the gain
    # means are bitwise equal and the rest agrees to summation order
    _, stacked = _run(None, o, p, s)
    assert torch.equal(stacked.gain_mean, hist_1.gain_mean)
    torch.testing.assert_close(stacked.rewards, hist_1.rewards, **TOL)
    torch.testing.assert_close(stacked.grad_sq, hist_1.grad_sq, **TOL)


@pytest.mark.parametrize("agent_blocks", [None, 2])
def test_full_participation_is_bitwise_off(agent_blocks):
    off = [ParticipationConfig(rate=1.0), ParticipationConfig(kind="full"),
           ParticipationConfig(kind="subset", subset=5),
           ParticipationConfig(kind="full", faults=_faults(faults, FAULTS[5]))]
    theta_0, plain = _run(agent_blocks, _port_ota(), None)
    for p in off:
        assert participation.normalize(p, 5) is None
        theta_p, hist = _run(agent_blocks, _port_ota(), p,
                             StalenessConfig(2, 0.5))
        for x, y in zip(plain, hist):
            assert torch.equal(x, y), p
        for k in theta_0:
            assert torch.equal(theta_0[k], theta_p[k]), p


@pytest.mark.parametrize("agent_blocks", [None, 2])
@pytest.mark.parametrize("debias", ["realized", "expected"])
def test_empty_rounds_commit_zero_update(agent_blocks, debias):
    """Everyone crashes every round: W == 0 (realised) or the closed form
    is 0 (expected), the AWGN is discarded and theta never moves."""
    p = ParticipationConfig(kind="full", debias=debias, faults=faults.FaultConfig(
        crashes=faults.CrashSchedule(frac=1.0, period=1, down=1)))
    theta0 = MLPPolicy().init(torch.Generator().manual_seed(1), "cpu")
    theta, hist = _run(agent_blocks, _port_ota(), p, theta0=theta0)
    for k in theta0:
        assert torch.equal(theta[k], theta0[k])
    assert torch.all(hist.grad_sq == 0.0) and torch.all(hist.gain_mean == 0.0)


def test_stale_buffer_absolute_index_padded_fleet():
    """N=7 in blocks of 4 (a short last block): the replay buffer stays on
    absolute agent ids, bitwise the unpadded block-1 run; replay changes the
    update against no staleness at equal masks."""
    p = ParticipationConfig(rate=0.3)
    s = StalenessConfig(max_age=3, decay=0.9)
    runs = [_run(b, _port_ota(), p, s, n_agents=7) for b in (1, 4)]
    for x, y in zip(runs[0][1], runs[1][1]):
        assert torch.equal(x, y)
    bare = _run(1, _port_ota(), p, None, n_agents=7)
    assert not torch.equal(runs[0][1].grad_sq, bare[1].grad_sq)


def test_stream_finalize_n_eff():
    """K1's server pass with the device rescale (through its plain version
    here) is bitwise the plain chain's ``n_eff`` epilogue; ``n_eff=None``
    keeps the bits of the plain scale; W = 0 gives a zero update; against
    JAX's pallas ``stream_finalize(n_eff=)`` to rtol 1e-6."""
    rng = np.random.default_rng(3)
    v = {"a": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal(5).astype(np.float32))}
    key = jax.random.key(5)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    for w in (2.0, 2.5, 0.0):
        w_t = torch.tensor(w)
        a = ota.stream_finalize(_port_ota(), seed, v, 7, backend="torch",
                                n_eff=w_t)
        b = ota.stream_finalize(_port_ota(), seed, v, 7, backend="cuda",
                                n_eff=w_t)
        want = jax_ota.stream_finalize(
            _jax_ota(), key, {k: jnp.asarray(x.numpy()) for k, x in v.items()},
            7, backend="pallas", n_eff=jnp.float32(w))
        for k in v:
            assert torch.equal(a[k], b[k])
            np.testing.assert_allclose(a[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
            if w == 0.0:
                assert torch.all(a[k] == 0.0)
    plain = ota.stream_finalize(_port_ota(), seed, v, 7, backend="cuda")
    ref = ota.stream_finalize(_port_ota(), seed, v, 7, backend="torch")
    for k in v:
        assert torch.equal(plain[k], ref[k])
