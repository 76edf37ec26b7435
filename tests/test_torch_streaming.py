"""The agent-streamed round (``agent_blocks``) of the PyTorch port: against
the JAX package's streamed round, and within the port against itself and
its stacked round.

Against JAX: K=4 chained rounds of Algorithm 2 at the golden suite's SMALL
size (N=3, M=2, T=6), the port fed each round's JAX draws (initial states,
actions, gains, kernel seed), against ``repro.core.fedpg.run(...,
ota_backend="pallas", agent_blocks=b)`` for b in {1, 2, N}; rtol=1e-5,
atol=1e-6, the tolerance of the stacked round's parity test
(``test_torch_fedpg.py``): per-round differences of summation order compound
over the chain.

Within the port: bitwise, since the streamed round is built so that no bit
depends on the block size.
"""
import functools

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
from repro_torch import interop
from repro_torch.core import fedpg, ota
from repro_torch.core.channel import RayleighChannel
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy

CFG = fedpg.FedPGConfig(n_agents=3, batch_m=2, horizon=6, n_rounds=4,
                        alpha=0.05, gamma=0.99)
SIGMA = 1e-2
TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_ota():
    return jax_ota.OTAConfig(JaxRayleigh(), noise_sigma=SIGMA, debias=True)


def _port_ota():
    return ota.OTAConfig(RayleighChannel(), noise_sigma=SIGMA, debias=True)


@functools.lru_cache(maxsize=1)
def _jax_chain(seed=2):
    """theta_0 and every round's draws of the JAX streamed run from
    ``jax.random.key(seed)``, replayed round by round as ``run`` derives
    them."""
    env, pol = JaxLandmarkNav(), JaxMLPPolicy()
    key_init, key_scan = jax.random.split(jax.random.key(seed))
    theta = pol.init(key_init)
    theta0 = {k: np.asarray(v) for k, v in theta.items()}
    round_fn = jax.jit(jax_fedpg.make_round_fn(
        env, pol, CFG, _jax_ota(), ota_backend="pallas", agent_blocks=1))
    rollouts = jax.jit(lambda th, keys: jax.vmap(
        lambda k: jax_sampler.rollout_batch(env, pol, th, k, CFG.horizon,
                                            CFG.batch_m))(keys))
    draws = []
    for key in jax.random.split(key_scan, CFG.n_rounds):
        key_samp, key_chan = jax.random.split(key)
        trajs = rollouts(theta, jax.random.split(key_samp, CFG.n_agents))
        key_h, key_n = jax.random.split(key_chan)
        draws.append(fedpg.RoundDraws(
            s0=torch.from_numpy(np.array(trajs.obs[:, :, 0])),
            actions=torch.from_numpy(np.array(trajs.actions, np.int64)),
            gains=torch.from_numpy(np.array(
                jax_ota.sample_gains(_jax_ota(), key_h, CFG.n_agents))),
            seed=int(jax.random.bits(key_n, (), jnp.uint32))))
        theta, _ = round_fn(theta, key)
    return theta0, draws


@pytest.mark.parametrize("agent_blocks", [1, 2, CFG.n_agents])
def test_streamed_rounds_match_jax(agent_blocks):
    theta0, draws = _jax_chain()
    theta_j, hist_j = jax_fedpg.run(
        JaxLandmarkNav(), JaxMLPPolicy(), CFG, jax.random.key(2),
        ota=_jax_ota(), ota_backend="pallas", agent_blocks=agent_blocks)
    round_fn = fedpg.make_round_fn(LandmarkNav(), MLPPolicy(), CFG,
                                   _port_ota(), agent_blocks=agent_blocks)
    theta = interop.from_numpy(theta0, "cpu")
    got = []
    for d in draws:
        theta, m = round_fn(theta, None, d)
        got.append([x.item() for x in m])
    want = np.stack([np.asarray(x) for x in hist_j[:3]], axis=1)
    np.testing.assert_allclose(np.array(got), want, **TOL)
    for k in theta_j:
        np.testing.assert_allclose(theta[k].numpy(), np.asarray(theta_j[k]),
                                   **TOL)
    assert not np.allclose(want[:, 2], 1.0)   # real, non-unit gains


def _run(agent_blocks, ota_cfg=None, n_agents=5, backend="auto", seed=4):
    cfg = fedpg.FedPGConfig(n_agents=n_agents, batch_m=2, horizon=5,
                            n_rounds=3, alpha=0.05)
    return fedpg.run(LandmarkNav(), MLPPolicy(), cfg, seed, ota=ota_cfg,
                     ota_backend=backend, agent_blocks=agent_blocks,
                     device="cpu")


@pytest.mark.parametrize("algorithm", [1, 2])
def test_history_is_bitwise_invariant_to_agent_blocks(algorithm):
    """N=5: blocks of 1 and 5 divide it, 2 and 3 do not (3 is also the cap
    ceil(N/2)), 8 exceeds it."""
    ota_cfg = _port_ota() if algorithm == 2 else None
    theta_1, hist_1 = _run(1, ota_cfg, backend="torch")
    for b in (2, 3, 5, 8):
        theta_b, hist_b = _run(b, ota_cfg, backend="torch")
        for x, y in zip(hist_1, hist_b):
            assert torch.equal(x, y), b
        for k in theta_1:
            assert torch.equal(theta_1[k], theta_b[k]), b


def test_streamed_round_draws_the_stacked_rounds_draws():
    """Same generator, same draws: the gain means are bitwise the stacked
    run's, and the rest agrees to summation order over the chain."""
    o = _port_ota()
    _, stacked = _run(None, o)
    _, streamed = _run(2, o)
    assert torch.equal(stacked.gain_mean, streamed.gain_mean)
    torch.testing.assert_close(streamed.rewards, stacked.rewards, **TOL)
    torch.testing.assert_close(streamed.grad_sq, stacked.grad_sq, **TOL)


def test_blocked_layout_matches_jax():
    for n_agents in range(1, 51):
        for b in range(1, 61):
            assert ota.blocked_layout(n_agents, b) == \
                jax_ota.blocked_layout(n_agents, b), (n_agents, b)
    with pytest.raises(ValueError):
        ota.blocked_layout(5, 0)


def _stack(seed, n=7):
    rng = np.random.default_rng(seed)
    g = {"a": rng.standard_normal((n, 3, 4)).astype(np.float32),
         "b": rng.standard_normal((n, 5)).astype(np.float32)}
    h = (np.abs(rng.standard_normal(n)) + 0.2).astype(np.float32)
    return g, h


def test_padding_helpers_match_jax():
    g, _ = _stack(0)
    n_blocks, block, pad = ota.blocked_layout(7, 3)
    got = ota.block_view(ota.pad_agent_axis(
        {k: torch.from_numpy(v) for k, v in g.items()}, pad), n_blocks, block)
    want = jax_ota.block_view(jax_ota.pad_agent_axis(
        {k: jnp.asarray(v) for k, v in g.items()}, pad), n_blocks, block)
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(
        ota.block_valid_mask(7, n_blocks, block).numpy(),
        np.asarray(jax_ota.block_valid_mask(7, n_blocks, block)))


@pytest.mark.parametrize("agent_blocks", [1, 3, 7])
def test_streamed_aggregate_matches_jax(agent_blocks):
    """``aggregate``/``aggregate_apply`` with ``agent_blocks`` against the
    JAX package's pallas streamed forms (same gains, same counter noise)."""
    g, h = _stack(1)
    key = jax.random.key(3)
    seed = int(jax.random.bits(jax.random.split(key)[1], (), jnp.uint32))
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    params = {k: v[0] * 0.5 for k, v in g.items()}
    u, _ = ota.aggregate(tg, _port_ota(), gains=torch.from_numpy(h),
                         seed=seed, agent_blocks=agent_blocks)
    uj, _ = jax_ota.aggregate(jg, _jax_ota(), key=key, gains=jnp.asarray(h),
                              backend="pallas", agent_blocks=agent_blocks)
    p2, _ = ota.aggregate_apply(
        tg, _port_ota(), {k: torch.from_numpy(v) for k, v in params.items()},
        alpha=0.1, gains=torch.from_numpy(h), seed=seed,
        agent_blocks=agent_blocks)
    p2j, _ = jax_ota.aggregate_apply(
        jg, _jax_ota(), {k: jnp.asarray(v) for k, v in params.items()},
        key=key, alpha=0.1, gains=jnp.asarray(h), backend="pallas",
        agent_blocks=agent_blocks)
    e = ota.aggregate(tg, None, agent_blocks=agent_blocks)[0]
    ej = jax_ota.aggregate(jg, None, agent_blocks=agent_blocks)[0]
    for k in g:
        for x, y in ((u, uj), (p2, p2j), (e, ej)):
            np.testing.assert_allclose(x[k].numpy(), np.asarray(y[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("wire", [None, torch.bfloat16])
@pytest.mark.parametrize("gains", [True, False])
def test_kernel_fold_is_the_per_agent_fold(gains, wire):
    """The ``cuda`` fold — one K1 ``agg`` over ``[acc; g_block]`` with gains
    ``[1; h_block]``, run here through K1's plain version — is bitwise the
    per-agent fold, with phantom rows masked by zero gains."""
    g, h = _stack(2)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    th = torch.from_numpy(h) if gains else None
    acc = {k: torch.from_numpy(v[0] * 3.0) for k, v in g.items()}
    valid = torch.tensor([True] * 5 + [False] * 2)
    a = ota.stream_fold_block(acc, tg, th, valid, wire_dtype=wire,
                              backend="torch")
    b = ota.stream_fold_block(acc, tg, th, valid, wire_dtype=wire,
                              backend="cuda")
    short = ota.stream_fold_block(acc, {k: v[:5] for k, v in tg.items()},
                                  None if th is None else th[:5],
                                  wire_dtype=wire, backend="torch")
    for k in g:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], short[k])
