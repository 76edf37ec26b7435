"""Algorithm 1 and Algorithm 2 of the PyTorch port against the JAX package,
K=4 chained rounds at the golden suite's SMALL size (N=3, M=2, T=6).

The JAX round is built from its parts — ``rollout_batch`` per agent key,
``gpomdp_gradient``, then ``aggregate_apply(..., backend="pallas",
gains=h)`` with the fused kernel in interpret mode.  Both chains start from
the same theta_0 (carried across by ``interop``); every round the port is fed
the JAX round's initial states, actions, gains and kernel seed.
rtol=1e-5, atol=1e-6: the small per-round differences of summation order
compound over the chain.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gpomdp as jax_gpomdp
from repro.core import ota as jax_ota
from repro.core.channel import RayleighChannel as JaxRayleigh
from repro.rl import sampler as jax_sampler
from repro.rl.env import LandmarkNav as JaxLandmarkNav
from repro.rl.policy import MLPPolicy as JaxMLPPolicy
from repro.utils.tree import tree_global_norm_sq
from repro_torch import interop
from repro_torch.core import fedpg
from repro_torch.core.channel import RayleighChannel
from repro_torch.core.ota import OTAConfig
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy

CFG = fedpg.FedPGConfig(n_agents=3, batch_m=2, horizon=6, n_rounds=4,
                        alpha=0.05, gamma=0.99)
TOL = dict(rtol=1e-5, atol=1e-6)


@functools.partial(jax.jit, static_argnames="noisy")
def _jax_round(theta, key, h, noisy):
    env, pol = JaxLandmarkNav(), JaxMLPPolicy()
    key_samp, key_chan = jax.random.split(key)
    agent_keys = jax.random.split(key_samp, CFG.n_agents)
    trajs = jax.vmap(lambda k: jax_sampler.rollout_batch(
        env, pol, theta, k, CFG.horizon, CFG.batch_m))(agent_keys)
    grads = jax.vmap(lambda tr: jax_gpomdp.gpomdp_gradient(
        pol, theta, tr, CFG.gamma))(trajs)
    mean_grad = jax_ota.aggregate(grads, None)[0]
    if noisy:
        ota_cfg = jax_ota.OTAConfig(JaxRayleigh(), noise_sigma=1e-2,
                                    debias=True)
        theta_next, hh = jax_ota.aggregate_apply(
            grads, ota_cfg, theta, key=key_chan, alpha=CFG.alpha,
            backend="pallas", gains=h)
        gain_mean = jnp.mean(hh)
    else:
        theta_next = jax.tree.map(lambda p, u: p - CFG.alpha * u, theta,
                                  mean_grad)
        gain_mean = jnp.ones(())
    seed = jax.random.bits(jax.random.split(key_chan)[1], (), jnp.uint32)
    metrics = (jax_sampler.empirical_reward(trajs, CFG.gamma),
               tree_global_norm_sq(mean_grad), gain_mean)
    return theta_next, metrics, trajs, seed


@pytest.mark.parametrize("algorithm", [1, 2])
def test_chained_rounds_match_jax(algorithm):
    noisy = algorithm == 2
    theta_j = JaxMLPPolicy().init(jax.random.key(0))
    theta_t = interop.from_numpy({k: np.asarray(v) for k, v in
                                  theta_j.items()}, "cpu")
    ota_cfg = OTAConfig(RayleighChannel(), noise_sigma=1e-2,
                        debias=True) if noisy else None
    round_fn = fedpg.make_round_fn(LandmarkNav(), MLPPolicy(), CFG, ota_cfg)
    rng = np.random.default_rng(1)
    keys = jax.random.split(jax.random.key(2), CFG.n_rounds)
    got, want = [], []
    for k in range(CFG.n_rounds):
        h = (np.abs(rng.standard_normal(CFG.n_agents)) + 0.2).astype(np.float32)
        theta_j, m_j, trajs, seed = _jax_round(theta_j, keys[k],
                                               jnp.asarray(h), noisy)
        draws = fedpg.RoundDraws(
            s0=torch.from_numpy(np.array(trajs.obs[:, :, 0])),
            actions=torch.from_numpy(np.array(trajs.actions, np.int64)),
            gains=torch.from_numpy(h) if noisy else None,
            seed=int(seed) if noisy else None)
        theta_t, m_t = round_fn(theta_t, None, draws)
        got.append([x.item() for x in m_t])
        want.append([float(x) for x in m_j])
    np.testing.assert_allclose(np.array(got), np.array(want), **TOL)
    for name in theta_j:
        np.testing.assert_allclose(theta_t[name].numpy(),
                                   np.asarray(theta_j[name]), **TOL)
    if noisy:  # the chain really moved through noisy, non-unit gains
        assert not np.allclose(np.array(got)[:, 2], 1.0)


def _env_pol():
    return LandmarkNav(), MLPPolicy()


def test_run_is_deterministic_and_finite():
    cfg = fedpg.FedPGConfig(n_agents=3, batch_m=2, horizon=6, n_rounds=3,
                            alpha=1e-3)
    ota_cfg = OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True)
    a_theta, a = fedpg.run(*_env_pol(), cfg, 4, ota=ota_cfg, device="cpu")
    b_theta, b = fedpg.run(*_env_pol(), cfg, 4, ota=ota_cfg, device="cpu",
                           ota_backend="torch")
    for x, y in zip(a, b):
        assert x.shape == (3,) and torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for k in a_theta:
        torch.testing.assert_close(a_theta[k], b_theta[k], rtol=0, atol=0)
    _, c = fedpg.run(*_env_pol(), cfg, 5, ota=ota_cfg, device="cpu")
    assert not torch.equal(a.rewards, c.rewards)


def test_algorithm1_has_unit_gains_and_theta0_is_used():
    cfg = fedpg.FedPGConfig(n_agents=2, batch_m=2, horizon=4, n_rounds=2)
    theta0 = MLPPolicy().init(torch.Generator().manual_seed(3), "cpu")
    theta, hist = fedpg.run(*_env_pol(), cfg, 0, theta0=theta0, device="cpu")
    assert torch.equal(hist.gain_mean, torch.ones(2))
    assert sorted(theta) == sorted(theta0)
    assert not torch.equal(theta["w1"], theta0["w1"])


def test_monte_carlo_stacks_independent_runs():
    cfg = fedpg.FedPGConfig(n_agents=2, batch_m=2, horizon=4, n_rounds=3)
    hist = fedpg.monte_carlo(*_env_pol(), cfg, 0, 3, device="cpu")
    assert hist.rewards.shape == hist.grad_sq.shape == (3, 3)
    assert fedpg.avg_grad_sq(hist).shape == (3,)
    torch.testing.assert_close(fedpg.avg_grad_sq(hist),
                               hist.grad_sq.mean(-1))
    assert len(set(fedpg.run_seeds(0, 20))) == 20
    assert not torch.equal(hist.rewards[0], hist.rewards[1])


def test_unknown_estimator_raises():
    cfg = fedpg.FedPGConfig(estimator="ppo")
    with pytest.raises(ValueError):
        fedpg.make_round_fn(*_env_pol(), cfg, None)
