"""LandmarkNav, MLPPolicy and the sampler of the PyTorch port against the
JAX package, on the same numpy-made inputs (weights carried across by
``repro_torch.interop``).  rtol=1e-6, with atol=1e-6 for values near zero
(XLA's and PyTorch's CPU matmuls may sum the 4- and 16-term products in
another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.rl.env import LandmarkNav as JaxLandmarkNav
from repro.rl.policy import MLPPolicy as JaxMLPPolicy
from repro.rl import sampler as jax_sampler
from repro_torch import interop
from repro_torch.rl import sampler
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy

TOL = dict(rtol=1e-6, atol=1e-6)
SMALL = dict(n_agents=3, batch_m=2, horizon=6)


def _theta(seed=0):
    params = JaxMLPPolicy().init(jax.random.key(seed))
    return params, interop.from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, "cpu")


def test_interop_round_trip_keeps_jax_layout():
    jp, tp = _theta()
    assert tp["w1"].shape == (4, 16) and tp["w2"].shape == (16, 5)
    back = interop.to_numpy(tp)
    for k in jp:
        np.testing.assert_array_equal(back[k], np.asarray(jp[k]))


def test_env_step_and_loss_match_jax():
    rng = np.random.default_rng(0)
    states = rng.uniform(-1, 1, (64, 4)).astype(np.float32)
    actions = rng.integers(0, 5, 64)
    jenv, env = JaxLandmarkNav(), LandmarkNav()
    jn, jl = jax.vmap(lambda s, a: jenv.step(None, s, a))(
        jnp.asarray(states), jnp.asarray(actions))
    tn, tl = env.step(torch.from_numpy(states), torch.from_numpy(actions))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(
        env.loss(torch.from_numpy(states)).numpy(),
        np.asarray(jax.vmap(jenv.loss)(jnp.asarray(states))), **TOL)


def test_policy_logits_and_log_prob_match_jax():
    jp, tp = _theta(3)
    rng = np.random.default_rng(1)
    obs = rng.uniform(-2, 2, (50, 4)).astype(np.float32)
    act = rng.integers(0, 5, 50)
    jpol, pol = JaxMLPPolicy(), MLPPolicy()
    jlog = jax.vmap(lambda o: jpol.logits(jp, o))(jnp.asarray(obs))
    jlp = jax.vmap(lambda o, a: jpol.log_prob(jp, o, a))(
        jnp.asarray(obs), jnp.asarray(act))
    np.testing.assert_allclose(
        pol.logits(tp, torch.from_numpy(obs)).numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(
        pol.log_prob(tp, torch.from_numpy(obs), torch.from_numpy(act)).numpy(),
        np.asarray(jlp), **TOL)


def test_policy_init_follows_jax_distribution():
    params = MLPPolicy().init(torch.Generator().manual_seed(0), "cpu")
    ref = JaxMLPPolicy().init(jax.random.key(0))
    for k in ref:
        assert params[k].shape == ref[k].shape and params[k].dtype == \
            torch.float32
    assert not params["b1"].any() and not params["b2"].any()
    big = MLPPolicy(obs_dim=400, hidden=100).init(
        torch.Generator().manual_seed(1), "cpu")
    # N(0,1)/sqrt(fan_in): std 0.05 and 0.1; 40000 and 500 draws
    assert abs(big["w1"].std().item() - 0.05) < 5 * 0.05 / np.sqrt(2 * 40000)
    assert abs(big["w2"].std().item() - 0.1) < 5 * 0.1 / np.sqrt(2 * 500)


def test_sample_follows_softmax():
    _, tp = _theta(2)
    pol = MLPPolicy()
    n = 40_000
    obs = torch.tensor([0.3, -0.2, 0.5, 0.1]).expand(n, 4)
    a = pol.sample(tp, obs, torch.Generator().manual_seed(0))
    freq = torch.bincount(a, minlength=5).double() / n
    probs = torch.softmax(pol.logits(tp, obs[0]), -1).double()
    se = torch.sqrt(probs * (1 - probs) / n)
    assert torch.all(torch.abs(freq - probs) < 5 * se + 1e-12), (freq, probs)


def test_returns_match_jax():
    losses = np.random.default_rng(2).uniform(0, 3, (3, 2, 21)) \
        .astype(np.float32)
    tl = torch.from_numpy(losses)
    np.testing.assert_allclose(
        sampler.discounted_return(tl, 0.99).numpy(),
        np.asarray(jax_sampler.discounted_return(jnp.asarray(losses), 0.99)),
        rtol=1e-6)
    jtraj = jax_sampler.Trajectory(obs=None, actions=None,
                                   losses=jnp.asarray(losses))
    ttraj = sampler.Trajectory(obs=None, actions=None, losses=tl)
    np.testing.assert_allclose(
        sampler.empirical_reward(ttraj, 0.99).item(),
        float(jax_sampler.empirical_reward(jtraj, 0.99)), rtol=1e-6)


def jax_rollouts(params, seed, n_agents, batch_m, horizon):
    """The JAX round's rollouts: one key per agent, M trajectories each."""
    keys = jax.random.split(jax.random.key(seed), n_agents)
    return jax.vmap(lambda k: jax_sampler.rollout_batch(
        JaxLandmarkNav(), JaxMLPPolicy(), params, k, horizon, batch_m))(keys)


def replay(traj, theta, horizon):
    """The same rollouts through the port, with injected s0 and actions."""
    return sampler.rollout_batch(
        LandmarkNav(), MLPPolicy(), theta, None, horizon,
        traj.actions.shape[:2],
        s0=torch.from_numpy(np.array(traj.obs[:, :, 0])),
        actions=torch.from_numpy(np.array(traj.actions, np.int64)))


def test_rollout_replay_matches_jax():
    jp, tp = _theta(5)
    jt = jax_rollouts(jp, 7, **SMALL)
    tt = replay(jt, tp, SMALL["horizon"])
    assert tt.obs.shape == jt.obs.shape and tt.horizon == SMALL["horizon"]
    np.testing.assert_allclose(tt.obs.numpy(), np.asarray(jt.obs), **TOL)
    np.testing.assert_allclose(tt.losses.numpy(), np.asarray(jt.losses),
                               **TOL)
    np.testing.assert_array_equal(tt.actions.numpy(), np.asarray(jt.actions))


@pytest.mark.parametrize("batch", [(3, 2), (5,)])
def test_sampled_rollout_shapes(batch):
    _, tp = _theta(0)
    tr = sampler.rollout_batch(LandmarkNav(), MLPPolicy(), tp,
                               torch.Generator().manual_seed(0), 6, batch)
    assert tr.obs.shape == batch + (7, 4)
    assert tr.actions.shape == tr.losses.shape == batch + (7,)
    # obs is the pre-move state: the next obs is this one moved by the action
    nxt, loss = LandmarkNav().step(tr.obs[..., :-1, :], tr.actions[..., :-1])
    torch.testing.assert_close(nxt, tr.obs[..., 1:, :], rtol=0, atol=0)
    torch.testing.assert_close(loss, tr.losses[..., :-1], rtol=0, atol=0)
