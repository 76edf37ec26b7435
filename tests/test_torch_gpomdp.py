"""G(PO)MDP and REINFORCE in the PyTorch port against the JAX package, on
the JAX package's own trajectories (N=3 agents x M=2 rollouts, T=6).
rtol=1e-5, atol=1e-6: both sides sum N*M*(T+1) log-prob gradients in their
own order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gpomdp as jax_gpomdp
from repro.rl.policy import MLPPolicy as JaxMLPPolicy
from repro_torch.core import gpomdp
from repro_torch.rl.policy import MLPPolicy
from test_torch_rl import SMALL, _theta, jax_rollouts, replay

GAMMA = 0.99


def test_discounted_to_go_uses_absolute_discount():
    losses = np.random.default_rng(0).uniform(0, 2, (4, 9)).astype(np.float32)
    got = gpomdp.discounted_to_go(torch.from_numpy(losses), GAMMA).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_gpomdp.discounted_to_go(jnp.asarray(losses),
                                                    GAMMA)), rtol=1e-6)
    t = np.arange(9)
    want = np.array([[np.sum(GAMMA ** t[tau:] * row[tau:]) for tau in range(9)]
                     for row in losses.astype(np.float64)])
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("estimator", ["gpomdp", "reinforce"])
def test_per_agent_gradients_match_jax(estimator):
    jp, tp = _theta(11)
    jt = jax_rollouts(jp, 13, **SMALL)
    jfn = {"gpomdp": jax_gpomdp.gpomdp_gradient,
           "reinforce": jax_gpomdp.reinforce_gradient}[estimator]
    jg = jax.vmap(lambda tr: jfn(JaxMLPPolicy(), jp, tr, GAMMA))(jt)
    tg = gpomdp.per_agent_gradients(MLPPolicy(), tp,
                                    replay(jt, tp, SMALL["horizon"]), GAMMA,
                                    estimator)
    assert sorted(tg) == sorted(jg)
    for k in jg:
        assert tg[k].shape == (SMALL["n_agents"],) + jp[k].shape
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6)


def test_single_agent_gradient_matches_stack_row():
    jp, tp = _theta(1)
    tt = replay(jax_rollouts(jp, 2, **SMALL), tp, SMALL["horizon"])
    stack = gpomdp.per_agent_gradients(MLPPolicy(), tp, tt, GAMMA)
    one = gpomdp.gpomdp_gradient(MLPPolicy(), tp,
                                 type(tt)(*(x[1] for x in tt)), GAMMA)
    for k in one:
        torch.testing.assert_close(one[k], stack[k][1], rtol=1e-6, atol=1e-7)


def test_unknown_estimator_raises():
    _, tp = _theta(0)
    jt = jax_rollouts(_theta(0)[0], 0, **SMALL)
    with pytest.raises(ValueError):
        gpomdp.per_agent_gradients(MLPPolicy(), tp, replay(jt, tp, 6), GAMMA,
                                   "ppo")
