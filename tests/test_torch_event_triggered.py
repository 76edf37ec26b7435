"""The event-triggered baseline of the PyTorch port against the JAX
package's ``repro.core.event_triggered.run``.

K=4 chained rounds at the golden suite's SMALL size (N=3, M=2, T=6), the
port fed each round's JAX draws (initial states, actions and, with
participation, the mask JAX's ``round_mask`` draws from the run's keys).
The JAX draws are replayed by a copy of the JAX round made of the JAX
package's own functions, and the port is then held to the JAX ``run``'s
history: ``uploads`` exactly (an integer count), rewards, grad_sq and theta
to rtol 1e-5, atol 1e-6, the chained-round tolerance of
``test_torch_fedpg.py``.  Within the port: bitwise invariance to
``agent_blocks``, full participation bitwise off.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import event_triggered as jax_et
from repro.core import fedpg as jax_fedpg
from repro.rl import sampler as jax_sampler
from repro.rl.env import LandmarkNav as JaxLandmarkNav
from repro.rl.policy import MLPPolicy as JaxMLPPolicy
from repro.service import participation as jax_part
from repro.utils.tree import tree_global_norm_sq, tree_sub
from repro_torch import interop
from repro_torch.core import event_triggered as et
from repro_torch.core import fedpg
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy
from repro_torch.service.participation import ParticipationConfig

CFG = fedpg.FedPGConfig(n_agents=3, batch_m=2, horizon=6, n_rounds=4,
                        alpha=0.05, gamma=0.99)
TOL = dict(rtol=1e-5, atol=1e-6)
TAU = 1.0   # uploads vary at SMALL size: 3, 3, 2, 2 without participation


@functools.lru_cache(maxsize=None)
def _jax_chain(with_part, seed=3):
    """theta_0 and each round's draws (and mask) of the JAX ET run."""
    env, pol = JaxLandmarkNav(), JaxMLPPolicy()
    key = jax.random.key(seed)
    part = jax_part.ParticipationConfig(rate=0.5) if with_part else None
    if with_part:
        key_init, key_scan, key_svc = jax.random.split(key, 3)
        part_key, sched_key = jax.random.split(key_svc)
    else:
        key_init, key_scan = jax.random.split(key)
    theta = pol.init(key_init)
    theta0 = {k: np.asarray(v) for k, v in theta.items()}
    stale = jax.tree.map(lambda p: jnp.zeros((CFG.n_agents,) + p.shape),
                         theta)

    @jax.jit
    def round_grads(th, key_k):
        keys = jax.random.split(key_k, CFG.n_agents)
        trajs = jax.vmap(lambda k: jax_sampler.rollout_batch(
            env, pol, th, k, CFG.horizon, CFG.batch_m))(keys)
        grads = jax.vmap(lambda tr: jax_fedpg._estimator_grad(CFG)(
            pol, th, tr, CFG.gamma))(trajs)
        return trajs, grads

    draws = []
    ids = jnp.arange(CFG.n_agents, dtype=jnp.int32)
    for r, key_k in enumerate(jax.random.split(key_scan, CFG.n_rounds)):
        trajs, grads = round_grads(theta, key_k)
        fire = jax.vmap(lambda gn, go: tree_global_norm_sq(tree_sub(gn, go))
                        >= TAU * tree_global_norm_sq(gn))(grads, stale)
        mask = None
        if with_part:
            mask = jax_part.round_mask(part, part_key, sched_key,
                                       jnp.int32(r), ids, CFG.n_agents)
            fire = jnp.logical_and(mask, fire)
        stale = jax.tree.map(lambda gn, go: jnp.where(
            fire.reshape((-1,) + (1,) * (gn.ndim - 1)), gn, go), grads, stale)
        update = jax.tree.map(lambda g: jnp.mean(g, 0), stale)
        theta = jax.tree.map(lambda p, u: p - CFG.alpha * u, theta, update)
        draws.append(fedpg.RoundDraws(
            s0=torch.from_numpy(np.array(trajs.obs[:, :, 0])),
            actions=torch.from_numpy(np.array(trajs.actions, np.int64)),
            mask=None if mask is None else torch.from_numpy(np.array(mask))))
    return theta0, draws


def _port(with_part, agent_blocks, inject=True):
    theta0, draws = _jax_chain(with_part)
    p = ParticipationConfig(rate=0.5) if with_part else None
    round_fn = et.make_round_fn(LandmarkNav(), MLPPolicy(), CFG,
                                et.ETConfig(TAU), agent_blocks=agent_blocks,
                                participation=p)
    theta = interop.from_numpy(theta0, "cpu")
    state = et.ETState(theta, {k: torch.zeros((CFG.n_agents,) + v.shape)
                               for k, v in theta.items()}, 0,
                       torch.tensor(0))
    got = []
    for d in draws:
        state, m = round_fn(state, None, d if inject else None)
        got.append([x.item() for x in m])
    return state.theta, np.array(got)


@pytest.mark.parametrize("with_part,agent_blocks",
                         [(False, None), (False, 2), (True, None), (True, 2)])
def test_et_matches_jax(with_part, agent_blocks):
    p = jax_part.ParticipationConfig(rate=0.5) if with_part else None
    theta_j, hist_j = jax_et.run(JaxLandmarkNav(), JaxMLPPolicy(), CFG,
                                 jax_et.ETConfig(TAU), jax.random.key(3),
                                 agent_blocks=agent_blocks, participation=p)
    theta, got = _port(with_part, agent_blocks)
    want = np.stack([np.asarray(x) for x in hist_j], axis=1)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])   # uploads
    np.testing.assert_allclose(got[:, :2], want[:, :2], **TOL)
    for k in theta_j:
        np.testing.assert_allclose(theta[k].numpy(), np.asarray(theta_j[k]),
                                   **TOL)
    # the threshold bites: some rounds upload fewer than the fleet
    assert want[:, 2].min() < CFG.n_agents


def _run(agent_blocks, p=None, tau=0.05, estimator="gpomdp", n_agents=5):
    cfg = fedpg.FedPGConfig(n_agents=n_agents, batch_m=2, horizon=5,
                            n_rounds=4, alpha=0.05, estimator=estimator)
    return et.run(LandmarkNav(), MLPPolicy(), cfg, et.ETConfig(tau), 1,
                  agent_blocks=agent_blocks, participation=p, device="cpu")


def test_et_history_is_bitwise_invariant_to_agent_blocks():
    p = ParticipationConfig(rate=0.5)
    ref = _run(None, p)
    for b in (1, 2, 3, 8):
        got = _run(b, p)
        for x, y in zip(ref[1], got[1]):
            assert torch.equal(x, y), b
        for k in ref[0]:
            assert torch.equal(ref[0][k], got[0][k]), b


def test_et_full_participation_is_bitwise_off_and_tau0_counts():
    plain = _run(2)
    full = _run(2, ParticipationConfig(kind="full"))
    for x, y in zip(plain[1], full[1]):
        assert torch.equal(x, y)
    # tau = 0: every participant triggers, so uploads == participants
    _, hist = _run(None, ParticipationConfig(rate=0.5), tau=0.0)
    _, all_in = _run(None, None, tau=0.0)
    assert torch.all(all_in.uploads == 5.0)
    assert torch.all(hist.uploads <= 5.0) and hist.uploads.min() < 5.0


def test_et_estimator_and_upload_bounds():
    _, g = _run(None, estimator="gpomdp")
    _, r = _run(None, estimator="reinforce")
    assert not torch.equal(g.grad_sq, r.grad_sq)
    assert torch.all((g.uploads >= 0) & (g.uploads <= 5))
    assert g.uploads[0] == 5.0          # round 0: every copy is stale zero
    with pytest.raises(ValueError, match="estimator"):
        _run(None, estimator="nope")
