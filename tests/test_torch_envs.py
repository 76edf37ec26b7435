"""The port's environment zoo and policies against the JAX package.

Each environment's ``reset``/``step``/``loss`` and each policy's
``log_prob``/``sample`` are fed the JAX package's own draws (``jax.random``
uniforms, normals and Gumbels of the same keys) and must give the JAX
values: float32 states and losses to rtol 1e-6 (atol 1e-6), integer states
and actions exactly.  ``TabularMDP.exact_J`` and its autograd gradient match
``jax.grad`` to 1e-5.  Whole runs: K=4 chained Algorithm-2 rounds at the
golden suite's SMALL size (N=3, M=2, T=6) on the heterogeneous windy
fleet, LQR (continuous actions), a Garnet MDP and the cliff walk, the port
fed each round's JAX draws (initial states, actions, the environment's step
draws, gains, kernel seed), rtol 1e-5, atol 1e-6 as ``test_torch_fedpg.py``;
the streamed hetero round also bitwise its own across block sizes.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedpg as jax_fedpg
from repro.core import ota as jax_ota
from repro.core.channel import RayleighChannel as JaxRayleigh
from repro.rl import env as jax_env
from repro.rl import envs as jax_envs
from repro.rl import policy as jax_policy
from repro.rl import sampler as jax_sampler
from repro_torch import interop
from repro_torch.core import fedpg, gpomdp, ota
from repro_torch.core.channel import RayleighChannel
from repro_torch.rl import envs
from repro_torch.rl.env import LandmarkNav, TabularMDP
from repro_torch.rl.policy import GaussianPolicy, TabularSoftmaxPolicy

# alpha 1e-3: LQR's quadratic loss diverges (in JAX too) at the 0.05 the
# landmark parity tests use
CFG = fedpg.FedPGConfig(n_agents=3, batch_m=2, horizon=6, n_rounds=4,
                        alpha=1e-3, gamma=0.99)
TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
B = 64   # batch of single steps


def _garnet_jax():
    return jax_envs.garnet(jax.random.key(0), 4, 2, branching=2)


def _zoo():
    """(name, JAX env) for every family, as the golden suite builds them."""
    return [
        ("landmark", jax_env.LandmarkNav()),
        ("windy", jax_envs.WindyLandmarkNav(wind=0.05)),
        ("multilandmark", jax_envs.MultiLandmarkNav(n_landmarks=3)),
        ("cliffwalk", jax_envs.CliffWalk(width=4, height=3, slip=0.3)),
        ("lqr", jax_envs.LQRTask(process_sigma=0.1)),
        ("tabular", _garnet_jax()),
        ("hetero", jax_envs.make_heterogeneous_env(
            [jax_envs.WindyLandmarkNav(wind=w) for w in (0.0, 0.1, 0.2)])),
    ]


def _jax_step_noise(env, key):
    """The draw ``env.step(key, ...)`` makes, in the port's layout."""
    if isinstance(env, jax_envs.WindyLandmarkNav):
        return jax.random.normal(key, (2,), jnp.float32)
    if isinstance(env, jax_envs.LQRTask):
        return jax.random.normal(key, (env.dim,), jnp.float32)
    if isinstance(env, jax_envs.CliffWalk):
        k_slip, k_act = jax.random.split(key)
        return jnp.stack([
            jax.random.uniform(k_slip, (), jnp.float32),
            jax.random.randint(k_act, (), 0, env.n_actions).astype(
                jnp.float32)])
    if isinstance(env, jax_env.TabularMDP):
        return jax.random.gumbel(key, (env.n_states,), jnp.float32)
    return None


def _jax_reset_noise(env, key):
    if isinstance(env, (jax_env.LandmarkNav, jax_envs.MultiLandmarkNav)):
        return jax.random.uniform(key, (env.obs_dim,), jnp.float32)
    if isinstance(env, jax_envs.LQRTask):
        return jax.random.normal(key, (env.dim,), jnp.float32)
    if isinstance(env, jax_env.TabularMDP):
        return jax.random.gumbel(key, (env.n_states,), jnp.float32)
    return None


def _t(x):
    return torch.from_numpy(np.array(x))


def _action_batch(env, rng):
    if isinstance(env, jax_envs.LQRTask):
        return rng.standard_normal((B, env.dim)).astype(np.float32)
    return rng.integers(0, env.n_actions, B)


@pytest.mark.parametrize("name,jenv", [z for z in _zoo() if z[0] != "hetero"],
                         ids=lambda x: x if isinstance(x, str) else "")
def test_reset_step_loss_match_jax(name, jenv):
    env = interop.env_from_jax(jenv, "cpu")
    keys = jax.random.split(jax.random.key(7), B)
    # reset from the JAX draws
    s_j = jax.vmap(jenv.reset)(keys)
    noise = _jax_reset_noise(jenv, keys[0])
    s_t = env.reset(None, (B,), "cpu", noise=None if noise is None else _t(
        jax.vmap(lambda k: _jax_reset_noise(jenv, k))(keys)))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **STEP_TOL)
    # several steps from the JAX draws
    rng = np.random.default_rng(0)
    state_j, state_t = s_j, s_t
    for t in range(4):
        a = _action_batch(jenv, rng)
        step_keys = jax.random.split(jax.random.key(100 + t), B)
        nxt_j, loss_j = jax.vmap(jenv.step)(step_keys, state_j,
                                            jnp.asarray(a))
        noise = None
        if _jax_step_noise(jenv, step_keys[0]) is not None:
            noise = _t(jax.vmap(lambda k: _jax_step_noise(jenv, k))(
                step_keys))
        nxt_t, loss_t = env.step(state_t, torch.from_numpy(np.array(a)),
                                 noise)
        np.testing.assert_allclose(nxt_t.numpy(), np.asarray(nxt_j),
                                   **STEP_TOL)
        np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                                   **STEP_TOL)
        state_j, state_t = nxt_j, nxt_t
    if hasattr(jenv, "loss"):
        np.testing.assert_allclose(env.loss(state_t).numpy(),
                                   np.asarray(jax.vmap(jenv.loss)(state_j)),
                                   **STEP_TOL)


def test_cliffwalk_slip_and_goal_semantics():
    """Exact cell arithmetic: the cliff sends the agent back at cost
    ``cliff_cost``; the goal absorbs at cost 0; a slip draw replaces the
    action."""
    env = envs.CliffWalk(width=4, height=3, slip=0.5)
    oh = lambda s: torch.nn.functional.one_hot(torch.tensor(s), 12).float()
    keep = torch.tensor([0.9, 0.0])            # no slip
    nxt, loss = env.step(oh([0]), torch.tensor([3]), keep[None])  # right
    assert int(nxt.argmax()) == 0 and loss.item() == 1.0          # cliff
    nxt, loss = env.step(oh([3]), torch.tensor([0]), keep[None])  # goal
    assert int(nxt.argmax()) == 3 and loss.item() == 0.0
    slip = torch.tensor([[0.1, 0.0]])                              # -> up
    nxt, loss = env.step(oh([0]), torch.tensor([3]), slip)
    assert int(nxt.argmax()) == 4 and loss.item() == pytest.approx(0.1)


def test_tabular_policy_matches_jax():
    jp, pol = jax_policy.TabularSoftmaxPolicy(5, 3), TabularSoftmaxPolicy(5, 3)
    params_j = jp.init(jax.random.key(0))
    params = interop.from_numpy({k: np.asarray(v)
                                 for k, v in params_j.items()}, "cpu")
    keys = jax.random.split(jax.random.key(1), B)
    obs = jax.nn.one_hot(jnp.arange(B) % 5, 5)
    acts = jax.vmap(lambda k, o: jp.sample(params_j, k, o))(keys, obs)
    # the uniforms jax.random.gumbel (inside categorical) transforms
    u = jax.vmap(lambda k: jax.random.uniform(
        k, (3,), jnp.float32, minval=jnp.finfo(jnp.float32).tiny,
        maxval=1.0))(keys)
    got = pol.sample(params, _t(obs), None, noise=_t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(acts))
    np.testing.assert_allclose(
        pol.log_prob(params, _t(obs), got).numpy(),
        np.asarray(jax.vmap(lambda o, a: jp.log_prob(params_j, o, a))(
            obs, acts)), **STEP_TOL)
    np.testing.assert_allclose(pol.action_probs(params).numpy(),
                               np.asarray(jp.action_probs(params_j)),
                               **STEP_TOL)


def test_gaussian_policy_matches_jax():
    jp, pol = jax_policy.GaussianPolicy(3, 2), GaussianPolicy(3, 2)
    params_j = jp.init(jax.random.key(0))
    params_j["log_std"] = jnp.asarray([0.3, -0.2], jnp.float32)
    params = interop.from_numpy({k: np.asarray(v)
                                 for k, v in params_j.items()}, "cpu")
    keys = jax.random.split(jax.random.key(1), B)
    obs = jax.random.normal(jax.random.key(2), (B, 3))
    acts = jax.vmap(lambda k, o: jp.sample(params_j, k, o))(keys, obs)
    eps = jax.vmap(lambda k: jax.random.normal(k, (2,), jnp.float32))(keys)
    got = pol.sample(params, _t(obs), None, noise=_t(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(acts), **STEP_TOL)
    np.testing.assert_allclose(
        pol.log_prob(params, _t(obs), got).numpy(),
        np.asarray(jax.vmap(lambda o, a: jp.log_prob(params_j, o, a))(
            obs, acts)), **STEP_TOL)
    # the per-step gradient the estimator takes (vmap of grad of one row)
    g = gpomdp.log_prob_grads(pol, params, _t(obs), got)
    gj = jax.vmap(jax.grad(jp.log_prob), in_axes=(None, 0, 0))(
        params_j, obs, acts)
    flat = np.concatenate([np.asarray(gj[k]).reshape(B, -1)
                           for k in sorted(gj)], axis=1)
    np.testing.assert_allclose(g.numpy(), flat, rtol=1e-5, atol=1e-6)


def test_exact_J_and_its_gradient_match_jax():
    jm = _garnet_jax()
    m = interop.env_from_jax(jm, "cpu")
    jp = jax_policy.TabularSoftmaxPolicy(jm.n_states, jm.n_actions)
    params_j = jp.init(jax.random.key(3))
    theta = torch.from_numpy(np.array(params_j["theta"])).requires_grad_()
    pol = m.default_policy()
    J = m.exact_J(pol.action_probs({"theta": theta}))
    (g,) = torch.autograd.grad(J, theta)
    Jj = jm.exact_J(jp.action_probs(params_j))
    gj = jax.grad(lambda p: jm.exact_J(jp.action_probs(p)))(params_j)
    np.testing.assert_allclose(J.item(), float(Jj), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj["theta"]),
                               rtol=1e-5, atol=1e-6)
    dense = TabularMDP.random(torch.Generator().manual_seed(0))
    assert torch.isfinite(dense.exact_J(torch.full((4, 3), 1 / 3)))


def test_gpomdp_is_unbiased_on_garnet():
    """The port's own Garnet draw: the G(PO)MDP mean over 60 estimates of
    200 trajectories each within 5 standard errors of the exact gradient,
    component by component."""
    m = envs.garnet(torch.Generator().manual_seed(0), n_states=4,
                    n_actions=2, branching=2, gamma=0.9, horizon=3)
    P = m.P
    assert torch.allclose(P.sum(-1), torch.ones(4, 2))
    assert int((P > 0).sum(-1).max()) <= 2
    pol = m.default_policy()
    gen = torch.Generator().manual_seed(1)
    theta = pol.init(gen, "cpu")
    t = theta["theta"].clone().requires_grad_()
    (g_exact,) = torch.autograd.grad(
        m.exact_J(pol.action_probs({"theta": t})), t)
    from repro_torch.rl.sampler import rollout_batch

    trajs = rollout_batch(m, pol, theta, gen, m.horizon, (60, 200))
    g = gpomdp.per_agent_gradients(pol, theta, trajs, m.gamma)["theta"]
    se = g.std(0) / math.sqrt(g.shape[0])
    assert torch.all((g.mean(0) - g_exact).abs() <= 5 * se + 1e-7)
    with pytest.raises(ValueError, match="branching"):
        envs.garnet(torch.Generator(), n_states=3, branching=9)


def test_registry_and_heterogeneous_fleets():
    assert sorted(envs.registered_envs()) == sorted(
        jax_envs.registered_envs())
    for name, jenv in _zoo():
        env = interop.env_from_jax(jenv, "cpu")
        assert envs.env_kind(env) == jax_envs.env_kind(jenv), name
        pol, jpol = envs.default_policy(env), jax_envs.default_policy(jenv)
        assert type(pol).__name__ == type(jpol).__name__
    assert isinstance(envs.make_env("cliffwalk", width=5), envs.CliffWalk)
    with pytest.raises(ValueError, match="unknown environment"):
        envs.make_env("nope")
    het = envs.make_heterogeneous_env(
        [envs.WindyLandmarkNav(wind=0.02 * i) for i in range(3)])
    assert set(het.params) == {"wind"} and het.kind_tag() == "hetero:windy:3"
    assert het.member(2).wind == pytest.approx(0.04)
    gar = envs.make_heterogeneous_env(
        [envs.garnet(torch.Generator().manual_seed(i), 4, 2, 2)
         for i in range(3)])
    assert set(gar.params) == {"P", "l", "rho"}
    assert gar.params["P"].shape == (3, 4, 2, 4)
    with pytest.raises(ValueError, match="one env family"):
        envs.make_heterogeneous_env([LandmarkNav(), envs.WindyLandmarkNav()])
    with pytest.raises(ValueError, match="structural"):
        envs.make_heterogeneous_env([envs.MultiLandmarkNav(n_landmarks=2),
                                     envs.MultiLandmarkNav(n_landmarks=3)])
    with pytest.raises(ValueError, match="n_agents"):
        envs.check_agent_count(het, 4)
    # a garnet fleet runs: every agent on its own MDP
    cfg = fedpg.FedPGConfig(n_agents=3, batch_m=2, horizon=3, n_rounds=2)
    _, hist = fedpg.run(gar, gar.default_policy(), cfg, 0, device="cpu")
    assert bool(torch.all(torch.isfinite(hist.rewards)))


# ---------------------------------------------------------------------------
# whole runs against the JAX package
# ---------------------------------------------------------------------------

def _jax_chain(jenv, seed=2):
    """theta_0, every round's draws, and the metrics and final theta of
    the JAX package's Algorithm-2 round (``make_round_fn``) chained as
    ``run`` chains it."""
    pol = jax_envs.default_policy(jenv)
    ocfg = jax_ota.OTAConfig(JaxRayleigh(), noise_sigma=1e-2, debias=True)
    key_init, key_scan = jax.random.split(jax.random.key(seed))
    theta = pol.init(key_init)
    theta0 = {k: np.asarray(v) for k, v in theta.items()}
    round_fn = jax.jit(jax_fedpg.make_round_fn(jenv, pol, CFG, ocfg,
                                               ota_backend="pallas"))
    hetero = isinstance(jenv, jax_envs.HeterogeneousEnv)

    def agent_rollout(th, k, lane):
        e = jenv.lane(lane) if hetero else jenv
        traj = jax_sampler.rollout_batch(e, pol, th, k, CFG.horizon,
                                         CFG.batch_m)

        def step_keys(kt):   # rollout: split(key) -> (reset, scan) keys
            _, key_scan = jax.random.split(kt)
            return jax.vmap(lambda x: jax.random.split(x)[1])(
                jax.random.split(key_scan, CFG.horizon + 1))
        ks = jax.vmap(step_keys)(jax.random.split(k, CFG.batch_m))
        base = jenv.base if hetero else jenv
        noise = None
        if _jax_step_noise(base, ks[0, 0]) is not None:
            noise = jax.vmap(jax.vmap(lambda x: _jax_step_noise(base, x)))(ks)
        return traj, noise

    rollouts = jax.jit(lambda th, keys: jax.vmap(
        lambda k, lane: agent_rollout(th, k, lane))(
            keys, dict(jenv.params) if hetero else {}))
    draws, metrics = [], []
    for key in jax.random.split(key_scan, CFG.n_rounds):
        key_samp, key_chan = jax.random.split(key)
        trajs, noise = rollouts(theta, jax.random.split(key_samp,
                                                        CFG.n_agents))
        key_h, key_n = jax.random.split(key_chan)
        acts = np.array(trajs.actions)
        draws.append(fedpg.RoundDraws(
            s0=_t(trajs.obs[:, :, 0]),
            actions=torch.from_numpy(acts if acts.dtype == np.float32
                                     else acts.astype(np.int64)),
            env=None if noise is None else _t(np.moveaxis(
                np.asarray(noise), 2, 0)),      # (T+1, N, M, ...)
            gains=_t(jax_ota.sample_gains(ocfg, key_h, CFG.n_agents)),
            seed=int(jax.random.bits(key_n, (), jnp.uint32))))
        theta, m = round_fn(theta, key)
        metrics.append([float(x) for x in m])
    return (theta0, draws, {k: np.asarray(v) for k, v in theta.items()},
            np.array(metrics))


def _port_rounds(env, theta0, draws, agent_blocks=None):
    o = ota.OTAConfig(RayleighChannel(), noise_sigma=1e-2, debias=True)
    round_fn = fedpg.make_round_fn(env, envs.default_policy(env), CFG, o,
                                   agent_blocks=agent_blocks)
    theta = interop.from_numpy(theta0, "cpu")
    got = []
    for d in draws:
        theta, m = round_fn(theta, None, d)
        got.append([x.item() for x in m])
    return theta, np.array(got)


@pytest.mark.parametrize("name", ["hetero", "lqr", "tabular", "cliffwalk"])
def test_algorithm2_on_the_zoo_matches_jax(name):
    jenv = dict(_zoo())[name]
    theta0, draws, theta_j, want = _jax_chain(jenv)
    env = interop.env_from_jax(jenv, "cpu")
    theta, got = _port_rounds(env, theta0, draws)
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, **TOL)
    for k in theta_j:
        np.testing.assert_allclose(theta[k].numpy(), theta_j[k], **TOL)
    if name == "hetero":
        # per-agent lanes streamed in blocks: bitwise the same every block
        # size, and the stacked history to summation order
        runs = [_port_rounds(env, theta0, draws, b) for b in (1, 2, 3)]
        for th, h in runs[1:]:
            np.testing.assert_array_equal(h, runs[0][1])
        np.testing.assert_allclose(runs[0][1], got, **TOL)
