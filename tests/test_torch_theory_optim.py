"""The analysis (``core/theory.py``), the env's loss envelope and the
optimizers of the PyTorch port against the JAX package.

Tolerances: the theory is the same Python double arithmetic, so every public
function is held to exact equality; the optimizers run 5 steps over the same
numpy-made parameters and gradients at rtol 1e-6 (float32 ops in the same
order; XLA and PyTorch may round ``pow``/``sqrt``/``cos`` in the last ulp);
K1's plain ``adam`` epilogue against ``_adam_core`` at rtol 1e-6, atol 1e-7
(the uplink parity tolerance of ``test_torch_kernels.py``).
"""
import math
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import theory as jax_theory
from repro.optim import optimizers as jax_opt
from repro.rl.env import LandmarkNav as JaxLandmarkNav
from repro_torch.core import theory
from repro_torch.kernels import ota_fused
from repro_torch.optim import optimizers as opt
from repro_torch.rl.env import LandmarkNav

CHANNELS = [  # (n_agents, batch_m, m_h, sigma_h2): Theorem 1 and Theorem 2
    (10, 10, math.sqrt(math.pi / 2), (4 - math.pi) / 2),
    (5, 4, 0.9, 0.05),
    (2, 3, 1.0, 10.0),         # sigma_h^2 > (N+1) m_h^2: Theorem 2 only
    (1, 1, 0.1, 1.0),          # Lambda <= 0
]


def _consts(mod):
    return mod.MDPConstants(G=1.7, F=0.6, l_bar=3.2, gamma=0.95)


def test_mdp_constants_match_jax():
    a, b = _consts(theory), _consts(jax_theory)
    assert a.smoothness_L() == b.smoothness_L()
    assert a.V() == b.V()
    assert a.max_stepsize(1.25) == b.max_stepsize(1.25)


@pytest.mark.parametrize("n,m,m_h,s2", CHANNELS)
def test_bounds_and_floors_match_jax(n, m, m_h, s2):
    v = _consts(theory).V()
    kw = dict(n_agents=n, batch_m=m, m_h=m_h, sigma_h2=s2, noise_sigma2=1e-6,
              V=v)
    bound_kw = dict(K=250, alpha=1e-3, delta_J=12.5, **kw)
    assert theory.Lambda(n, m, m_h, s2) == jax_theory.Lambda(n, m, m_h, s2)
    assert theory.channel_condition_ok(n, m_h, s2) == \
        jax_theory.channel_condition_ok(n, m_h, s2)
    for name in ("theorem1_bound", "theorem2_bound"):
        assert getattr(theory, name)(**bound_kw) == \
            getattr(jax_theory, name)(**bound_kw)
    for name in ("theorem1_floor", "theorem2_floor", "floor_report"):
        assert getattr(theory, name)(**kw) == getattr(jax_theory, name)(**kw)
    assert theory.applicable_bound(**bound_kw) == \
        jax_theory.applicable_bound(**bound_kw)
    lkw = dict(n_agents=n, batch_m=m, m_h=m_h, sigma_h2=s2,
               noise_sigma2=1e-6, V=v, grad_sq=3.5)
    assert theory.lemma3_bound(**lkw) == jax_theory.lemma3_bound(**lkw)


@pytest.mark.parametrize("eps", [0.3, 1e-2, 1e-4])
def test_schedules_and_constants_match_jax(eps):
    assert astuple(theory.corollary1_schedule(eps, c_m=2.0)) == \
        astuple(jax_theory.corollary1_schedule(eps, c_m=2.0))
    assert theory.corollary1_schedule(eps).total_trajectories == \
        jax_theory.corollary1_schedule(eps).total_trajectories
    mk = dict(weight_bound=1.5, input_bound=2.0, hidden=16, n_actions=5,
              l_bar=eps * 100, gamma=0.99)
    assert astuple(theory.mlp_policy_constants(**mk)) == \
        astuple(jax_theory.mlp_policy_constants(**mk))


@pytest.mark.parametrize("horizon", [3, 20, 50])
def test_env_loss_envelope_matches_jax(horizon):
    env, jenv = LandmarkNav(), JaxLandmarkNav()
    assert env.l_bar_for(horizon) == jenv.l_bar_for(horizon)
    assert env.l_bar == jenv.l_bar
    assert theory.env_l_bar(env, horizon) == \
        jax_theory.env_l_bar(jenv, horizon)
    a = theory.constants_for_env(env, horizon=horizon, gamma=0.99, G=2.0,
                                 F=0.5)
    b = jax_theory.constants_for_env(jenv, horizon=horizon, gamma=0.99,
                                     G=2.0, F=0.5)
    assert astuple(a) == astuple(b)
    with pytest.raises(ValueError, match="l_bar"):
        theory.env_l_bar(object(), horizon)


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}


def _optimizers(mod):
    return {
        "sgd": mod.sgd(0.05),
        "momentum": mod.momentum(0.05, beta=0.8),
        "nesterov": mod.momentum(mod.cosine_schedule(0.05, 4), nesterov=True),
        "adam": mod.adam(1e-2),
        "adamw": mod.adamw(mod.warmup_cosine(1e-2, 2, 8), weight_decay=0.05),
    }


@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adam",
                                  "adamw"])
def test_optimizer_trajectories_match_jax(name):
    """5 steps, each gradient a fixed numpy draw plus 0.3 * params, so the
    trajectory feeds back into the updates."""
    p0 = _params(0)
    grads = [_params(10 + i) for i in range(5)]
    t_opt, j_opt = _optimizers(opt)[name], _optimizers(jax_opt)[name]
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    ts, js = t_opt.init(tp), j_opt.init(jp)
    for g in grads:
        tg = {k: torch.from_numpy(g[k]) + 0.3 * tp[k] for k in g}
        jg = {k: jnp.asarray(g[k]) + 0.3 * jp[k] for k in g}
        tu, ts = t_opt.update(tg, ts, tp)
        ju, js = j_opt.update(jg, js, jp)
        tp, jp = opt.apply_updates(tp, tu), jax_opt.apply_updates(jp, ju)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert int(ts.step) == int(js.step) == 5
    for field in ("mu", "nu"):
        if getattr(js, field) is not None:
            for k in p0:
                np.testing.assert_allclose(
                    getattr(ts, field)[k].numpy(),
                    np.asarray(getattr(js, field)[k]), rtol=1e-6, atol=1e-9)


def test_schedules_and_clipping_match_jax():
    steps = np.arange(0, 12, dtype=np.int32)
    for mk in (lambda m: m.cosine_schedule(0.1, 10, 0.2),
               lambda m: m.warmup_cosine(0.1, 3, 10)):
        got = mk(opt)(torch.from_numpy(steps)).numpy()
        want = np.asarray(mk(jax_opt)(jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    g = _params(3)
    for max_norm in (0.5, 100.0):
        tc, tn = opt.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        jc, jn = jax_opt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6)
    with pytest.raises(ValueError, match="params"):
        opt.adamw(1e-3).update({"b": torch.zeros(2)},
                               opt.adamw(1e-3).init({"b": torch.zeros(2)}))


def test_k1_adam_mode_is_adam_core():
    """K1's plain ``adam`` epilogue (``fused_aggregate_adam``) on one
    unit-gain row with no noise and scale 1 is one step of ``adam`` on that
    row, from the same moments."""
    rng = np.random.default_rng(7)
    u = torch.from_numpy(rng.standard_normal(50).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal(50).astype(np.float32))
    mu = torch.from_numpy((rng.standard_normal(50) * 0.1).astype(np.float32))
    nu = torch.from_numpy(np.abs(rng.standard_normal(50)).astype(np.float32)
                          * 0.01)
    step = 7
    adam = opt.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    state = opt.OptState(step=torch.tensor(step - 1, dtype=torch.int32),
                         mu={"p": mu}, nu={"p": nu})
    upd, new = adam.update({"p": u}, state)
    want_p = opt.apply_updates({"p": p}, upd)["p"]
    got_p, got_mu, got_nu = ota_fused.fused_aggregate_adam(
        u[None], torch.ones(1), p, mu, nu, alpha=1e-3, step=step, b1=0.9,
        b2=0.999, eps=1e-8, with_noise=False, scale=1.0)
    for got, want in ((got_p, want_p), (got_mu, new.mu["p"]),
                      (got_nu, new.nu["p"])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)
