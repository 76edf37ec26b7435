"""Transmit-power control in the PyTorch port against the JAX package.

Tolerances: the closed-form moments are the same Python double arithmetic,
held at rel 1e-12; ``apply`` on a shared float32 gain vector at rtol 1e-6
(one division and a clamp, and the budgets' float32 linspace, may round
differently); Monte-Carlo moments within 5 standard errors of the JAX
package's, since the two draw different streams (a CPU ``torch.Generator``
seeded with 0 against ``jax.random.key(0)``); one power-controlled uplink
round with injected gains at rtol 1e-6, atol 1e-7 (the uplink parity
tolerance of ``test_torch_kernels.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jax_channel
from repro.core import ota as jax_ota
from repro.core import power_control as jax_pc
from repro_torch.core import channel, ota, power_control as pc

BASES = [
    (channel.RayleighChannel(), jax_channel.RayleighChannel()),
    (channel.RayleighChannel(scale=0.7), jax_channel.RayleighChannel(0.7)),
    (channel.NakagamiChannel(m=0.5, omega=2.0),
     jax_channel.NakagamiChannel(m=0.5, omega=2.0)),
]
POLICIES = [
    (pc.UnitPower(), jax_pc.UnitPower()),
    (pc.TruncatedInversion(), jax_pc.TruncatedInversion()),
    (pc.TruncatedInversion(target=1.2, p_max=4.0, c_min=0.2),
     jax_pc.TruncatedInversion(target=1.2, p_max=4.0, c_min=0.2)),
    (pc.FullInversion(target=0.8), jax_pc.FullInversion(target=0.8)),
    (pc.ConstantReceived(target=1.5), jax_pc.ConstantReceived(target=1.5)),
    (pc.HeterogeneousBudget(p_min=0.25, p_max=2.0),
     jax_pc.HeterogeneousBudget(p_min=0.25, p_max=2.0)),
]
IDS = ["unit", "trunc", "trunc2", "full", "const", "hetero"]


@pytest.mark.parametrize("policy", POLICIES, ids=IDS)
@pytest.mark.parametrize("base", BASES, ids=["rayleigh", "rayleigh07",
                                             "nakagami"])
def test_closed_form_moments_match_jax(base, policy):
    got = pc.closed_form_moments(base[0], policy[0], n_agents=6)
    want = jax_pc.closed_form_moments(base[1], policy[1], n_agents=6)
    assert (got is None) == (want is None)
    if got is not None:
        for x, y in zip(got, want):
            assert math.isclose(x, y, rel_tol=1e-12, abs_tol=1e-300)


@pytest.mark.parametrize("policy", POLICIES, ids=IDS)
def test_apply_on_shared_gains_matches_jax(policy):
    c = np.abs(np.random.default_rng(0).standard_normal((4, 9))).astype(
        np.float32)
    c[0, :3] = (0.0, 1e-13, 0.05)   # the clamp and the outage edge
    got = policy[0].apply(torch.from_numpy(c)).numpy()
    want = np.asarray(policy[1].apply(jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    idx = np.arange(9, dtype=np.int32)
    got_i = policy[0].apply_indexed(torch.from_numpy(c[1]),
                                    torch.from_numpy(idx), 9).numpy()
    want_i = np.asarray(policy[1].apply_indexed(jnp.asarray(c[1]),
                                                jnp.asarray(idx), 9))
    np.testing.assert_allclose(got_i, want_i, rtol=1e-6)


@pytest.mark.parametrize("n_agents", [None, 5])
def test_monte_carlo_moments_agree_with_jax(n_agents):
    """FullInversion over Nakagami has no closed form: both packages fall
    back to Monte Carlo over 200,000 draws.  HeterogeneousBudget (per agent)
    needs ``n_agents``."""
    base = BASES[2]
    pol = (POLICIES[3] if n_agents is None
           else (pc.HeterogeneousBudget(), jax_pc.HeterogeneousBudget()))
    m_t, v_t = pc.estimate_moments(base[0], pol[0],
                                   torch.Generator().manual_seed(0),
                                   n_agents=n_agents)
    m_j, v_j = jax_pc.estimate_moments(base[1], pol[1], jax.random.key(0),
                                       n_agents=n_agents)
    n = 200_000
    assert abs(m_t - m_j) <= 5 * math.sqrt(2 * v_j / n)
    c = base[0].sample(torch.Generator().manual_seed(1),
                       (n // 5, 5) if n_agents else (n,), "cpu").double()
    h = c * pol[0].apply(c.float()).double()
    fourth = float(torch.mean((h - h.mean()) ** 4))
    assert abs(v_t - v_j) <= 5 * math.sqrt(2 * (fourth - v_j ** 2) / n)
    # the cached fallback is deterministic and matches the direct estimate
    assert pc.effective_moments(base[0], pol[0], n_agents=n_agents) == \
        pc.effective_moments(base[0], pol[0], n_agents=n_agents)
    mm = pc.make_controlled_channel(base[0], pol[0], n_agents=n_agents)
    assert (mm.mean, mm.var) == pc.effective_moments(base[0], pol[0],
                                                     n_agents=n_agents)


@pytest.mark.parametrize("policy", POLICIES, ids=IDS)
def test_norm_const_and_effective_mean_match_jax(policy):
    port = ota.OTAConfig(channel.RayleighChannel(), noise_sigma=0.1,
                         debias=True, power_control=policy[0])
    ref = jax_ota.OTAConfig(jax_channel.RayleighChannel(), noise_sigma=0.1,
                            debias=True, power_control=policy[1])
    assert math.isclose(port.norm_const_for(4), ref.norm_const_for(4),
                        rel_tol=1e-12)
    assert math.isclose(ota.effective_gain_mean(port, 4),
                        float(jax_ota.effective_gain_mean(ref, 4)),
                        rel_tol=1e-12)
    assert port.norm_const == ref.norm_const
    plain = ota.OTAConfig(channel.RayleighChannel(), power_control=policy[0])
    assert plain.norm_const_for(4) == 1.0       # no debias: no normaliser


@pytest.mark.parametrize("policy", POLICIES[1:3] + POLICIES[4:], ids=IDS[1:3]
                         + IDS[4:])
def test_power_controlled_round_with_injected_gains_matches_jax(policy):
    """One uplink + SGD step with the gains the JAX package draws (c * p(c)
    over its Rayleigh draw), the kernel seed of its key: the scale folds in
    the effective mean."""
    rng = np.random.default_rng(5)
    grads = {"w": rng.standard_normal((4, 6, 3)).astype(np.float32),
             "b": rng.standard_normal((4, 3)).astype(np.float32)}
    params = {k: v[0] * 0.3 for k, v in grads.items()}
    key = jax.random.key(8)
    key_h, key_n = jax.random.split(key)
    jcfg = jax_ota.OTAConfig(jax_channel.RayleighChannel(), noise_sigma=0.05,
                             debias=True, power_control=policy[1])
    h = np.array(jax_ota.sample_gains(jcfg, key_h, 4))
    want, hj = jax_ota.aggregate_apply(
        {k: jnp.asarray(v) for k, v in grads.items()}, jcfg,
        {k: jnp.asarray(v) for k, v in params.items()}, key=key, alpha=0.2,
        backend="pallas")
    np.testing.assert_array_equal(h, np.asarray(hj))
    tcfg = ota.OTAConfig(channel.RayleighChannel(), noise_sigma=0.05,
                         debias=True, power_control=policy[0])
    got, _ = ota.aggregate_apply(
        {k: torch.from_numpy(v) for k, v in grads.items()}, tcfg,
        {k: torch.from_numpy(v) for k, v in params.items()}, alpha=0.2,
        gains=torch.from_numpy(h),
        seed=int(jax.random.bits(key_n, (), jnp.uint32)))
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_sampled_gains_are_c_times_p_of_c():
    cfg = ota.OTAConfig(channel.RayleighChannel(), noise_sigma=0.1,
                        debias=True, power_control=pc.TruncatedInversion())
    h = ota.sample_gains(cfg, torch.Generator().manual_seed(3), 1000, "cpu")
    c = channel.RayleighChannel().sample(torch.Generator().manual_seed(3),
                                         (1000,), "cpu")
    assert torch.equal(h, c * pc.TruncatedInversion().apply(c))
    assert float(h.max()) <= 1.0 + 1e-6      # inverted to the target
    assert bool((h[c < 0.05] == 0).all())   # outage


def test_controlled_channel_contract():
    base = channel.RayleighChannel()
    with pytest.raises(ValueError, match="base channel"):
        pc.ControlledChannel()
    nan = pc.ControlledChannel(base=base, policy=pc.FullInversion())
    assert math.isnan(nan.mean)
    with pytest.raises(ValueError, match="finite"):
        ota.OTAConfig(nan, debias=True)
    het = pc.make_controlled_channel(base, pc.HeterogeneousBudget(),
                                     n_agents=4)
    assert het.sample(torch.Generator().manual_seed(0), (4,), "cpu").shape \
        == (4,)
    with pytest.raises(ValueError, match="n_agents=4"):
        het.sample(torch.Generator().manual_seed(0), (5,), "cpu")
    pc.check_agent_count(het, 4)
    with pytest.raises(ValueError, match="n_agents=4"):
        pc.check_agent_count(het, 6)
    with pytest.raises(ValueError, match="n_agents"):
        pc.closed_form_moments(base, pc.HeterogeneousBudget())
    with pytest.raises(ValueError):
        pc.HeterogeneousBudget().apply(torch.tensor(1.0))
    with pytest.raises(TypeError):
        ota.OTAConfig(base, power_control="unit")
