"""Channels and the stacked OTA uplink of the PyTorch port against the JAX
package.  Moments are Python floats and compare exactly; sampling is held to
the moments.  The uplink takes injected gains (and, with noise, the kernel
seed the JAX package's ``_kernel_seed`` derives) and compares at rtol=1e-6,
atol=1e-7 (XLA's agent sum against PyTorch's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jax_channel
from repro.core import ota as jax_ota
from repro_torch.core import channel, ota

CHANNELS = [
    ("ideal", {}), ("fixed", {"gain": 0.7}), ("rayleigh", {}),
    ("rayleigh", {"scale": 2.0}), ("nakagami", {"m": 0.1, "omega": 1.0}),
    ("nakagami", {"m": 2.0, "omega": 0.5}), ("lognormal", {}),
    ("lognormal", {"mu": 0.1, "sigma": 0.5}),
]


@pytest.mark.parametrize("name,kw", CHANNELS)
def test_channel_moments_equal_jax(name, kw):
    a, b = channel.make_channel(name, **kw), jax_channel.make_channel(name, **kw)
    assert (a.mean, a.var, a.second_moment) == (b.mean, b.var, b.second_moment)
    assert all(a.satisfies_theorem1(n) == b.satisfies_theorem1(n)
               for n in (1, 5, 10, 100))
    assert isinstance(a.mean, float) and isinstance(a.var, float)


def test_noise_sigma_and_registry():
    for db in (-60.0, -20.0, 0.0, 3.0):
        assert channel.noise_sigma_from_db(db) == \
            jax_channel.noise_sigma_from_db(db)
    with pytest.raises(ValueError):
        channel.make_channel("rician")


@pytest.mark.parametrize("name,kw", [c for c in CHANNELS
                                     if c[0] not in ("ideal", "fixed")])
def test_channel_samples_match_moments(name, kw):
    ch = channel.make_channel(name, **kw)
    n = 2 ** 16
    x = ch.sample(torch.Generator().manual_seed(0), (n,), "cpu").double()
    assert bool((x >= 0).all())
    m4 = torch.mean((x - x.mean()) ** 4).item()
    se_mean = (ch.var / n) ** 0.5
    se_var = ((m4 - ch.var ** 2) / n) ** 0.5
    assert abs(x.mean().item() - ch.mean) < 5 * se_mean
    assert abs(x.var().item() - ch.var) < 5 * se_var


def _stack(seed, n_agents=3):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (4, 16), "b1": (16,), "w2": (16, 5), "b2": (5,)}
    g = {k: rng.standard_normal((n_agents,) + s).astype(np.float32)
         for k, s in shapes.items()}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    h = (np.abs(rng.standard_normal(n_agents)) + 0.1).astype(np.float32)
    return g, p, h


def _jax(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _torch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _cfgs(sigma, debias):
    return (ota.OTAConfig(channel.RayleighChannel(), noise_sigma=sigma,
                          debias=debias),
            jax_ota.OTAConfig(jax_channel.RayleighChannel(), noise_sigma=sigma,
                              debias=debias))


def _close(port, ref):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("debias", [False, True])
@pytest.mark.parametrize("apply", [False, True])
def test_noiseless_uplink_matches_jax_xla(apply, debias):
    g, p, h = _stack(1)
    tcfg, jcfg = _cfgs(0.0, debias)
    key = jax.random.key(3)
    if apply:
        want, jh = jax_ota.aggregate_apply(_jax(g), jcfg, _jax(p), key=key,
                                           alpha=0.05, backend="xla",
                                           gains=jnp.asarray(h))
        got, th = ota.aggregate_apply(_torch(g), tcfg, _torch(p), alpha=0.05,
                                      generator=torch.Generator(),
                                      gains=torch.from_numpy(h))
    else:
        want, jh = jax_ota.aggregate(_jax(g), jcfg, key=key, backend="xla",
                                     gains=jnp.asarray(h))
        got, th = ota.aggregate(_torch(g), tcfg, generator=torch.Generator(),
                                gains=torch.from_numpy(h))
    _close(got, want)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("debias", [False, True])
@pytest.mark.parametrize("apply", [False, True])
@pytest.mark.parametrize("key_seed", [0, 5])
def test_noisy_uplink_matches_jax_kernel_path(key_seed, apply, debias):
    g, p, h = _stack(key_seed + 10)
    tcfg, jcfg = _cfgs(0.3, debias)
    key = jax.random.key(key_seed)
    seed = int(jax.random.bits(jax.random.split(key)[1], (), jnp.uint32))
    if apply:
        want, _ = jax_ota.aggregate_apply(_jax(g), jcfg, _jax(p), key=key,
                                          alpha=0.05, backend="pallas",
                                          gains=jnp.asarray(h))
        got, _ = ota.aggregate_apply(_torch(g), tcfg, _torch(p), alpha=0.05,
                                     gains=torch.from_numpy(h), seed=seed)
    else:
        want, _ = jax_ota.aggregate(_jax(g), jcfg, key=key, backend="pallas",
                                    gains=jnp.asarray(h))
        got, _ = ota.aggregate(_torch(g), tcfg, gains=torch.from_numpy(h),
                               seed=seed)
    _close(got, want)


def test_exact_uplink_is_the_mean():
    g, _, _ = _stack(2)
    want, _ = jax_ota.aggregate(_jax(g), None)
    got, h = ota.aggregate(_torch(g), None)
    _close(got, want)
    assert h.item() == 1.0


@pytest.mark.parametrize("wire", ["", "bfloat16"])
def test_kernel_path_layout_agrees_with_plain_chain(wire):
    """The kernel path (flatten, K1's plain version on the CPU, unflatten)
    and the plain chain over the dict leaves see the same draws."""
    g, p, h = _stack(3)
    cfg = ota.OTAConfig(channel.RayleighChannel(), noise_sigma=0.2,
                        debias=True, wire_dtype=wire)
    th = torch.from_numpy(h)
    if wire:  # the plain chain sees the bf16 wire values
        g = {k: np.asarray(torch.from_numpy(v).bfloat16().float())
             for k, v in g.items()}
    a = ota._aggregate_apply_cuda(cfg, th, 77, _torch(g), _torch(p), 0.05)
    b = ota.aggregate_apply(_torch(g), cfg, _torch(p), alpha=0.05, gains=th,
                            seed=77)[0]
    for k in b:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7)
    u = ota._aggregate_stacked_cuda(cfg, th, 77, _torch(g))
    v = ota.aggregate(_torch(g), cfg, gains=th, seed=77)[0]
    for k in v:
        torch.testing.assert_close(u[k], v[k], rtol=1e-6, atol=1e-7)


def test_generator_draws_gains_then_seed():
    g, _, _ = _stack(4, n_agents=5)
    cfg, _ = _cfgs(0.1, True)
    u1, h1 = ota.aggregate(_torch(g), cfg, generator=torch.Generator()
                           .manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    h2 = ota.sample_gains(cfg, gen, 5, "cpu")
    s2 = ota.sample_seed(gen, "cpu")
    u2, _ = ota.aggregate(_torch(g), cfg, gains=h2, seed=s2)
    torch.testing.assert_close(h1, h2, rtol=0, atol=0)
    for k in u1:
        torch.testing.assert_close(u1[k], u2[k], rtol=0, atol=0)


def test_config_and_backend_validation():
    g, _, _ = _stack(0)
    cfg, _ = _cfgs(0.1, True)
    with pytest.raises(ValueError):
        ota.aggregate(_torch(g), cfg, backend="cuda", seed=1,
                      gains=torch.ones(3))
    with pytest.raises(ValueError):
        ota.aggregate(_torch(g), cfg, backend="xla", seed=1)
    with pytest.raises(ValueError):
        ota.aggregate(_torch(g), cfg)  # no generator, nothing injected
    with pytest.raises(TypeError):
        ota.OTAConfig(channel.RayleighChannel(), power_control=object())
    with pytest.raises(ValueError):
        ota.OTAConfig(channel.RayleighChannel(), wire_dtype="float16")
    assert cfg.norm_const == cfg.norm_const_for(3) == \
        channel.RayleighChannel().mean
    assert ota._server_scale(cfg, 3, 3) == 1.0 / (3 * cfg.norm_const)
