"""K1 (the fused OTA uplink) in the PyTorch port against the JAX package.

The JAX side runs its Pallas kernel in interpret mode on the CPU, as
``tests/test_kernels.py`` does; the port side runs the plain PyTorch version
that its wrapper takes for CPU tensors.  Inputs come from numpy with fixed
seeds.  The kernel's noise is extracted with the zero-gradient trick: G=0,
h=1, sigma=1, scale=1 gives u = n.

Tolerances: the counter bits and the uniforms are integer/exact float
arithmetic and compare bitwise; the normals go through ``log``/``cos``, where
XLA's and PyTorch's CPU versions differ by a few ulp (rtol=atol=1e-6); the
uplink outputs compare at rtol=1e-6, atol=1e-7 (XLA's matvec against the
port's sequential agent fold, and one possible FMA in the update).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ota_fused as jax_fused
from repro_torch.kernels import ota_fused, ref

SEEDS = [0, 123, 2 ** 32 - 1]


def _jax_noise(n, seed):
    z = jnp.zeros((1, n), jnp.float32)
    return np.asarray(jax_fused.fused_aggregate(
        z, jnp.ones((1,), jnp.float32), sigma=1.0, scale=1.0, seed=seed,
        with_noise=True))


def _jax_bits(n, seed):
    counter = jnp.arange(n, dtype=jnp.uint32)
    base = jax_fused._mix(counter, jnp.uint32(seed) * jnp.uint32(0x9E3779B9))
    u1 = jax_fused._mix(base, jnp.uint32(0xA511E9B3))
    u2 = jax_fused._mix(base, jnp.uint32(0x63D83595))
    return u1 >> 8, u2 >> 8


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_bits_and_uniforms_bitwise(seed):
    n = 70_000
    jb1, jb2 = _jax_bits(n, seed)
    b1, b2 = ref.counter_bits(seed, n, "cpu")
    np.testing.assert_array_equal(b1.numpy(), np.asarray(jb1, np.int64))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(jb2, np.int64))
    jf1 = jb1.astype(jnp.float32) * (1.0 / (1 << 24)) + (1.0 / (1 << 25))
    jf2 = jb2.astype(jnp.float32) * (1.0 / (1 << 24))
    f1, f2 = ref.uniforms(b1, b2)
    np.testing.assert_array_equal(f1.numpy(), np.asarray(jf1))
    np.testing.assert_array_equal(f2.numpy(), np.asarray(jf2))


@pytest.mark.parametrize("seed", SEEDS)
def test_counter_noise_matches_jax_kernel_stream(seed):
    n = 5000
    np.testing.assert_allclose(ref.counter_noise(seed, n, "cpu").numpy(),
                               _jax_noise(n, seed), rtol=1e-6, atol=1e-6)
    # the wrapper's CPU path draws the same stream through the zero trick
    got = ota_fused.fused_aggregate(torch.zeros(1, n), torch.ones(1),
                                    sigma=1.0, scale=1.0, seed=seed)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.counter_noise(seed, n, "cpu").numpy())


def _inputs(seed, n_agents=7, n_params=1000):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_agents, n_params)).astype(np.float32)
    h = (np.abs(rng.standard_normal(n_agents)) + 0.1).astype(np.float32)
    p = rng.standard_normal(n_params).astype(np.float32)
    mu = (rng.standard_normal(n_params) * 0.1).astype(np.float32)
    nu = (np.abs(rng.standard_normal(n_params)) * 0.01).astype(np.float32)
    return g, h, p, mu, nu


def _run_both(mode, seed, sigma, wire):
    g, h, p, mu, nu = _inputs(seed)
    kw = dict(sigma=sigma, scale=1.0 / (7 * 1.2533), seed=seed,
              with_noise=sigma > 0.0)
    jw, tw = (jnp.bfloat16, torch.bfloat16) if wire == "bf16" else (None, None)
    J = [jnp.asarray(x) for x in (g, h, p, mu, nu)]
    T = [torch.from_numpy(x) for x in (g, h, p, mu, nu)]
    if mode == "agg":
        a = jax_fused.fused_aggregate(*J[:2], wire_dtype=jw, **kw)
        b = ota_fused.fused_aggregate(*T[:2], wire_dtype=tw, **kw)
        return [a], [b]
    if mode == "sgd":
        a = jax_fused.fused_aggregate_sgd(*J[:3], alpha=0.05, wire_dtype=jw,
                                          **kw)
        b = ota_fused.fused_aggregate_sgd(*T[:3], alpha=0.05, wire_dtype=tw,
                                          **kw)
        return [a], [b]
    akw = dict(alpha=1e-3, step=10, b1=0.9, b2=0.999, eps=1e-8)
    a = jax_fused.fused_aggregate_adam(*J, wire_dtype=jw, **akw, **kw)
    b = ota_fused.fused_aggregate_adam(*T, wire_dtype=tw, **akw, **kw)
    return list(a), list(b)


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("seed", [0, 9])
@pytest.mark.parametrize("mode", ["agg", "sgd", "adam"])
def test_plain_uplink_matches_jax_kernel(mode, seed, sigma, wire):
    jax_out, port_out = _run_both(mode, seed, sigma, wire)
    for a, b in zip(jax_out, port_out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


def test_server_pass_is_one_unit_gain_row():
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.standard_normal(777).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal(777).astype(np.float32))
    u = ota_fused.fused_server_pass(v, sigma=0.3, scale=0.5, seed=7)
    expect = ref.ota_fused_ref(v[None], torch.ones(1),
                               ref.counter_noise(7, 777), sigma=0.3, scale=0.5)
    np.testing.assert_array_equal(u.numpy(), expect.numpy())
    p2 = ota_fused.fused_server_pass(v, sigma=0.3, scale=0.5, seed=7,
                                     alpha=0.1, params=p)
    np.testing.assert_array_equal(p2.numpy(), (p - ref.f32(0.1) * u)
                                  .numpy())
    with pytest.raises(ValueError):
        ota_fused.fused_server_pass(v, params=p)


def test_cpu_path_launches_nothing():
    before = ota_fused.LAUNCHES
    ota_fused.fused_aggregate(torch.ones(2, 5), torch.ones(2), sigma=0.1)
    assert ota_fused.LAUNCHES == before
