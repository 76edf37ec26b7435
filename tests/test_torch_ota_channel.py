"""K2, the server-side OTA update ``(v + sigma*n) / (N*m_h)``, in the PyTorch
port against the JAX package's Pallas kernel (interpret mode on the CPU),
on numpy-made inputs.

Tolerances:

* the counter bits: bitwise;
* the normals (the kernel's own noise, extracted as the JAX suite does with
  v = 0, sigma = 1, N = 1): rtol = atol = 1e-6, as ``test_torch_kernels.py``
  holds K1's, since XLA's and PyTorch's CPU ``log``/``cos`` part by a few
  ulp;
* the port's oracle on the JAX kernel's own noise: float32 rtol 1e-6, atol
  1e-7 (the JAX suite's kernel-vs-oracle tolerance,
  ``tests/test_kernels.py:187``); bfloat16 within one bfloat16 ulp of the
  JAX value (both sides round one float32 value);
* the port's plain K2 (its own noise) against the JAX kernel: the same,
  plus the normals' tolerance carried through ``sigma * n * scale``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.ota_channel import _mix as jax_mix
from repro.kernels.ota_channel import ota_channel_apply as jax_k2
from repro_torch.kernels import ops, ota_channel, ota_fused, ref

F32_TOL = dict(rtol=1e-6, atol=1e-7)


def _v(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each value of ``x`` (8 significant bits)."""
    mag = np.abs(x.astype(np.float64))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    return np.where(mag > 0, 2.0 ** (exp - 7), 2.0 ** -133)


def _jax(v: np.ndarray, dtype, **kw) -> np.ndarray:
    out = jax_k2(jnp.asarray(v).astype(dtype), interpret=True, **kw)
    return np.array(out.astype(jnp.float32))


def _jax_noise(shape, seed):
    return _jax(np.zeros(shape, np.float32), jnp.float32, sigma=1.0,
                n_agents=1, m_h=1.0, seed=seed)


def _close_through_noise(got, want, noise, sigma, scale):
    """rtol 1e-6, atol 1e-7, plus the normals' rtol = atol = 1e-6 carried
    through ``sigma * n * scale``."""
    tol = (1e-7 + 1e-6 * np.abs(want)
           + sigma * scale * 1e-6 * (1.0 + np.abs(noise)))
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want) - tol)


@pytest.mark.parametrize("seed", [0, 123])
@pytest.mark.parametrize("n_agents,m_h,debias", [
    (1, 1.0, True),
    (7, 1.2533, True),     # the paper's Rayleigh m_h
    (4, 0.8, False),       # debias off: m_h must not be applied
])
@pytest.mark.parametrize("sigma", [0.0, 0.5, 2.0])
def test_plain_k2_matches_jax_kernel(sigma, n_agents, m_h, debias, seed):
    """The grid of ``tests/test_kernels.py:160-190`` at its unaligned
    (37, 65) shape."""
    shape = (37, 65)
    v = _v(shape, seed + 1)
    kw = dict(sigma=sigma, n_agents=n_agents, m_h=m_h, debias=debias)
    want = _jax(v, jnp.float32, seed=seed, **kw)
    noise = _jax_noise(shape, seed)
    oracle = ref.ota_channel_ref(torch.from_numpy(v), torch.from_numpy(noise),
                                 **kw)
    np.testing.assert_allclose(oracle.numpy(), want, **F32_TOL)
    got = ota_channel.ota_channel_apply(torch.from_numpy(v), seed=seed, **kw)
    assert got.dtype == torch.float32 and got.shape == shape
    _close_through_noise(got.numpy(), want, noise, sigma,
                         ref.ota_channel_scale(n_agents, m_h, debias))


@pytest.mark.parametrize("seed", [0, 123, 2 ** 32 - 1])
def test_k2_normals_match_jax_kernel(seed):
    shape = (300, 129)
    got = ref.counter_noise(seed, 300 * 129).reshape(shape)
    np.testing.assert_allclose(got.numpy(), _jax_noise(shape, seed),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(17,), (100, 37), (3, 5, 129)])
def test_plain_k2_shapes_and_dtypes(shape, dtype):
    v = _v(shape, 9)
    kw = dict(sigma=0.5, n_agents=3, m_h=1.1, debias=True, seed=3)
    tdt = getattr(torch, dtype)
    got = ota_channel.ota_channel_apply(torch.from_numpy(v).to(tdt), **kw)
    assert got.dtype == tdt and got.shape == shape
    want = _jax(v, getattr(jnp, dtype), **kw)
    got = got.float().numpy()
    if dtype == "float32":
        _close_through_noise(got, want, _jax_noise(shape, 3), 0.5,
                             1.0 / (3 * 1.1))
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))


@pytest.mark.parametrize("seed", [0, 123, 2 ** 32 - 1])
def test_counter_bits_are_the_jax_kernels(seed):
    n = 70_000
    counter = jnp.arange(n, dtype=jnp.uint32)
    base = jax_mix(counter, jnp.uint32(seed) * jnp.uint32(0x9E3779B9))
    want = [np.asarray(jax_mix(base, jnp.uint32(s)) >> 8).astype(np.int64)
            for s in (0xA511E9B3, 0x63D83595)]
    got = ref.counter_bits(seed, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_k2_stream_is_k1_server_pass():
    """K2 on a flat float32 vector equals K1's unit-gain server pass on the
    same seed: both key the counter on the absolute flat index."""
    v = torch.from_numpy(_v((1000,), 4))
    k2 = ota_channel.ota_channel_apply(v, sigma=0.5, n_agents=7, m_h=1.3,
                                       seed=11)
    k1 = ota_fused.fused_server_pass(v, sigma=0.5, scale=1.0 / (7 * 1.3),
                                     seed=11)
    assert torch.equal(k2, k1)


def test_ota_update_on_the_cpu_launches_nothing():
    v = _v((64, 33), 2)
    kw = dict(sigma=0.7, n_agents=5, m_h=1.2, debias=True, seed=7)
    before = ota_channel.LAUNCHES
    got = ops.ota_update(torch.from_numpy(v), **kw)
    assert ota_channel.LAUNCHES == before
    assert torch.equal(got, ref.ota_channel_plain(torch.from_numpy(v), **kw))
    want = jax_ops.ota_update(jnp.asarray(v), use_pallas=True,
                              interpret=True, **kw)
    _close_through_noise(got.numpy(), np.asarray(want),
                         _jax_noise(v.shape, 7), 0.7, 1.0 / (5 * 1.2))


def test_ota_channel_ref_matches_jax_oracle():
    """The op-for-op oracle on an injected noise tensor."""
    v, noise = _v((5, 40), 0), _v((5, 40), 1)
    for debias in (True, False):
        got = ref.ota_channel_ref(torch.from_numpy(v), torch.from_numpy(noise),
                                  sigma=0.3, n_agents=6, m_h=0.9,
                                  debias=debias)
        want = jax_ref.ota_channel_ref(jnp.asarray(v), jnp.asarray(noise),
                                       sigma=0.3, n_agents=6, m_h=0.9,
                                       debias=debias)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_k2_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ota_channel.ota_channel_apply(torch.zeros(4, dtype=torch.float16),
                                      sigma=0.1, n_agents=1)
    with pytest.raises(ValueError, match="2\\^32"):
        ota_channel.ota_channel_apply(torch.zeros(1).expand(2 ** 32),
                                      sigma=0.1, n_agents=1)


def test_noiseless_k2_is_the_scale_alone():
    v = torch.from_numpy(_v((257,), 3))
    got = ota_channel.ota_channel_apply(v, sigma=0.0, n_agents=4, m_h=0.8,
                                        debias=False, seed=99)
    assert torch.equal(got, v * ref.f32(0.25))
