"""The port's kernels (K1 uplink, K3 flash attention, K4 SSD scan) against
the JAX package.

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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ota_fused as jax_fused
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import flash_attention, ops, ota_fused, ref, ssd_scan

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


# ---------------------------------------------------------------------------
# K3: flash attention, plain version vs the Pallas kernel and the oracle
# ---------------------------------------------------------------------------

def _to_port(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,hkv,s,d,causal,window",
    [
        (1, 2, 2, 128, 64, True, None),
        (1, 4, 2, 128, 64, True, None),      # GQA g=2
        (1, 8, 2, 128, 128, True, None),     # GQA g=4
        (1, 2, 1, 256, 64, True, 128),       # sliding window
        (1, 2, 2, 128, 64, False, None),     # bidirectional
        (1, 3, 1, 128, 112, True, None),     # zamba2 head_dim=112, g=3
    ],
)
def test_flash_plain_matches_jax_kernel(b, h, hkv, s, d, causal, window,
                                        dtype):
    rng = np.random.default_rng(b * s + h + d)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    tq, tk, tv = (_to_port(x, tdt) for x in (q, k, v))
    want = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=128,
                     block_k=128)
    oracle = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=window)
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (b, h, s, d)
    tol = 3e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)
    port_oracle = ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                          window=window)
    np.testing.assert_allclose(_np(port_oracle), _np(oracle), atol=tol,
                               rtol=tol)


def test_flash_plain_ragged_and_bshd_layout():
    """Lengths the Pallas kernel refuses (not multiples of 128) against the
    jnp oracle, and the model's (B, S, H, Dh) entry against the (B, H, S,
    Dh) one."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((2, 4, 48, 64), (2, 2, 48, 64), (2, 2, 48, 64)))
    want = jax_ref.flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-6,
                               rtol=3e-6)
    pos = torch.arange(48)
    bshd = flash_attention.attend_bshd(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        q_pos=pos, k_pos=pos)
    np.testing.assert_array_equal(bshd.transpose(1, 2).numpy(), got.numpy())
    with pytest.raises(ValueError):
        flash_attention.flash_attention(tq, tk, tv, window=0)


# ---------------------------------------------------------------------------
# K4: SSD scan, plain version vs the Pallas kernel and the oracles
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1).astype(
        np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, h)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,p,g,n,chunk",
    [
        (1, 128, 2, 64, 1, 64, 64),
        (1, 256, 4, 64, 1, 128, 128),        # mamba2-130m-like
        (1, 256, 4, 32, 2, 16, 64),          # grouped B/C
        (2, 128, 8, 64, 2, 64, 32),
    ],
)
def test_ssd_plain_matches_jax_kernel(b, s, h, p, g, n, chunk, dtype):
    x, dt, A, B, C = _ssd_inputs(s + h * p, b, s, h, p, g, n)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    J = [jnp.asarray(a).astype(jdt) for a in (x, dt)] + [jnp.asarray(A)] + [
        jnp.asarray(a).astype(jdt) for a in (B, C)]
    T = [_to_port(a, tdt) for a in (x, dt)] + [torch.from_numpy(A)] + [
        _to_port(a, tdt) for a in (B, C)]
    want = jax_ssd_scan(*J, chunk=chunk)
    oracle = jax_ref.ssd_ref(*J, chunk)
    got = ssd_scan.ssd_scan(*T, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, p)
    tol = 5e-5 if dtype == "float32" else 5e-2
    # the TPU kernel writes x's dtype; the port returns float32, as ssd_ref
    np.testing.assert_allclose(_np(got.to(tdt)), _np(want), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(got.numpy(), _np(oracle), atol=tol, rtol=tol)
    assert torch.equal(ops.ssd(*T, chunk=chunk), got)


@pytest.mark.parametrize("s,chunk", [(256, 64), (200, 64), (48, 128)])
def test_ssd_plain_matches_sequential_and_jax_padding(s, chunk):
    """The chunked plain version against both packages' sequential
    recurrence, including the zero-padded tail (s=200) and chunk = S
    (s=48)."""
    x, dt, A, B, C = _ssd_inputs(11 + s, 1, s, 2, 32, 1, 32)
    T = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    J = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    got = ssd_scan.ssd_scan(*T, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref.ssd_sequential_ref(*J)), atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               ref.ssd_sequential_ref(*T).numpy(), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref.ssd_ref(*J, chunk)), atol=5e-5, rtol=5e-5)


def test_k3_k4_cpu_path_launches_nothing():
    fa, ss = flash_attention.LAUNCHES, ssd_scan.LAUNCHES
    ops.attention(torch.ones(1, 2, 8, 16), torch.ones(1, 1, 8, 16),
                  torch.ones(1, 1, 8, 16))
    ops.ssd(torch.ones(1, 8, 2, 4), torch.ones(1, 8, 2), -torch.ones(2),
            torch.ones(1, 8, 1, 4), torch.ones(1, 8, 1, 4), chunk=4)
    assert (flash_attention.LAUNCHES, ssd_scan.LAUNCHES) == (fa, ss)
