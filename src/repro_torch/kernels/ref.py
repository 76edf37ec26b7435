"""Plain PyTorch versions of the fused over-the-air uplink kernel (K1).

Counterpart of ``repro/kernels/ref.py`` (``ota_fused_ref`` and its sgd/adam
forms) plus the kernel's counter PRNG, ``counter_noise``, which the JAX
package keeps inside ``repro/kernels/ota_fused.py`` (``_mix``,
``_counter_noise``).  These functions are the definitions the CUDA kernel in
``csrc/ota_fused.cu`` is held to, op for op:

* the gain matvec is a strict sequential fold over agents from zero,
  ``v = (((0 + h0*g0) + h1*g1) + ...)``, each product and sum rounded on its
  own (the kernel uses ``__fmul_rn``/``__fadd_rn``, which are never
  contracted into an FMA);
* then ``v + sigma*n``, then ``* scale``, then the mode's epilogue.

Given the kernel's own noise realisation, ``ota_fused_ref`` is bitwise equal
to the kernel's ``agg`` mode in fp32 and through the bf16 wire.

The counter PRNG works on uint32 values held in int64 tensors (PyTorch has
no wrap-around uint32 multiply on every device); ``_mul32`` multiplies
modulo 2^32 in 16-bit halves so no intermediate leaves the int64 range.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9          # seed multiplier
SALT_U1 = 0xA511E9B3         # first uniform stream
SALT_U2 = 0x63D83595         # second uniform stream
TWO_PI_F32 = 6.283185307179586   # rounded to float32(2*pi) by the f32 multiply

Seed = Union[int, torch.Tensor]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a Python constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _mix(x: torch.Tensor, salt) -> torch.Tensor:
    """One murmur3-finalizer round over uint32 counters."""
    x = x ^ salt
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def _seed_salt(seed: Seed, device):
    """``seed * GOLDEN mod 2^32``: a Python int for an int seed (no
    host-to-device copy, which would wait for the card), else a tensor."""
    if isinstance(seed, torch.Tensor):
        return _mul32(seed.to(device=device, dtype=torch.int64) & MASK32,
                      GOLDEN)
    return (int(seed) & MASK32) * GOLDEN & MASK32


def counter_bits(seed: Seed, n: int,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two 24-bit uniform streams ``(u1 >> 8, u2 >> 8)`` for the absolute
    flat indices ``0..n-1`` (int64 tensors)."""
    if n >= 2 ** 32:
        raise ValueError(f"counter PRNG indexes < 2^32 elements, got {n}")
    if device is None and isinstance(seed, torch.Tensor):
        device = seed.device
    counter = torch.arange(n, dtype=torch.int64, device=device)
    base = _mix(counter, _seed_salt(seed, device))
    return _mix(base, SALT_U1) >> 8, _mix(base, SALT_U2) >> 8


def uniforms(b1: torch.Tensor,
             b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """24-bit streams -> (f1 in (0, 1], f2 in [0, 1)), float32, exact."""
    f1 = b1.float() * (1.0 / (1 << 24)) + (1.0 / (1 << 25))
    f2 = b2.float() * (1.0 / (1 << 24))
    return f1, f2


def counter_noise(seed: Seed, n: int, device=None) -> torch.Tensor:
    """(n,) standard normals: counter PRNG on the absolute index, then
    Box-Muller, ``sqrt(-2 log f1) * cos(float32(2 pi) * f2)``."""
    f1, f2 = uniforms(*counter_bits(seed, n, device))
    return torch.sqrt(-2.0 * torch.log(f1)) * torch.cos(TWO_PI_F32 * f2)


def f32(x) -> torch.Tensor:
    """A runtime scalar as a 0-dim float32 CPU tensor, rounded from double
    once, as ``jnp.asarray(x, float32)`` does.  PyTorch passes a 0-dim CPU
    tensor to a CUDA op as a float32 scalar argument, so no host-to-device
    copy is made."""
    return torch.tensor(float(x), dtype=torch.float32)


def ota_fused_ref(grads: torch.Tensor, gains: torch.Tensor,
                  noise: Optional[torch.Tensor] = None, *, sigma=0.0,
                  scale=1.0) -> torch.Tensor:
    """u = (sum_i h_i g_i + sigma*n) * scale over an (A, P) stack."""
    dev = grads.device
    g = grads.float()
    h = gains.float()
    v = torch.zeros(g.shape[1], dtype=torch.float32, device=dev)
    for a in range(g.shape[0]):
        v = v + h[a] * g[a]
    if noise is not None:
        v = v + f32(sigma) * noise.float()
    return v * f32(scale)


def ota_fused_sgd_ref(grads, gains, params, noise=None, *, alpha, sigma=0.0,
                      scale=1.0) -> torch.Tensor:
    """p' = p - alpha * u over :func:`ota_fused_ref`."""
    u = ota_fused_ref(grads, gains, noise, sigma=sigma, scale=scale)
    return params.float() - f32(alpha) * u


def adam_bias_corrections(b1, b2, step) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(1 - b1^t, 1 - b2^t)`` in float32, as the JAX wrapper computes them."""
    t = f32(step)
    return 1.0 - f32(b1) ** t, 1.0 - f32(b2) ** t


def ota_fused_adam_ref(grads, gains, params, mu, nu, noise=None, *, alpha,
                       step, b1=0.9, b2=0.999, eps=1e-8, sigma=0.0,
                       scale=1.0):
    """Aggregation + bias-corrected Adam on the fused update, op for op as
    the kernel's adam mode.  Returns (p', mu', nu')."""
    u = ota_fused_ref(grads, gains, noise, sigma=sigma, scale=scale)
    c1, c2 = adam_bias_corrections(b1, b2, step)
    a, b1, b2, eps = (f32(x) for x in (alpha, b1, b2, eps))
    mu_n = b1 * mu.float() + (1.0 - b1) * u
    nu_n = b2 * nu.float() + (1.0 - b2) * torch.square(u)
    delta = -(a * (mu_n / c1) / (torch.sqrt(nu_n / c2) + eps))
    return params.float() + delta, mu_n, nu_n
