"""Wrapper of K1, the hand-written CUDA kernel for the fused OTA uplink.

Counterpart of ``repro/kernels/ota_fused.py``: the same four entry points
with the same signatures, minus ``interpret`` and ``block_rows`` (the TPU's
VMEM blocking has no counterpart), plus ``threads`` (the CUDA block size,
which the result does not depend on).  The kernel itself is
``csrc/ota_fused.cu``; its plain PyTorch version is ``kernels/ref.py``.

Dispatch is by the device of the gradient stack:

* a CPU tensor takes the plain version (the counter PRNG then the op-for-op
  fold of ``ref.ota_fused_ref``), which is how the CPU tests reach it;
* a CUDA tensor is checked (device, dtype, shape, contiguity) and launched
  on PyTorch's current stream, or the call raises.  There is no fallback.

``rescale`` (``fused_aggregate``, ``fused_aggregate_sgd``,
``fused_server_pass``) is an optional one-element float32 tensor on the
gradients' device that multiplies ``scale``: the kernel forms
``float32(scale) * rescale`` in float32 and scales by that, so a normaliser
computed on the card (the round service's ``N / W``) reaches the kernel
without a host synchronisation.  ``None`` leaves the bits unchanged.

``LAUNCHES`` counts kernel launches (one per call that reaches the card), so
a run can show that its rounds went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0

_MODES = {"agg": 0, "sgd": 1, "adam": 2}
_WIRE_DTYPES = (torch.float32, torch.bfloat16)
_MAX_PARAMS = 2 ** 32 - 1     # the noise counter is a uint32 flat index
_BOUND = False

Seed = Union[int, torch.Tensor]


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = build.load("ota_fused")
    if not _BOUND:
        vp, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        lib.ota_fused_launch.argtypes = (
            [i, i, i, vp, vp, i, ctypes.c_ulonglong] + [vp] * 6 + [f] * 8
            + [vp, ctypes.c_uint, vp, i, vp])
        lib.ota_fused_launch.restype = i
        lib.ota_counter_bits_launch.argtypes = [
            ctypes.c_ulonglong, vp, ctypes.c_uint, vp, vp, i, vp]
        lib.ota_counter_bits_launch.restype = i
        _BOUND = True
    return lib


def _check_threads(threads: int) -> None:
    if not (32 <= threads <= 1024 and threads % 32 == 0):
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], "
                         f"got {threads}")


def _seed_args(seed: Seed, device: torch.device):
    """(pointer, value) kernel arguments: a device int64 seed is read by the
    kernel itself (no host sync); anything else is passed by value."""
    if isinstance(seed, torch.Tensor) and seed.device == device:
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError("a device seed must be one int64 element, got "
                             f"{seed.dtype} {tuple(seed.shape)}")
        return seed.data_ptr(), 0
    return None, int(seed) & ref.MASK32


def _check_vector(name: str, x: torch.Tensor, n: int,
                  device: torch.device) -> None:
    if x.device != device or x.dtype != torch.float32 or x.shape != (n,) \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 ({n},) tensor "
                         f"on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def _check_rescale(rescale: Optional[torch.Tensor],
                   device: torch.device) -> None:
    if rescale is not None and (rescale.device != device
                                or rescale.dtype != torch.float32
                                or rescale.numel() != 1):
        raise ValueError(f"rescale must be one float32 element on {device}, "
                         f"got {rescale.dtype} {tuple(rescale.shape)} on "
                         f"{rescale.device}")


def _launch(mode: str, grads: torch.Tensor, gains: torch.Tensor,
            states: Sequence[torch.Tensor], *, with_noise: bool, seed: Seed,
            sigma=0.0, scale=1.0, alpha=0.0, b1=0.0, b2=0.0, c1=1.0, c2=1.0,
            eps=0.0, rescale: Optional[torch.Tensor] = None,
            threads: int = 256) -> Tuple[torch.Tensor, ...]:
    """Validate the CUDA operands, allocate the outputs, launch K1."""
    global LAUNCHES
    dev = grads.device
    if grads.dtype not in _WIRE_DTYPES or not grads.is_contiguous():
        raise ValueError(f"grads must be contiguous float32 or bfloat16, got "
                         f"{grads.dtype} (contiguous={grads.is_contiguous()})")
    n_agents, n_params = grads.shape
    if n_agents < 1 or not 0 < n_params <= _MAX_PARAMS:
        raise ValueError(f"grads shape {tuple(grads.shape)} out of range "
                         f"(1 <= A, 0 < P < 2^32)")
    _check_threads(threads)
    _check_vector("gains", gains, n_agents, dev)
    for name, x in zip(("params", "mu", "nu"), states):
        _check_vector(name, x, n_params, dev)
    _check_rescale(rescale, dev)
    n_out = 3 if mode == "adam" else 1
    outs = [torch.empty(n_params, dtype=torch.float32, device=dev)
            for _ in range(n_out)]
    ptrs = [x.data_ptr() for x in states] + [None] * (3 - len(states))
    out_ptrs = [x.data_ptr() for x in outs] + [None] * (3 - n_out)
    seed_ptr, seed_val = _seed_args(seed, dev)
    rc = _lib().ota_fused_launch(
        _MODES[mode], int(grads.dtype == torch.bfloat16), int(with_noise),
        grads.data_ptr(), gains.data_ptr(), n_agents, n_params,
        *ptrs, *out_ptrs,
        *(float(x) for x in (sigma, scale, alpha, b1, b2, c1, c2, eps)),
        seed_ptr, seed_val, None if rescale is None else rescale.data_ptr(),
        threads, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ota_fused kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return tuple(outs)


def _prep(grads: torch.Tensor, gains: torch.Tensor, wire_dtype):
    if grads.ndim != 2:
        raise ValueError(f"grads must be (n_agents, n_params), got "
                         f"{tuple(grads.shape)}")
    if gains.device != grads.device:
        raise ValueError(f"gains on {gains.device}, grads on {grads.device}")
    if wire_dtype is not None:
        grads = grads.to(wire_dtype)
    return grads


def _noise(with_noise: Optional[bool], seed: Seed, grads: torch.Tensor):
    """The plain version's noise realisation, or None."""
    if with_noise is False:
        return None
    return ref.counter_noise(seed, grads.shape[1], grads.device)


def fused_aggregate(grads: torch.Tensor, gains: torch.Tensor, *, sigma=0.0,
                    scale=1.0, seed: Seed = 0,
                    with_noise: Optional[bool] = None, wire_dtype=None,
                    rescale: Optional[torch.Tensor] = None,
                    threads: int = 256) -> torch.Tensor:
    """u = (sum_i h_i g_i + sigma*n) * scale, fused; returns (P,) float32.
    ``rescale`` multiplies ``scale`` on the device (module docstring)."""
    grads = _prep(grads, gains, wire_dtype)
    if not grads.is_cuda:
        return ref.ota_fused_ref(grads, gains, _noise(with_noise, seed, grads),
                                 sigma=sigma, scale=scale, rescale=rescale)
    (out,) = _launch("agg", grads, gains, (), with_noise=with_noise is not False,
                     seed=seed, sigma=sigma, scale=scale, rescale=rescale,
                     threads=threads)
    return out


def fused_aggregate_sgd(grads: torch.Tensor, gains: torch.Tensor,
                        params: torch.Tensor, *, alpha, sigma=0.0, scale=1.0,
                        seed: Seed = 0, with_noise: Optional[bool] = None,
                        wire_dtype=None, rescale: Optional[torch.Tensor] = None,
                        threads: int = 256) -> torch.Tensor:
    """p' = p - alpha * u with u the fused OTA update; (P,) float32."""
    grads = _prep(grads, gains, wire_dtype)
    if not grads.is_cuda:
        return ref.ota_fused_sgd_ref(grads, gains, params,
                                     _noise(with_noise, seed, grads),
                                     alpha=alpha, sigma=sigma, scale=scale,
                                     rescale=rescale)
    (out,) = _launch("sgd", grads, gains, (params,),
                     with_noise=with_noise is not False, seed=seed,
                     sigma=sigma, scale=scale, alpha=alpha, rescale=rescale,
                     threads=threads)
    return out


def fused_server_pass(v: torch.Tensor, *, sigma=0.0, scale=1.0,
                      seed: Seed = 0, with_noise: Optional[bool] = None,
                      alpha=None, params: Optional[torch.Tensor] = None,
                      rescale: Optional[torch.Tensor] = None,
                      threads: int = 256) -> torch.Tensor:
    """The server tail over an already-accumulated superposition ``v``:
    AWGN + debias, and the SGD step when ``params`` (and ``alpha``) are
    given.  ``v`` is one unit-gain agent row with no wire-dtype hop, and the
    noise is keyed on the absolute index, so it equals the one-shot draw."""
    flat = v.float().reshape(1, -1).contiguous()
    ones = torch.ones(1, dtype=torch.float32, device=flat.device)
    if params is None:
        return fused_aggregate(flat, ones, sigma=sigma, scale=scale,
                               seed=seed, with_noise=with_noise,
                               rescale=rescale, threads=threads)
    if alpha is None:
        raise ValueError("fused_server_pass with params needs alpha")
    return fused_aggregate_sgd(flat, ones, params, alpha=alpha, sigma=sigma,
                               scale=scale, seed=seed, with_noise=with_noise,
                               rescale=rescale, threads=threads)


def fused_aggregate_adam(grads: torch.Tensor, gains: torch.Tensor,
                         params: torch.Tensor, mu: torch.Tensor,
                         nu: torch.Tensor, *, alpha, step, b1: float = 0.9,
                         b2: float = 0.999, eps: float = 1e-8, sigma=0.0,
                         scale=1.0, seed: Seed = 0,
                         with_noise: Optional[bool] = None, wire_dtype=None,
                         threads: int = 256):
    """Aggregation + bias-corrected Adam in one pass: (p', mu', nu').  The
    corrections ``1 - b^t`` are computed in float32, as the JAX wrapper
    does."""
    grads = _prep(grads, gains, wire_dtype)
    if not grads.is_cuda:
        return ref.ota_fused_adam_ref(
            grads, gains, params, mu, nu, _noise(with_noise, seed, grads),
            alpha=alpha, step=step, b1=b1, b2=b2, eps=eps, sigma=sigma,
            scale=scale)
    c1, c2 = ref.adam_bias_corrections(b1, b2, step)
    return _launch("adam", grads, gains, (params, mu, nu),
                   with_noise=with_noise is not False, seed=seed, sigma=sigma,
                   scale=scale, alpha=alpha, b1=b1, b2=b2, c1=c1, c2=c2,
                   eps=eps, threads=threads)


def counter_bits(seed: Seed, n: int, device,
                 threads: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two 24-bit uniform streams for indices ``0..n-1`` (int64
    tensors), through the same device function K1 draws its noise with.
    A check of the counter stream, not a step of the uplink: it does not
    count in ``LAUNCHES``."""
    device = torch.device(device)
    if device.type != "cuda":
        return ref.counter_bits(seed, n, device)
    if not 0 < n <= _MAX_PARAMS:
        raise ValueError(f"n={n} out of range (0 < n < 2^32)")
    _check_threads(threads)
    b1, b2 = (torch.empty(n, dtype=torch.int32, device=device)
              for _ in range(2))
    seed_ptr, seed_val = _seed_args(seed, device)
    rc = _lib().ota_counter_bits_launch(
        n, seed_ptr, seed_val, b1.data_ptr(), b2.data_ptr(), threads,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ota_counter_bits launch failed: cudaError {rc}")
    return b1.long(), b2.long()
