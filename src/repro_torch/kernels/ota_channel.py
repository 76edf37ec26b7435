"""Wrapper of K2, the hand-written CUDA kernel for the server-side OTA update.

Counterpart of ``repro/kernels/ota_channel.py``: ``ota_channel_apply`` with
the same signature minus ``block_rows`` and ``interpret`` (the TPU's VMEM
tiling has no counterpart).  It computes ``(v + sigma*n) / (N*m_h)`` (``/N``
without debias) over a tensor of any shape in float32 and returns v's dtype;
``n`` is the counter-PRNG normal on the absolute flat index, the stream K1
draws, so K2 on a flat float32 ``v`` equals ``fused_server_pass`` bit for bit.
The kernel is ``csrc/ota_channel.cu``; its plain version is
``ref.ota_channel_plain``.

Dispatch is by the device of ``v``: a CPU tensor takes the plain version, a
CUDA tensor is checked and launched on PyTorch's current stream, or the call
raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0

_MAX_ELEMS = 2 ** 32 - 1     # the noise counter is a uint32 flat index
_THREADS = 256               # CUDA block size (results do not depend on it)
_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = build.load("ota_channel")
    if not _BOUND:
        vp, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
        lib.ota_channel_launch.argtypes = [i, i, vp, vp, ctypes.c_ulonglong,
                                           f, f, ctypes.c_uint, i, vp]
        lib.ota_channel_launch.restype = i
        _BOUND = True
    return lib


def ota_channel_apply(v: torch.Tensor, *, sigma: float, n_agents: int,
                      m_h: float = 1.0, debias: bool = True,
                      seed: int = 0) -> torch.Tensor:
    """Fused ``(v + sigma*AWGN) / (N*m_h)`` over an arbitrary-shape float32
    or bfloat16 tensor; the result has v's shape and dtype.  ``sigma <= 0``
    skips the noise."""
    global LAUNCHES
    if v.dtype not in ref.K2_DTYPES:
        raise ValueError(f"v must be float32 or bfloat16, got {v.dtype}")
    if v.numel() > _MAX_ELEMS:
        raise ValueError(f"v has {v.numel()} elements; the counter PRNG "
                         f"indexes fewer than 2^32")
    kw = dict(sigma=sigma, n_agents=n_agents, m_h=m_h, debias=debias)
    if not v.is_cuda:
        return ref.ota_channel_plain(v, seed=seed, **kw)
    src = v.contiguous()
    out = torch.empty_like(src)
    if src.numel() == 0:
        return out
    with torch.cuda.device(v.device):   # the launch goes to the current one
        rc = _lib().ota_channel_launch(
            int(v.dtype == torch.bfloat16), int(sigma > 0.0), src.data_ptr(),
            out.data_ptr(), src.numel(), float(sigma),
            ref.ota_channel_scale(n_agents, m_h, debias),
            int(seed) & ref.MASK32, _THREADS,
            torch.cuda.current_stream(v.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ota_channel kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
