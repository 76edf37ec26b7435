"""Wrapper of K4, the hand-written CUDA kernel for the Mamba2 SSD scan.

Counterpart of ``repro/kernels/ssd_scan.py``: :func:`ssd_scan` keeps its
signature minus ``interpret``.  It returns float32, which is what the JAX
model's ``ssd_ref`` returns and the model uses (the TPU kernel writes x's
dtype).  Unlike the TPU kernel it takes any length:
a length that is not a multiple of ``chunk`` is handled as ``ssd_ref``'s
right zero-padding, and ``chunk = S`` when ``S < chunk``.  The kernel is
``csrc/ssd_scan.cu``; its plain PyTorch version is ``ref.ssd_ref``.

Dispatch is by the device of ``x``: a CPU tensor takes the plain version; a
CUDA tensor is checked (device, dtype, shape, contiguity) and launched on
PyTorch's current stream, or the call raises.  There is no fallback.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0

MAX_CHUNK = 128
MAX_STATE = 128
MAX_HEAD_DIM = 64
_DTYPES = (torch.float32, torch.bfloat16)
_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = build.load("ssd_scan")
    if not _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_launch.argtypes = [i] + [vp] * 6 + [i] * 7 + [vp]
        lib.ssd_scan_launch.restype = i
        _BOUND = True
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """x (B, S, H, P), dt (B, S, H) post-softplus, A (H,) negative,
    B/C (B, S, G, N) -> y (B, S, H, P) in float32."""
    global LAUNCHES
    if not x.is_cuda:
        return ref.ssd_ref(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dev = x.device
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B and C must share float32 or bfloat16, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    if B.shape != (b, s, g, n) or C.shape != B.shape or dt.shape != (b, s, h) \
            or A.shape != (h,):
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if any(t.device != dev for t in (dt, A, B, C)):
        raise ValueError(f"every operand must be on {dev}")
    if not (g >= 1 and h % g == 0 and 0 < p <= MAX_HEAD_DIM
            and 0 < n <= MAX_STATE and chunk >= 1):
        raise ValueError(f"need H % G == 0, P <= {MAX_HEAD_DIM}, "
                         f"N <= {MAX_STATE}; got H={h}, G={g}, P={p}, N={n}")
    q = min(chunk, s)   # the chunk ``ssd_ref`` uses
    if q > MAX_CHUNK:
        raise ValueError(f"chunk {q} > {MAX_CHUNK}")
    if not all(t.is_contiguous() for t in (x, B, C)):
        raise ValueError("x, B and C must be contiguous")
    dt32 = dt.float().contiguous()
    a32 = A.float().contiguous()
    y = torch.empty(x.shape, dtype=torch.float32, device=dev)
    rc = _lib().ssd_scan_launch(
        int(x.dtype == torch.bfloat16), x.data_ptr(), dt32.data_ptr(),
        a32.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(), b, s, h,
        p, g, n, q, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return y
