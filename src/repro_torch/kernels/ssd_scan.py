"""Wrapper of K4, the hand-written CUDA kernel for the Mamba2 SSD scan.

Counterpart of ``repro/kernels/ssd_scan.py``: :func:`ssd_scan` keeps its
signature minus ``interpret``.  It returns float32, which is what the JAX
model's ``ssd_ref`` returns and the model uses (the TPU kernel writes x's
dtype).  Unlike the TPU kernel it takes any length:
a length that is not a multiple of ``chunk`` is handled as ``ssd_ref``'s
right zero-padding, and ``chunk = S`` when ``S < chunk``.  Its plain
PyTorch version is ``ref.ssd_ref``.

Two CUDA kernels compute it:

* ``csrc/ssd_scan_tc.cu``, on bf16 tensor cores, takes bf16 x, B and C
  whose head dim P and state size N are multiples of 8 and whose pointers
  are 16-byte aligned (what its 16-byte asynchronous copies need);
  ``ref.ssd_tc`` is the plain model of its arithmetic;
* ``csrc/ssd_scan.cu`` (f32 CUDA cores) takes everything else: float32
  inputs, other P and N.

Dispatch is by the device of ``x``, then by those properties alone: a CPU
tensor takes the plain version; a CUDA tensor is checked (device, dtype,
shape, contiguity) and launched on PyTorch's current stream, or the call
raises.  There is no fallback: a failed build or launch raises.  K4 has no
backward: a CUDA call under grad mode with an operand that requires grad
raises (its output would carry no gradient); a forward that autograd
differentiates runs ``ref.ssd_ref`` (``ssm_mixer(..., plain_scan=True)``,
which the trainer's forward takes).  ``LAUNCHES`` counts the f32
kernel's launches, ``LAUNCHES_TC`` the tensor-core kernel's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
LAUNCHES_TC = 0

MAX_CHUNK = 128
MAX_STATE = 128
MAX_HEAD_DIM = 64
_DTYPES = (torch.float32, torch.bfloat16)
_BOUND = set()


def _lib(name: str) -> ctypes.CDLL:
    """``csrc/ssd_scan.cu`` (``ssd_scan_launch``, which takes a leading dtype
    flag) or ``csrc/ssd_scan_tc.cu`` (``ssd_scan_tc_launch``, bf16 only)."""
    lib = build.load(name)
    if name not in _BOUND:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = ([i] if name == "ssd_scan" else []) + [vp] * 6 + \
            [i] * 7 + [vp]
        fn.restype = i
        _BOUND.add(name)
    return lib


def takes_tensor_cores(x: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor) -> bool:
    """Whether contiguous operands go to the tensor-core kernel: bf16, P and
    N multiples of 8, 16-byte-aligned pointers."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and B.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, B, C)))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """x (B, S, H, P), dt (B, S, H) post-softplus, A (H,) negative,
    B/C (B, S, G, N) -> y (B, S, H, P) in float32."""
    global LAUNCHES, LAUNCHES_TC
    if not x.is_cuda:
        return ref.ssd_ref(x, dt, A, B, C, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise RuntimeError(
            "K4 (ssd_scan) has no backward, and an operand requires grad: "
            "a differentiable forward takes the plain scan ref.ssd_ref "
            "(ssm_mixer(..., plain_scan=True); the trainers' forward, "
            "transformer.forward(..., differentiable=True))")
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
    tc = takes_tensor_cores(x, B, C)
    name = "ssd_scan_tc" if tc else "ssd_scan"
    lead = [] if tc else [int(x.dtype == torch.bfloat16)]
    with torch.cuda.device(dev):   # the launch goes to the current device
        rc = getattr(_lib(name), f"{name}_launch")(
            *lead, x.data_ptr(), dt32.data_ptr(), a32.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), b, s, h, p, g, n, q,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    if tc:
        LAUNCHES_TC += 1
    else:
        LAUNCHES += 1
    return y
