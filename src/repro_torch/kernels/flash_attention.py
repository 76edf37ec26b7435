"""Wrapper of K3, the hand-written CUDA flash-attention forward.

Counterpart of ``repro/kernels/flash_attention.py``: :func:`flash_attention`
keeps its (B, H, S, Dh) layout and signature, minus ``block_q``,
``block_k`` and ``interpret`` (the tiles are the kernel's own).
:func:`attend_bshd` is the same computation in the model's (B, S, H, Dh)
layout with explicit positions, which ``models/attention.attend_blockwise``
calls; the kernels read either layout through their strides, so neither
copies.  Its plain PyTorch version is ``ref.flash_attention_plain``.

Two CUDA kernels compute it:

* ``csrc/flash_attention_wgmma.cu``, on bf16 tensor cores (wgmma, TMA),
  takes bf16 inputs whose head dim is a multiple of 16 up to 128 and whose
  q, k, v and output have 16-byte-aligned pointers and (batch, head,
  sequence) strides that are multiples of 8 elements (what TMA needs);
  ``ref.flash_attention_tc`` is the plain model of its arithmetic;
* ``csrc/flash_attention.cu`` (f32 CUDA cores) takes everything else:
  float32, other head dims, unaligned views.

Dispatch is by the device of ``q``, then by those properties alone: a CPU
tensor takes the plain version; a CUDA tensor is checked (device, dtype,
shape, strides) and launched on PyTorch's current stream, or the call
raises.  There is no fallback: a failed build or launch raises.  K3 has no
backward: a CUDA call under grad mode with an operand that requires grad
raises (its output would carry no gradient); a forward that autograd
differentiates takes ``models.attention.attend`` (``blockwise=False``, as
the trainers' forward does).  ``LAUNCHES`` counts the f32 kernel's
launches, ``LAUNCHES_TC`` the tensor-core kernel's; ``LAUNCHES_BIDIR`` and
``LAUNCHES_TC_BIDIR`` count those of them that were bidirectional
(``causal=False``), as an encoder's are.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
LAUNCHES_TC = 0
LAUNCHES_BIDIR = 0
LAUNCHES_TC_BIDIR = 0

MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)
_BOUND = set()


def _lib(name: str) -> ctypes.CDLL:
    """``csrc/flash_attention.cu`` (``flash_attention_launch``, which takes a
    leading dtype flag) or ``csrc/flash_attention_wgmma.cu``
    (``flash_attention_wgmma_launch``, bf16 only)."""
    lib = build.load(name)
    if name not in _BOUND:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = getattr(lib, f"{name}_launch")
        lead = [i] if name == "flash_attention" else []
        fn.argtypes = lead + [vp] * 6 + [ll] * 12 + [i] * 8 + [ctypes.c_float, vp]
        fn.restype = i
        _BOUND.add(name)
    return lib


def takes_tensor_cores(*views: torch.Tensor) -> bool:
    """Whether (B, H, S, Dh) views go to the tensor-core kernel: bf16, a
    head dim that is a multiple of 16 up to 128, 16-byte-aligned pointers
    and (batch, head, sequence) strides that are positive multiples of 8
    elements (a dim of size 1 has no stride that matters)."""
    dh = views[0].shape[-1]
    if views[0].dtype != torch.bfloat16 or dh % 16 or not 0 < dh <= 128:
        return False
    return all(x.data_ptr() % 16 == 0 and all(
        n == 1 or (st > 0 and st % 8 == 0)
        for n, st in zip(x.shape[:3], x.stride()[:3])) for x in views)


def _tma_strides(x: torch.Tensor):
    """(batch, head, sequence) strides for a tensor map: a dim of size 1 gets
    the tensor's whole extent, a valid stride that is never stepped."""
    extent = max(n * st for n, st in zip(x.shape, x.stride()))
    return [st if n > 1 else extent for n, st in zip(x.shape[:3],
                                                       x.stride()[:3])]


def _check_window(window: Optional[int]) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _positions(pos: Optional[torch.Tensor], n: int,
               device: torch.device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    if pos.shape != (n,) or pos.device != device:
        raise ValueError(f"positions must be ({n},) on {device}, got "
                         f"{tuple(pos.shape)} on {pos.device}")
    return pos.to(torch.int32).contiguous()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, q_pos: Optional[torch.Tensor],
            k_pos: Optional[torch.Tensor], causal: bool,
            window: Optional[int]) -> None:
    """Check the CUDA operands, given as (B, H, S, Dh) views, and launch K3
    writing into the (B, H, Sq, Dh) view ``out``."""
    global LAUNCHES, LAUNCHES_TC, LAUNCHES_BIDIR, LAUNCHES_TC_BIDIR
    dev = q.device
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for name, x in (("k", k), ("v", v)):
        if x.device != dev or x.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {dev}, got "
                             f"{x.dtype} on {x.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"K3 takes float32 or bfloat16, got {q.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if not 0 < dh <= MAX_HEAD_DIM or hkv < 1 or h % hkv:
        raise ValueError(f"need 0 < Dh <= {MAX_HEAD_DIM} and H % Hkv == 0, "
                         f"got Dh={dh}, H={h}, Hkv={hkv}")
    if any(x.stride(-1) != 1 for x in (q, k, v, out)):
        raise ValueError("q, k, v and out need a unit head-dim stride")
    _check_window(window)
    qp = _positions(q_pos, sq, dev)
    kp = _positions(k_pos, sk, dev)
    tc = takes_tensor_cores(q, k, v, out)
    name = "flash_attention_wgmma" if tc else "flash_attention"
    lead = [] if tc else [int(q.dtype == torch.bfloat16)]
    strides = [s for x in (q, k, v, out) for s in
               (_tma_strides(x) if tc else x.stride()[:3])]
    with torch.cuda.device(dev):   # the launch goes to the current device
        rc = getattr(_lib(name), f"{name}_launch")(
            *lead, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            qp.data_ptr(), kp.data_ptr(), *strides, b, h, hkv, sq, sk, dh,
            int(causal), window or 0, 1.0 / dh ** 0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    if tc:
        LAUNCHES_TC += 1
        LAUNCHES_TC_BIDIR += int(not causal)
    else:
        LAUNCHES += 1
        LAUNCHES_BIDIR += int(not causal)


def _refuse_grad(*ops: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise RuntimeError(
            "K3 (flash_attention) has no backward, and an operand requires "
            "grad: a differentiable forward takes the materialised "
            "models.attention.attend (self_attention(..., blockwise=False); "
            "the trainers' forward, transformer.forward(..., "
            "differentiable=True))")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh) -> (B, H, Sq, Dh) in q's
    dtype; positions ``arange``.  Any Sq and Sk (the tails are masked)."""
    if not q.is_cuda:
        _check_window(window)
        return ref.flash_attention_plain(q, k, v, causal=causal, window=window)
    _refuse_grad(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, None, None, causal, window)
    return out


def attend_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool = True,
                window: Optional[int] = None) -> torch.Tensor:
    """The model's layout: q (B, Sq, H, Dh), k/v (B, Sk, Hkv, Dh), positions
    (Sq,) and (Sk,) -> (B, Sq, H, Dh) in q's dtype."""
    if not q.is_cuda:
        _check_window(window)
        return ref.flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, q_pos=q_pos,
            k_pos=k_pos).transpose(1, 2)
    _refuse_grad(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            out.transpose(1, 2), q_pos, k_pos, causal, window)
    return out
