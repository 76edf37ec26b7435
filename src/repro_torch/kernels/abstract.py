"""Abstract launches: the kernels' wrappers on fake tensors.

A dry run (``launch/dryrun.py``) traces the card's path on ``FakeTensor``s
that stand on ``cuda``: every wrapper checks its operands, picks its kernel
and body and allocates its outputs as for a real launch, and only the
ctypes launch itself is replaced.  With fake operands the wrapper loads no
library, makes no card current and calls nothing; it calls
:func:`record`, which counts one abstract launch of the kernel (here, apart
from the wrappers' ``LAUNCHES*``, which count real launches only) with the
FLOPs and bytes of its formula (``utils/roofline.py``), and returns the
outputs it allocated.  FlopCounterMode cannot see a ctypes launch, so a
dry run adds these formulas to its aten count.

A ``meta`` tensor carries no device a kernel could run on and no plain
version should see: every wrapper refuses one (:func:`refuse_meta`).  A
fake tensor on the CPU would take a plain version, which a dry run must
never trace: the wrappers refuse that too.

Launch records: inside :func:`launch_log` every launch of a wrapper that
keeps records (K1's) appends a :class:`LaunchRecord` (the launch name, the
wire dtype its stack was read in, its shape, and whether it was abstract)
to the log, abstract launches with their formula's cost.  A dispatch mode
sees no ctypes launch, so this log is how a checker reads what went
through a kernel (``analyze/contracts.py``'s ``wire-dtype``); outside a
log a real launch keeps nothing, and an abstract one counts its wire dtype
in ``WIRES`` beside its cost.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

# the kernel (K1..K4) of each launch name
KERNEL_OF = {
    "ota_fused": "K1", "ota_fused_mapped": "K1", "ota_channel": "K2",
    "flash_attention": "K3", "flash_attention_wgmma": "K3",
    "ssd_scan": "K4", "ssd_scan_tc": "K4",
}

LAUNCHES: Dict[str, int] = {}     # abstract launches by launch name
FLOPS: Dict[str, float] = {}      # their formula FLOPs
BYTES: Dict[str, float] = {}      # their formula bytes
WIRES: Dict[str, Dict[str, int]] = {}   # their count by the stack's dtype


class LaunchRecord(NamedTuple):
    """One launch seen by an open :func:`launch_log`."""

    name: str               # the launch name (``KERNEL_OF``'s key)
    wire: Optional[str]     # the stack's dtype as read, e.g. "bfloat16"
    shape: Tuple[int, ...]  # the stack's shape
    abstract: bool          # a dry run's launch (no card)
    flops: float = 0.0      # the formula's cost (abstract launches)
    nbytes: float = 0.0


_LOGS: List[List[LaunchRecord]] = []


@contextlib.contextmanager
def launch_log() -> Iterator[List[LaunchRecord]]:
    """``with launch_log() as log: ...``: every recorded launch inside the
    block, abstract or real, in order."""
    log: List[LaunchRecord] = []
    _LOGS.append(log)
    try:
        yield log
    finally:   # by identity: an enclosing log may hold the same records
        del _LOGS[next(i for i, x in enumerate(_LOGS) if x is log)]


def recording() -> bool:
    """Whether a :func:`launch_log` is open (a wrapper checks this before
    it makes a record of a real launch)."""
    return bool(_LOGS)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def note(name: str, wire: Optional[torch.dtype], shape, *,
         is_abstract: bool, flops: float = 0.0, nbytes: float = 0.0) -> None:
    """Append one launch to every open :func:`launch_log`."""
    rec = LaunchRecord(name, None if wire is None else _dtype_name(wire),
                       tuple(int(s) for s in shape), is_abstract,
                       float(flops), float(nbytes))
    for log in _LOGS:
        log.append(rec)


def is_abstract(*xs) -> bool:
    """Whether any of the operands is a fake tensor (a dry run)."""
    return any(isinstance(x, FakeTensor) for x in xs)


def refuse_meta(name: str, *xs) -> None:
    """Raise for a ``meta`` operand, or for a fake one that would take the
    plain version (not on ``cuda``): a dry run traces the card's path on
    fake ``cuda`` tensors (``launch/dryrun.py``)."""
    for x in xs:
        if isinstance(x, torch.Tensor) and (
                x.is_meta or (isinstance(x, FakeTensor) and not x.is_cuda)):
            raise ValueError(
                f"{name} got a {'meta' if x.is_meta else 'fake CPU'} tensor: "
                f"a kernel runs on a cuda tensor, its plain version on a "
                f"real CPU tensor, and a dry run traces fake cuda tensors "
                f"(launch.dryrun)")


def record(name: str, flops: float, nbytes: float, *,
           wire: Optional[torch.dtype] = None, shape=()) -> None:
    """Count one abstract launch of ``name`` with its formula's cost (and,
    inside a :func:`launch_log`, record it with its wire dtype)."""
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    FLOPS[name] = FLOPS.get(name, 0.0) + float(flops)
    BYTES[name] = BYTES.get(name, 0.0) + float(nbytes)
    if wire is not None:
        by = WIRES.setdefault(name, {})
        by[_dtype_name(wire)] = by.get(_dtype_name(wire), 0) + 1
    if _LOGS:
        note(name, wire, shape, is_abstract=True, flops=flops, nbytes=nbytes)


def reset() -> None:
    LAUNCHES.clear()
    FLOPS.clear()
    BYTES.clear()
    WIRES.clear()


def by_kernel(table: Dict[str, float]) -> Dict[str, float]:
    """A table by launch name summed by kernel (K1..K4)."""
    out: Dict[str, float] = {}
    for name, v in table.items():
        out[KERNEL_OF[name]] = out.get(KERNEL_OF[name], 0) + v
    return out
