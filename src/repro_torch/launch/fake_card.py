"""Rank 0 of a fake mesh on a fake card: the dry run's stand-ins.

A dry run (``launch/dryrun.py``) runs one step of the port's own code on
tensors that have shapes and dtypes but no storage, as rank 0 of a process
group that moves no data:

* :func:`fake_group` starts a ``torch.distributed`` group of the ``fake``
  backend (every collective is accepted and does nothing) of any size,
  this process its rank 0, over which ``launch.mesh``'s meshes form as
  they do over a real group, so ``shard_for_training`` and
  ``shard_for_serving`` lay the state out as on rank 0 of a 256- or
  512-rank pod;
* :func:`fake_card` is a ``FakeTensorMode`` in which tensors stand on
  ``cuda``: the port's dispatch (``x.is_cuda``, ``x.device.type``) takes
  the card's side everywhere, and each kernel wrapper's launch is abstract
  (``kernels/abstract.py``).

On a PyTorch built without CUDA (the CPU hosts the tests run on) a fake
``cuda`` tensor cannot pass autograd or indexing (both ask for a CUDA
device guard such a build does not have), so there the fake tensors are
kept on the CPU underneath and *presented* as ``cuda``: ``is_cuda`` and
``get_device()`` answer for ``cuda:0``, ``.device`` does so when read from
the port's own modules (``repro_torch.*``; torch's internals see the
CPU), and a ``cuda`` device passed to a factory or ``.to`` is taken as
the CPU (``utils.device.resolve_device`` lets ``cuda`` through while
a fake mode is on).  The same presentation is used on a CUDA build, so a
dry run touches no card and both hosts trace the same ops.  Inside the mode a
real (host) tensor's value can still be read (``int(state.step)``), and
a fake tensor's ``data_ptr()`` is its offset in bytes from a base of 0
(the caching allocator's blocks are 512-byte aligned), so the alignment
rules of K1, K3 and K4 see what a fresh allocation would give.
"""
from __future__ import annotations

import contextlib
import sys
import warnings
from typing import Iterator

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import (
    FakeTensor, FakeTensorMode, unset_fake_temporarily,
)
from torch.overrides import TorchFunctionMode

_CPU = torch.device("cpu")
_CARD = torch.device("cuda", 0)
_IS_CUDA = torch._C.TensorBase.__dict__["is_cuda"]
_SCALAR_READS = {torch.Tensor.__int__, torch.Tensor.__float__,
                 torch.Tensor.__bool__, torch.Tensor.__index__,
                 torch.Tensor.item, torch.Tensor.tolist}
_PORT = "repro_torch"


def fake_group(world_size: int) -> None:
    """Start (or restart at another size) the default process group as
    rank 0 of ``world_size`` ranks on the ``fake`` backend."""
    # FakeStore lives in torch's private testing package; it is the store
    # the fake backend is documented with, and nothing else here needs it.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _host(d):
    """A ``cuda`` device argument taken as the CPU underneath."""
    if isinstance(d, torch.device) and d.type == "cuda":
        return _CPU
    if isinstance(d, str) and d.startswith("cuda"):
        return _CPU
    return d


class _Presentation(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fake = bool(args) and isinstance(args[0], FakeTensor)
        if fake and getattr(func, "__self__", None) is _IS_CUDA:
            return True
        if fake and func is torch.Tensor.get_device:
            return 0
        if fake and func is torch.Tensor.data_ptr:
            return args[0].storage_offset() * args[0].element_size()
        if func in _SCALAR_READS and not fake:
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        if func is torch.Tensor.cuda:
            return args[0].to(_CPU)
        args = tuple(_host(a) for a in args)
        if "device" in kwargs:
            kwargs["device"] = _host(kwargs["device"])
        return func(*args, **kwargs)


_FAKE_DEVICE = FakeTensor.__dict__["device"]


def _presented_device(self) -> torch.device:
    dev = _FAKE_DEVICE.fget(self)
    if dev.type == "cpu" and sys._getframe(1).f_globals.get(
            "__name__", "").startswith(_PORT):
        return _CARD
    return dev


@contextlib.contextmanager
def fake_card() -> Iterator[FakeTensorMode]:
    """A ``FakeTensorMode`` (real host tensors allowed in) whose tensors
    stand on ``cuda`` for the port's code (module docstring)."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    FakeTensor.device = property(_presented_device, _FAKE_DEVICE.fset)
    try:
        with warnings.catch_warnings():
            # a fake tensor's data_ptr() is answered above, not read
            warnings.filterwarnings("ignore", message=".*data pointer of "
                                    "FakeTensor.*")
            with mode, _Presentation():
                yield mode
    finally:
        FakeTensor.device = _FAKE_DEVICE


def on_card(x: torch.Tensor) -> torch.Tensor:
    """A fake stand-in of ``x``'s shape and dtype on the card (inside
    :func:`fake_card`; ``x`` may be a ``meta`` tensor)."""
    return torch.empty(x.shape, dtype=x.dtype, device="cuda")
