"""The aten ops a piece of PyTorch code issues, recorded under a dispatch mode.

The port's counterpart of inspecting a jaxpr: JAX traces a function into
equations without running it; eager PyTorch runs it, and an
:class:`OpRecorder` (a ``TorchDispatchMode``) sees every aten op on its way
to the kernels, with its inputs' dtypes and each output's dtype and shape.
Under ``launch.fake_card`` the ops run on fake tensors, so the card's path
is recorded on a host without one.  A ctypes kernel launch issues no aten
op: its wrapper's launch record says what went through it
(``kernels.abstract.launch_log``).

``core.ota.uplink_ops`` records the uplink with it (``analyze``'s
``wire-dtype`` and ``stream-contract`` walk the records).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class AtenOp(NamedTuple):
    """One tensor output of one aten op."""

    op: str                       # e.g. "aten._to_copy.default"
    in_dtypes: Tuple[str, ...]    # every tensor input's dtype, in order
    dtype: str                    # this output's dtype
    shape: Tuple[int, ...]        # this output's shape
    view: bool                    # the output aliases an input (no new
                                  # memory: a view, or an in-place op)


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class OpRecorder(TorchDispatchMode):
    """``with OpRecorder() as rec: ...``: ``rec.ops`` lists an
    :class:`AtenOp` per tensor output of every aten op issued inside."""

    def __init__(self):
        super().__init__()
        self.ops: List[AtenOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = tuple(_name(a.dtype) for a in tree_leaves((args, kwargs))
                    if isinstance(a, torch.Tensor))
        returns = func._schema.returns
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        for i, o in enumerate(outs):
            alias = returns[min(i, len(returns) - 1)].alias_info \
                if returns else None
            self.ops.append(AtenOp(str(func), ins, _name(o.dtype),
                                   tuple(int(s) for s in o.shape),
                                   alias is not None))
        return out
