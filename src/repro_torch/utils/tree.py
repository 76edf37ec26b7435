"""Helpers over dict-of-tensor parameters (the port's pytrees).

Counterpart of ``repro/utils/tree.py`` and of the flatten helpers in
``repro/core/ota.py`` (``_flatten_agent_stack``, ``_flatten_params``).  The
leaf order is the sorted dict-key order, as ``jax.tree.flatten`` gives it
(``b1, b2, w1, w2`` for ``MLPPolicy``), so a flat vector here lines up
element for element with the JAX package's.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

Params = Dict[str, torch.Tensor]


def tree_keys(tree: Params) -> List[str]:
    """Leaf order: sorted keys, as JAX flattens a dict."""
    return sorted(tree)


def theta_device(tree: Params) -> torch.device:
    """The device the parameters live on (that of the first leaf)."""
    return tree[tree_keys(tree)[0]].device


def tree_global_norm_sq(tree: Params) -> torch.Tensor:
    """sum of squared leaves in float32, leaf by leaf in key order."""
    total = None
    for k in tree_keys(tree):
        s = torch.sum(torch.square(tree[k].float()))
        total = s if total is None else total + s
    return total


def tree_global_norm(tree: Params) -> torch.Tensor:
    """sqrt(sum of squared leaves): the norm of the paper's analysis."""
    return torch.sqrt(tree_global_norm_sq(tree))


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 2 ** math.ceil(math.log2(x))


def _unflattener(keys: List[str], shapes: List[torch.Size],
                 dtypes: List[torch.dtype]) -> Callable[[torch.Tensor], Params]:
    sizes = [math.prod(s) for s in shapes]

    def unflatten(vec: torch.Tensor) -> Params:
        out, off = {}, 0
        for k, shape, size, dt in zip(keys, shapes, sizes, dtypes):
            out[k] = vec[off:off + size].reshape(shape).to(dt)
            off += size
        return out

    return unflatten


def flatten_agent_stack(
    stack: Params,
) -> Tuple[torch.Tensor, int, Callable[[torch.Tensor], Params]]:
    """dict of (N, ...) leaves -> ((N, P) float32, N, unflatten), where
    ``unflatten`` maps a (P,) vector back to one agent's dict."""
    keys = tree_keys(stack)
    n = stack[keys[0]].shape[0]
    flat = torch.cat([stack[k].reshape(n, -1).float() for k in keys], dim=1)
    unflatten = _unflattener(keys, [stack[k].shape[1:] for k in keys],
                             [stack[k].dtype for k in keys])
    return flat, n, unflatten


def flatten_params(params: Params) -> Tuple[torch.Tensor,
                                            Callable[[torch.Tensor], Params]]:
    """dict of leaves -> ((P,) float32, unflatten)."""
    keys = tree_keys(params)
    flat = torch.cat([params[k].reshape(-1).float() for k in keys])
    unflatten = _unflattener(keys, [params[k].shape for k in keys],
                             [params[k].dtype for k in keys])
    return flat, unflatten
