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


def fixed_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The sum over ``dim`` as a pairwise tree of elementwise adds whose
    shape depends on the length alone (element i meets element i + n//2;
    an odd last element is carried up a level).  No reduction kernel picks
    the order, so a slice's bits do not depend on how many slices share
    the call: a run's metrics are the same alone and as one lane of many
    (on the card a reduction kernel's order follows the whole shape)."""
    dim = dim % x.ndim
    if x.shape[dim] == 0:
        return torch.zeros(x.shape[:dim] + x.shape[dim + 1:], dtype=x.dtype,
                           device=x.device)
    while x.shape[dim] > 1:
        n = x.shape[dim]
        half = n // 2
        y = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
        x = torch.cat([y, x.narrow(dim, 2 * half, 1)], dim) if n % 2 else y
    return x.squeeze(dim)


def fixed_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x`` ``(..., K)`` and ``w`` ``(..., K, N)`` (batch
    dims broadcast): the K products of each output summed by
    :func:`fixed_sum`, elementwise ops only, so an output's bits do not
    depend on the batch shape or on whether ``w`` is shared or one per
    lane (a matrix-product kernel picks its order by the call's shape)."""
    return fixed_sum(x.unsqueeze(-1) * w, -2)


def fixed_mean(x: torch.Tensor, n_dims: int) -> torch.Tensor:
    """The mean over the last ``n_dims`` axes: :func:`fixed_sum` over them
    flattened, divided by their element count."""
    lead = x.shape[:x.ndim - n_dims]
    count = math.prod(x.shape[x.ndim - n_dims:])
    return fixed_sum(x.reshape(lead + (count,)), -1) / count


def leaf_sizes(tree: Params) -> List[int]:
    """Element counts of the leaves, in key order (the flat layout)."""
    return [tree[k].numel() for k in tree_keys(tree)]


def flat_norm_sq(flat: torch.Tensor, sizes: List[int]) -> torch.Tensor:
    """Squared norm of ``(..., P)`` flat parameter vectors: each leaf's
    slice summed by :func:`fixed_sum`, then the leaves added in key order
    (:func:`tree_global_norm_sq` on the flat layout, lane by lane)."""
    sq = torch.square(flat.float())
    total, off = None, 0
    for size in sizes:
        s = fixed_sum(sq[..., off:off + size], -1)
        total = s if total is None else total + s
        off += size
    return total


def tree_global_norm_sq(tree: Params) -> torch.Tensor:
    """sum of squared leaves in float32, leaf by leaf in key order, each
    leaf's squares summed by :func:`fixed_sum`."""
    total = None
    for k in tree_keys(tree):
        s = fixed_sum(torch.square(tree[k].float()).reshape(-1), -1)
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


# ---------------------------------------------------------------------------
# Nested trees (a model's parameters: dicts of dicts of tensors)
# ---------------------------------------------------------------------------

def flatten_paths(tree, prefix: str = "") -> Params:
    """A nested dict of tensors -> a flat dict keyed by ``/``-joined key
    paths, in ``jax.tree.flatten``'s leaf order (keys sorted at every
    level), so a flat vector built from it lines up with the JAX package's
    (``ota._flatten_params``)."""
    out: Params = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_paths(v, path + "/"))
        else:
            out[path] = v
    return out


def replace_paths(tree, values: Params, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[path]``
    (its :func:`flatten_paths` key): the inverse of that function."""
    return {k: (replace_paths(v, values, f"{prefix}{k}/")
                if isinstance(v, dict) else values[f"{prefix}{k}"])
            for k, v in tree.items()}


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, c):
    return tree_map(lambda x: x * c, tree)
