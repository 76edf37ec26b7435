"""Dependency-free checkpointing of the port's trees.

Counterpart of ``repro/checkpoint/checkpoint.py``, in its file format, so a
checkpoint crosses between the two packages in either direction:

* ``step_<n>.npz`` holds every leaf under its ``/``-joined key path, written
  through a temp file and ``os.replace`` (a crash leaves the previous
  checkpoint, never half of this one);
* ``step_<n>.json`` is the manifest: ``step``, ``keys`` (sorted),
  ``dtypes`` and ``shapes``;
* a bfloat16 leaf is stored as its raw ``uint16`` bits under the dtype name
  ``"bfloat16"`` (``Tensor.view(torch.int16)``; numpy has no bf16 of its
  own, the JAX package uses ``ml_dtypes``).

The trees are the port's: dicts (key path part: the key), NamedTuples such
as ``OptState``, ``TrainState``, ``ServiceState``, ``StaleState`` (part:
the field name, as ``jax.tree_util`` names a ``GetAttrKey``), lists and
tuples (part: the index).  Leaves are tensors; a ``None`` is an empty
subtree, as in JAX.  ``restore`` rebuilds the structure of ``like`` and
puts each leaf on ``like``'s device with ``like``'s dtype.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Tree = Any

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")
_BF16 = "bfloat16"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Tree, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) in ``jax.tree_util``'s order: dict keys sorted,
    NamedTuple fields and sequence items in order; None contributes
    nothing."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(tree: Tree, values: Dict[str, Any],
             path: Tuple[str, ...] = ()) -> Tree:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, n), values, path + (n,))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, values, path + (str(i),))
                          for i, x in enumerate(tree))
    return values["/".join(path)]


def _to_storable(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array npz can hold, and its dtype name."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype_name: str,
                   like: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor on ``like``'s device with its dtype."""
    if dtype_name == _BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _atomic_write(directory: str, path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save(ckpt_dir: str, step: int, tree: Tree) -> str:
    """Write ``step_<step>.npz`` (atomically) and its manifest; returns the
    ``.npz`` path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    storable, dtypes, shapes = {}, {}, {}
    for key, leaf in _leaves(tree):
        storable[key], dtypes[key] = _to_storable(leaf)
        shapes[key] = list(storable[key].shape)
    manifest = {"step": int(step), "keys": sorted(storable),
                "dtypes": dtypes, "shapes": shapes}
    path = os.path.join(ckpt_dir, f"step_{int(step)}.npz")
    _atomic_write(ckpt_dir, path, lambda f: np.savez(f, **storable))
    _atomic_write(ckpt_dir, os.path.join(ckpt_dir, f"step_{int(step)}.json"),
                  lambda f: f.write(json.dumps(manifest).encode()))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest ``n`` with a ``step_<n>.npz`` in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Tree) -> Tree:
    """Load ``step_<step>.npz`` into the structure of ``like``.  Raises
    ``ValueError`` on a missing or extra key, or a shape that is not
    ``like``'s."""
    with open(os.path.join(ckpt_dir, f"step_{int(step)}.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, f"step_{int(step)}.npz")) as data:
        flat = {k: data[k] for k in data.files}
    ref = dict(_leaves(like))
    missing, extra = set(ref) - set(flat), set(flat) - set(ref)
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={missing} "
                         f"extra={extra}")
    values: Dict[str, Any] = {}
    for k, leaf in ref.items():
        if tuple(flat[k].shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {k}: ckpt "
                             f"{flat[k].shape} vs model {tuple(leaf.shape)}")
        values[k] = _from_storable(
            flat[k], manifest["dtypes"].get(k, str(flat[k].dtype)), leaf)
    return _rebuild(like, values)

