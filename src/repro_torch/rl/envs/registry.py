"""Environment registry: families by name.

Counterpart of ``repro/rl/envs/registry.py``: ``register_env``,
``registered_envs``, ``env_kind`` (a class may refine its tag with
``kind_tag()``, e.g. ``CliffWalk -> 'cliffwalk:6x4'``), ``make_env`` and
``default_policy``, with the scenario-sweep engine's lane hooks:

* ``batched_env_arrays(envs)`` stacks a same-kind env list into float64
  arrays with a leading lane axis.  The default packer stacks only the
  declared-float fields that vary (a constant field stays the Python float
  the per-scenario run uses) and refuses a varying non-float field, which
  is structural and belongs in the kind tag.  Families with array-valued
  parameters register a ``packer`` (``tabular``, ``hetero``).
* ``build_lane_env(kind, proto, params, lanes=True)`` rebuilds the env
  from the packed arrays (as tensors on the run's device).  With ``lanes``
  each field gets the shape that broadcasts over an ``(L, N, M)`` batch,
  ``(L, 1, 1, ...)``; without, ``params`` is one lane's slice and the
  fields broadcast over ``(N, M)``.  The default builder replaces the
  fields on the prototype, whose methods then run the concrete instance's
  ops, so a lane's rollouts are bitwise the per-scenario run's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.rl.env import LandmarkNav

_REGISTRY: Dict[str, type] = {}
_PACKERS: Dict[str, Callable[..., Dict[str, np.ndarray]]] = {}
_BUILDERS: Dict[str, Callable[..., Any]] = {}

BATCH_DIMS = 2   # the (N, M) batch of a round the lane fields broadcast over


def register_env(name: str, cls: type, *,
                 packer: Callable[..., Dict[str, np.ndarray]] = None,
                 builder: Callable[..., Any] = None) -> None:
    """Add an environment family to the registry; ``packer``/``builder``
    are its lane hooks when its fields are not all plain floats (hooks are
    keyed by the root of the kind tag)."""
    _REGISTRY[name] = cls
    if packer is not None:
        _PACKERS[name] = packer
    if builder is not None:
        _BUILDERS[name] = builder


def registered_envs() -> Dict[str, type]:
    """Snapshot of the registry: family name -> class."""
    return dict(_REGISTRY)


def env_kind(env: Any) -> str:
    """Reverse lookup, ``LandmarkNav() -> 'landmark'``, refined by the
    class's ``kind_tag()`` where it has one."""
    for name, cls in _REGISTRY.items():
        if type(env) is cls:
            tag = getattr(env, "kind_tag", None)
            return tag() if callable(tag) else name
    raise ValueError(f"environment {type(env).__name__} is not in the registry")


def make_env(name: str, **kwargs) -> Any:
    """Factory: ``make_env('landmark')``, ``make_env('cliffwalk', width=5)``."""
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError as e:
        raise ValueError(
            f"unknown environment {name!r}; choose from {sorted(_REGISTRY)}"
        ) from e


def default_policy(env: Any):
    """A policy compatible with ``env`` (the env's ``default_policy`` hook)."""
    hook = getattr(env, "default_policy", None)
    if callable(hook):
        return hook()
    raise ValueError(f"environment {type(env).__name__} exposes no "
                     "default_policy(); pass an explicit policy")


def is_float_field(f: dataclasses.Field) -> bool:
    """Whether a dataclass field is declared float (a per-agent value in a
    heterogeneous fleet); annotations may be strings."""
    return f.type is float or f.type == "float"


def values_vary(vals: Sequence[Any]) -> bool:
    """Whether the values differ; unhashable values (envs carrying
    tensors) compare by identity, so reuse ONE instance for a value that
    must read as constant."""
    try:
        return len(set(vals)) > 1
    except TypeError:
        return any(v is not vals[0] for v in vals[1:])


def robust_eq(a: Any, b: Any) -> bool:
    """``a == b``, with an ambiguous comparison (tensor-valued fields)
    read as unequal instead of raising."""
    if a is b:
        return True
    try:
        return bool(a == b)
    except (TypeError, ValueError, RuntimeError):
        return False


def batched_env_arrays(envs: Sequence[Any]
                       ) -> Tuple[str, Dict[str, np.ndarray]]:
    """Stack a same-kind env list into float64 arrays with a leading
    ``len(envs)`` axis: the varying declared-float fields (default packer),
    or the family's hook."""
    kinds = {env_kind(e) for e in envs}
    if len(kinds) != 1:
        raise ValueError(f"cannot batch across env kinds {sorted(kinds)}")
    kind = kinds.pop()
    root = kind.split(":", 1)[0]
    if root in _PACKERS:
        return kind, _PACKERS[root](envs)
    params: Dict[str, np.ndarray] = {}
    for f in dataclasses.fields(envs[0]):
        vals = [getattr(e, f.name) for e in envs]
        if is_float_field(f):
            if any(float(v) != float(vals[0]) for v in vals[1:]):
                params[f.name] = np.array([float(v) for v in vals],
                                          np.float64)
        elif values_vary(vals):
            raise ValueError(
                f"env kind {kind!r} varies non-float field {f.name!r} inside "
                "one sweep partition; such fields are structural and must be "
                "encoded in the family's kind_tag()")
    return kind, params


def lane_field(v: torch.Tensor, lanes: bool, rest: int = 0) -> torch.Tensor:
    """A packed field as a factor of the round's batch: ``(L, *R)`` ->
    ``(L, 1, 1, *R)`` with ``lanes``, one lane's ``(*R)`` -> ``(1, 1, *R)``
    without (``rest`` = ``len(R)``)."""
    tail = tuple(v.shape[v.ndim - rest:]) if rest else ()
    head = (v.shape[0],) if lanes else ()
    return v.reshape(head + (1,) * BATCH_DIMS + tail)


def build_lane_env(kind: str, proto: Any, params: Dict[str, torch.Tensor],
                   lanes: bool = True) -> Any:
    """The env of packed ``params`` (tensors on the run's device): every
    lane's with ``lanes``, one lane's without (module docstring)."""
    root = kind.split(":", 1)[0]
    if root in _BUILDERS:
        return _BUILDERS[root](kind, proto, params, lanes)
    return dataclasses.replace(proto, **{k: lane_field(v, lanes)
                                         for k, v in params.items()})


register_env("landmark", LandmarkNav)
