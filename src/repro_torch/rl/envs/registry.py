"""Environment registry: families by name.

Counterpart of ``repro/rl/envs/registry.py``: ``register_env``,
``registered_envs``, ``env_kind`` (a class may refine its tag with
``kind_tag()``, e.g. ``CliffWalk -> 'cliffwalk:6x4'``), ``make_env`` and
``default_policy``.  The sweep-lane packers and builders
(``batched_env_arrays``, ``build_lane_env`` and the family ``_pack_*`` /
``_build_*`` hooks) serve the scenario-sweep engine and come with its
slice; ``register_env`` takes no hooks until then.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.rl.env import LandmarkNav

_REGISTRY: Dict[str, type] = {}


def register_env(name: str, cls: type) -> None:
    """Add an environment family to the registry."""
    _REGISTRY[name] = cls


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


register_env("landmark", LandmarkNav)
