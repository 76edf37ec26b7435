"""Per-agent heterogeneous environments.

Counterpart of ``repro/rl/envs/heterogeneous.py``.  A
``HeterogeneousEnv`` carries a prototype env and per-agent stacks of the
fields that differ.  The JAX package vmaps ``env.lane(params)`` over the
stacks; in the port the agent axis is the leading batch dimension, so
:meth:`HeterogeneousEnv.lanes` puts the stacks for agents ``[lo, hi)`` on
the prototype as ``(hi - lo, 1, ...)`` tensors that broadcast over an
``(agents, M)`` batch.  The env itself behaves as ``lanes()`` (the whole
fleet); the agent-streamed round takes ``lanes(lo, hi)`` per block.

Several same-shape fleets batch as sweep lanes: ``_pack_hetero`` stacks
each fleet's per-agent fields as ``pa.<field>`` of shape ``(L, N, ...)``,
and ``_build_hetero`` puts them on the base as ``(L, N, 1, ...)`` fields
(``(N, 1, ...)`` for one lane, :meth:`HeterogeneousEnv.lanes`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.rl.envs.registry import (
    default_policy as _default_policy, env_kind, is_float_field,
    register_env, robust_eq,
)


@dataclass(frozen=True, eq=False)
class HeterogeneousEnv:
    """A fleet of same-family envs: ``base`` + per-agent field stacks
    (``params[name]`` has a leading ``(n_agents,)`` axis).  Build with
    :func:`make_heterogeneous_env`."""

    base: Any
    params: Dict[str, torch.Tensor]
    n_agents: int

    def lanes(self, lo: int = 0, hi: Optional[int] = None) -> Any:
        """The prototype with agents ``[lo, hi)``'s stacks as
        ``(hi - lo, 1, ...)`` fields."""
        hi = self.n_agents if hi is None else hi
        return dataclasses.replace(self.base, **{
            k: v[lo:hi].reshape((hi - lo, 1) + tuple(v.shape[1:]))
            for k, v in self.params.items()})

    def member(self, i: int) -> Any:
        """Agent ``i``'s own env (scalars as Python floats)."""
        return dataclasses.replace(self.base, **{
            k: (float(v[i]) if v[i].ndim == 0 else v[i])
            for k, v in self.params.items()})

    def to(self, device) -> "HeterogeneousEnv":
        base = self.base.to(device) if hasattr(self.base, "to") else self.base
        return dataclasses.replace(
            self, base=base,
            params={k: v.to(device) for k, v in self.params.items()})

    def kind_tag(self) -> str:
        return f"hetero:{env_kind(self.base)}:{self.n_agents}"

    @property
    def obs_dim(self) -> int:
        return self.base.obs_dim   # one shared policy across the fleet

    def default_policy(self):
        return _default_policy(self.base)

    def reset(self, generator, shape, device, noise=None):
        return self.lanes().reset(generator, shape, device, noise)

    def step_noise(self, generator, shape, device):
        return self.lanes().step_noise(generator, shape, device)

    def step(self, state, action, noise=None):
        return self.lanes().step(state, action, noise)


def make_heterogeneous_env(envs: Sequence[Any]) -> HeterogeneousEnv:
    """Stack a list of same-type envs (one per agent).  Declared-float
    fields that differ become per-agent float32 stacks; tensor fields
    (``TabularMDP``'s tables) stack when any member differs; fields that
    agree stay on the prototype; other fields must agree (structural)."""
    if not envs:
        raise ValueError("empty env list")
    base = envs[0]
    types = {type(e) for e in envs}
    if len(types) != 1:
        raise ValueError(
            f"heterogeneous agents must share one env family, got "
            f"{sorted(t.__name__ for t in types)}")
    params: Dict[str, torch.Tensor] = {}
    for f in dataclasses.fields(base):
        vals = [getattr(e, f.name) for e in envs]
        if is_float_field(f):
            if any(float(v) != float(vals[0]) for v in vals):
                params[f.name] = torch.tensor([float(v) for v in vals],
                                              dtype=torch.float32)
        elif isinstance(vals[0], torch.Tensor):
            if not all(torch.equal(v, vals[0]) for v in vals[1:]):
                params[f.name] = torch.stack(vals)
        elif any(v != vals[0] for v in vals[1:]):
            raise ValueError(
                f"non-float field {f.name!r} varies across agents; such "
                "fields are structural and cannot differ within one fleet")
    return HeterogeneousEnv(base=base, params=params, n_agents=len(envs))


def check_agent_count(env: Any, n_agents: int) -> None:
    """A ``HeterogeneousEnv`` built for another fleet size than the run's
    raises."""
    if isinstance(env, HeterogeneousEnv) and env.n_agents != n_agents:
        raise ValueError(
            f"HeterogeneousEnv carries per-agent params for n_agents="
            f"{env.n_agents} but the scenario runs {n_agents} agents; "
            f"rebuild it with one member env per agent")


def block_env(env: Any, lo: int, hi: int) -> Any:
    """The env of agents ``[lo, hi)``: their lanes of a fleet, else ``env``."""
    return env.lanes(lo, hi) if isinstance(env, HeterogeneousEnv) else env


def _pack_hetero(envs: Sequence[HeterogeneousEnv]) -> Dict[str, np.ndarray]:
    """Lane packer: each fleet's per-agent stacks as ``pa.<field>`` of
    shape ``(L, N, ...)``.  The fleets must stack the same fields and agree
    on every other base field."""
    keys = {tuple(sorted(e.params)) for e in envs}
    if len(keys) != 1:
        raise ValueError(
            f"cannot batch HeterogeneousEnv fleets stacking different "
            f"fields {sorted(keys)}; stack the same per-agent fields in "
            "every fleet (constant members are fine)")
    base = envs[0].base
    stacked = dict.fromkeys(envs[0].params)

    def neutral(e: HeterogeneousEnv) -> Any:
        # stacked fields never reach a round from the base: pin them to
        # fleet 0's values so only the shared fields compare
        return dataclasses.replace(
            e.base, **{k: getattr(base, k) for k in stacked})

    if not all(robust_eq(neutral(e), base) for e in envs[1:]):
        raise ValueError(
            "cannot batch HeterogeneousEnv fleets whose bases differ in a "
            "non-stacked field in one partition; for tensor-valued bases "
            "reuse one base instance across fleets")
    # the sweep lays its lanes out on the host, once a partition
    return {f"pa.{k}": np.stack([
        e.params[k].detach().cpu().double().numpy()  # repro: noqa[host-sync,numpy-on-device] packing
        for e in envs]) for k in envs[0].params}


def _build_hetero(kind: str, proto: HeterogeneousEnv,
                  params: Dict[str, Any], lanes: bool):
    del kind
    base = proto.base

    def field(v: torch.Tensor) -> torch.Tensor:
        head = 2 if lanes else 1            # (L, N) or (N,)
        return v.reshape(tuple(v.shape[:head]) + (1,)
                         + tuple(v.shape[head:]))

    if hasattr(base, "to"):
        base = base.to(next(iter(params.values())).device)
    return dataclasses.replace(base, **{k[len("pa."):]: field(v)
                                        for k, v in params.items()})


register_env("hetero", HeterogeneousEnv, packer=_pack_hetero,
             builder=_build_hetero)
