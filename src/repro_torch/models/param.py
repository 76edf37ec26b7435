"""Parameter plans: one declaration tree -> initialised tensors.

Counterpart of ``repro/models/param.py`` without sharding: a ``ParamDecl``
names every dimension of a weight with a logical axis, and
:func:`init_params` materialises a plan (nested dicts of decls) into nested
dicts of tensors with the same keys, shapes and per-leaf dtypes (norm scales
and SSM scalars stay float32).  The distributions are the JAX package's;
the draws are not (torch cannot replay threefry), so parity tests carry the
JAX package's parameters across with ``repro_torch.interop`` instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch.utils.device import DeviceLike, resolve_device

Plan = Any      # nested dicts whose leaves are ParamDecl
Params = Any    # the same nesting, leaves torch.Tensor


@dataclass(frozen=True)
class ParamDecl:
    """Declaration of one weight tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis per dim
    init: str = "normal"                 # normal | zeros | ones | uniform | dt_bias | a_log
    scale: Optional[float] = None        # stddev; None -> 1/sqrt(fan_in)
    fan_in_axes: Tuple[int, ...] = (0,)  # dims counted as fan-in
    dtype: Optional[str] = None          # override the model dtype (fp32 norms)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")

    def stddev(self) -> float:
        if self.scale is not None:
            return self.scale
        fan_in = 1
        for a in self.fan_in_axes:
            fan_in *= self.shape[a]
        return 1.0 / math.sqrt(max(fan_in, 1))


def decl(shape, axes, **kw) -> ParamDecl:
    return ParamDecl(tuple(shape), tuple(axes), **kw)


def map_plan(fn, plan: Plan):
    """Apply ``fn`` to every ``ParamDecl`` leaf, keeping the nesting."""
    if isinstance(plan, ParamDecl):
        return fn(plan)
    return {k: map_plan(fn, v) for k, v in plan.items()}


def stack_plan(plan: Plan, n: int, axis_name: str = "layers") -> Plan:
    """Prepend a stacked-layer dimension to every decl."""

    def _stack(d: ParamDecl) -> ParamDecl:
        return ParamDecl(shape=(n,) + d.shape, axes=(axis_name,) + d.axes,
                         init=d.init, scale=d.scale,
                         fan_in_axes=tuple(a + 1 for a in d.fan_in_axes),
                         dtype=d.dtype)

    return map_plan(_stack, plan)


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so two spellings of one device are
    equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def init_params(plan: Plan, dtype="float32", *, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Materialise a plan: every leaf drawn in float32 on ``device`` from
    ``generator`` (a generator of that device), then cast to its dtype.
    ``device`` None means cuda; a generator of another device raises."""
    dev = resolve_device(device)
    if _indexed(generator.device) != _indexed(dev):
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"parameters go to {dev}: pass a generator of "
                         f"that device")
    f32 = dict(dtype=torch.float32, device=dev, generator=generator)

    def uniform(shape, lo, hi):
        return torch.rand(shape, **f32) * (hi - lo) + lo

    def one(d: ParamDecl) -> torch.Tensor:
        dt = _dtype(d.dtype or dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        if d.init == "uniform":
            s = d.stddev()
            x = uniform(d.shape, -s, s)
        elif d.init == "dt_bias":
            # mamba2 dt bias: softplus^-1 of dt ~ U[dt_min, dt_max]
            x = torch.log(torch.expm1(uniform(d.shape, 1e-3, 1e-1)))
        elif d.init == "a_log":
            # mamba2 A_log: A ~ U[1, 16], stored as log
            x = torch.log(uniform(d.shape, 1.0, 16.0))
        elif d.init == "normal":
            x = torch.randn(d.shape, **f32) * d.stddev()
        else:
            raise ValueError(f"unknown init {d.init!r}")
        return x.to(dt)

    return map_plan(one, plan)


def param_count(params: Params) -> int:
    """Number of scalars in a nested dict of tensors."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(param_count(v) for v in params.values())
