"""Parameter plans: one declaration tree -> tensors, abstract shapes, specs.

Counterpart of ``repro/models/param.py``: a ``ParamDecl`` names every
dimension of a weight with a logical axis, and :func:`init_params`
materialises a plan (nested dicts of decls) into nested dicts of tensors
with the same keys, shapes and per-leaf dtypes (norm scales and SSM scalars
stay float32).  The distributions are the JAX package's; the draws are not
(torch cannot replay threefry), so parity tests carry the JAX package's
parameters across with ``repro_torch.interop`` instead.

Sharding is a pure function of (plan, rules, mesh), as in the JAX package:
each logical axis maps to zero or more mesh axes, and a mapping whose
product does not divide the dimension is dropped (replicated).  A spec is a
:class:`P`, a tuple with one entry per dimension (a mesh axis name, a tuple
of them, or None; trailing Nones dropped), equal to JAX's ``PartitionSpec``
entry for entry.  ``spec_for`` takes any mesh with a ``.shape`` dict or a
``torch.distributed`` ``DeviceMesh``.  :class:`NamedSharding` turns a spec
into DTensor placements on a ``DeviceMesh`` (``Shard(i)`` on every mesh
axis that dimension ``i`` takes, in the spec's order; ``Replicate()``
elsewhere), and :func:`distribute_params` lays a parameter tree out as
DTensors, each rank keeping its own slice.  :func:`abstract_params` puts
every leaf on the ``meta`` device: shapes and dtypes, no storage.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_map

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


def abstract_params(plan: Plan, dtype="float32") -> Params:
    """Every leaf as an empty tensor on the ``meta`` device (JAX: a
    ``ShapeDtypeStruct``): its shape and dtype, no storage."""
    return map_plan(lambda d: torch.empty(
        d.shape, dtype=_dtype(d.dtype or dtype), device="meta"), plan)


# --------------------------------------------------------------------------
# Sharding rules
# --------------------------------------------------------------------------

Rules = Mapping[str, Tuple[str, ...]]   # logical axis -> mesh axes


class P(tuple):
    """A partition spec: one entry per tensor dimension (a mesh axis name,
    a tuple of names, or None), as JAX's ``PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a mesh with a ``.shape`` dict (JAX's, a fake
    one) or of a ``DeviceMesh`` (its ``mesh_dim_names``)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh_axis_size(shape: Mapping[str, int], names: Sequence[str]) -> int:
    n = 1
    for name in names:
        n *= shape[name]
    return n


def spec_for(d: ParamDecl, rules: Rules, mesh) -> P:
    """The spec of one decl under the rules, replicating any dimension
    whose size the product of its mesh axes does not divide, and never
    giving one mesh axis to two dimensions."""
    shape = mesh_shape(mesh)
    used: set = set()
    parts = []
    for dim, axis in zip(d.shape, d.axes):
        entry = None
        if axis is not None and axis in rules:
            mesh_axes = tuple(a for a in rules[axis]
                              if a in shape and a not in used)
            if mesh_axes and dim % _mesh_axis_size(shape, mesh_axes) == 0:
                entry = mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
                used.update(mesh_axes)
        parts.append(entry)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def partition_specs(plan: Plan, rules: Rules, mesh):
    return map_plan(lambda d: spec_for(d, rules, mesh), plan)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``); ``placements`` are its
    DTensor placements, one per axis of the ``DeviceMesh``."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        where = {a: i for i, e in enumerate(self.spec)
                 for a in entry_axes(e)}
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in self.mesh.mesh_dim_names)


def named_shardings(plan: Plan, rules: Rules, mesh):
    return map_plan(lambda d: NamedSharding(mesh, spec_for(d, rules, mesh)),
                    plan)


def shard_block(shape: Sequence[int], spec: Sequence, mesh
                ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(offsets, local shape)`` of this rank's block of a tensor of
    ``shape`` under ``spec`` on the ``DeviceMesh`` (:func:`local_shard`'s
    slice)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_shape(mesh)
    offsets, local = [], []
    for dim, size in enumerate(shape):
        n, idx = 1, 0
        for a in entry_axes(spec[dim] if dim < len(spec) else None):
            n, idx = n * sizes[a], idx * sizes[a] + coord[a]
        offsets.append(idx * (size // n))
        local.append(size // n)
    return tuple(offsets), tuple(local)


def held_once(spec: Sequence, mesh) -> bool:
    """Whether this rank is the one that counts its block of a tensor laid
    out by ``spec`` in a sum over the mesh (a global norm): its index is 0
    on every mesh axis the spec does not shard over, so each distinct
    block is counted once however many ranks hold it."""
    used = {a for e in spec for a in entry_axes(e)}
    return all(c == 0 for a, c in zip(mesh.mesh_dim_names,
                                      mesh.get_coordinate())
               if a not in used)


def local_shard(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's slice of ``t`` (the same whole tensor on every rank)
    under ``spec`` on the ``DeviceMesh``: each sharded dimension cut into
    equal blocks over its mesh axes, the first axis the outer one.  A
    tensor that no axis splits is returned as it is (no copy)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_shape(mesh)
    out = t
    for dim, entry in enumerate(spec):
        n, idx = 1, 0
        for a in entry_axes(entry):
            n, idx = n * sizes[a], idx * sizes[a] + coord[a]
        if n > 1:
            out = out.narrow(dim, idx * (t.shape[dim] // n),
                             t.shape[dim] // n)
    return out if out is t else out.contiguous()


def distribute_tensor(t: torch.Tensor, sharding: NamedSharding):
    """A DTensor of ``t`` (the same whole tensor on every rank) under
    ``sharding``: each rank keeps its slice, with no communication."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_shard(t, sharding.spec, sharding.mesh),
                              sharding.mesh, sharding.placements,
                              run_check=False)


def distribute_params(params: Params, plan: Plan, rules: Rules, mesh):
    """The parameter tree as DTensors on the ``DeviceMesh`` per the rules
    (every rank passes the same whole parameters; each keeps its slice)."""
    if isinstance(plan, ParamDecl):
        return distribute_tensor(params, NamedSharding(
            mesh, spec_for(plan, rules, mesh)))
    return {k: distribute_params(params[k], v, rules, mesh)
            for k, v in plan.items()}


def distribute_flat(flat: Mapping[str, torch.Tensor], plan: Plan,
                    rules: Rules, mesh) -> Dict[str, Any]:
    """A flat dict keyed by parameter path (the optimizer's moments,
    ``utils.tree.flatten_paths``) as DTensors laid out as the parameters
    at those paths."""
    from repro_torch.utils.tree import flatten_paths

    decls = flatten_paths(plan)
    return {k: distribute_tensor(v, NamedSharding(
        mesh, spec_for(decls[k], rules, mesh))) for k, v in flat.items()}


def local_params(params: Params) -> Params:
    """A tree of DTensors (or tensors) -> this rank's plain tensors."""
    return tree_map(lambda x: x.to_local() if hasattr(x, "to_local") else x,
                    params)


# Canonical rule sets.  'data' axes shard FSDP-style (ZeRO-3) in training;
# serving keeps weights replicated across 'data' so decode needs no gathers.
def train_rules(fsdp: bool = True) -> Dict[str, Tuple[str, ...]]:
    r = serve_rules()
    if fsdp:
        r["d_model"] = ("data",)
    return r


def serve_rules() -> Dict[str, Tuple[str, ...]]:
    return {axis: ("model",) for axis in (
        "d_ff", "heads", "kv_heads", "vocab", "experts", "d_inner",
        "ssm_heads")}
