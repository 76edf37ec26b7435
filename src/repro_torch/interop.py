"""Carry weights and caches between the JAX package's layout and the port's
tensors.

The JAX package keeps parameters as (nested) dicts of arrays; handed over
as numpy (``jax.tree.map(np.asarray, params)``) they become the port's
dicts of tensors on a chosen device with every shape kept as it is — ``w1``
stays ``(obs_dim, hidden)`` and ``wq`` stays ``(d, h, dh)``, not
``nn.Linear``'s transpose — so both packages compute on the same layout.

* :func:`from_numpy` / :func:`to_numpy`: a flat dict, float32 (the policy
  parameters of the RL path: ``MLPPolicy``'s ``w1 b1 w2 b2``,
  ``TabularSoftmaxPolicy``'s ``theta``, ``GaussianPolicy``'s ``w b
  log_std``).
* :func:`env_from_jax`: one of the JAX package's zoo environments as the
  port's, matched by class name, array fields (``TabularMDP``'s tables, a
  ``HeterogeneousEnv``'s per-agent stacks) as float32 tensors.
* :func:`params_from_jax` / :func:`params_to_jax`: a nested dict, each leaf
  keeping its dtype.  bfloat16 leaves arrive as ``ml_dtypes.bfloat16``
  arrays and go through float32, which is exact both ways.
* :func:`cache_from_jax` / :func:`cache_to_numpy`: the model caches
  (``transformer.Cache`` with ``KVCache`` / ``SSMState`` fields and the
  ``cross_kv`` pair), matched by field name, so the JAX package's named
  tuples convert without importing it.
* :func:`train_state_from_jax`: the trainer's state (params, AdamW moments,
  steps), so both packages' train steps start from the same values.
* :func:`params_to_mesh`: the JAX package's parameters laid out as DTensors
  on a ``DeviceMesh`` per the sharding rules (each rank keeps its shards);
  :func:`cache_to_numpy` takes a sharded cache too (its DTensor fields
  gathered, a collective every rank joins).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device


def from_numpy(params: Mapping[str, np.ndarray],
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """numpy dict -> dict of float32 tensors on ``device`` (``None``: cuda)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in params.items()}


def to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse: dict of tensors (any device) -> dict of numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def env_from_jax(env: Any, device: DeviceLike = None) -> Any:
    """A JAX zoo environment (``LandmarkNav``, ``WindyLandmarkNav``,
    ``MultiLandmarkNav``, ``CliffWalk``, ``LQRTask``, ``TabularMDP``, or a
    ``HeterogeneousEnv`` over one of them) -> the port's, with the same
    field values; duck-typed, so this module imports nothing of JAX."""
    import dataclasses

    from repro_torch.rl.envs import HeterogeneousEnv, registered_envs

    dev = resolve_device(device)
    name = type(env).__name__
    if name == "HeterogeneousEnv":
        return HeterogeneousEnv(
            base=env_from_jax(env.base, dev),
            params={k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                    for k, v in env.params.items()},
            n_agents=int(env.n_agents))
    classes = {c.__name__: c for c in registered_envs().values()}
    if name not in classes:
        raise ValueError(f"no port of environment {name}")
    kwargs = {}
    for f in dataclasses.fields(env):
        v = getattr(env, f.name)
        if hasattr(v, "shape") and np.ndim(v) > 0:
            v = torch.from_numpy(np.array(v, np.float32)).to(dev)
        kwargs[f.name] = v
    return classes[name](**kwargs)


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def array_to_tensor(a, device: torch.device) -> torch.Tensor:
    """One numpy array (bf16 from ``ml_dtypes`` included) -> tensor of the
    same shape and dtype."""
    a = np.asarray(a)
    if _is_bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy; bfloat16 becomes ``ml_dtypes.bfloat16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the JAX package's numpy bf16 type

        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (``None``: cuda), shapes and dtypes kept."""
    dev = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return array_to_tensor(tree, dev)


def params_to_jax(tree: Any) -> Any:
    """The inverse: nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: params_to_jax(v) for k, v in tree.items()}
    return tensor_to_array(tree)


def cache_from_jax(cache: Any, device: DeviceLike = None):
    """The JAX package's ``Cache`` (leaves as numpy) -> the port's: the
    ``KVCache`` and ``SSMState`` fields (one or two leading axes) as named
    tuples of tensors, ``cross_kv`` as the same ``(k, v)`` pair."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMState
    from repro_torch.models.transformer import Cache

    dev = resolve_device(device)
    kinds = {"kv": KVCache, "groups_kv": KVCache, "cross_self_kv": KVCache,
             "ssm": SSMState, "groups_ssm": SSMState, "tail_ssm": SSMState,
             "cross_kv": lambda k, v: (k, v)}
    fields = {}
    for name, value in cache._asdict().items():
        if name == "pos":
            fields[name] = int(np.asarray(value))
        elif value is None:
            fields[name] = None
        else:
            fields[name] = kinds[name](*(array_to_tensor(v, dev)
                                         for v in value))
    return Cache(**fields)


def _cache_parts(value) -> Dict[str, Any]:
    """A cache field's parts by name: a named tuple's fields, a plain
    ``(k, v)`` pair's by position."""
    if hasattr(value, "_asdict"):
        return value._asdict()
    k, v = value
    return {"k": k, "v": v}


def params_to_mesh(tree: Any, plan: Any, rules: Any, mesh,
                   device: DeviceLike = None) -> Any:
    """Nested dict of numpy arrays (the same on every rank) -> DTensors on
    the ``DeviceMesh`` laid out per ``rules`` (``models.param``), each
    rank's slices on ``device``."""
    from repro_torch.models.param import distribute_params

    return distribute_params(params_from_jax(tree, device), plan, rules,
                             mesh)


def _whole(v):
    """A DTensor gathered to its whole tensor (a collective); else ``v``."""
    return v.full_tensor() if hasattr(v, "full_tensor") else v


def cache_to_numpy(cache: Any) -> Dict[str, Any]:
    """A cache (the port's or the JAX package's, leaves tensors or arrays;
    a sharded cache's DTensors gathered, so every rank of the mesh must
    call it) -> ``{field: {subfield: numpy array} | None, "pos": int}``,
    so two caches compare field by field (``cross_kv``'s parts as ``k``
    and ``v``).  The arrays are copies: decode's in-place KV writes leave
    them as they were."""
    out: Dict[str, Any] = {}
    for name, value in cache._asdict().items():
        if name == "pos":
            out[name] = int(np.asarray(value))
        elif value is None:
            out[name] = None
        else:
            out[name] = {k: np.array(tensor_to_array(_whole(v))
                                     if isinstance(v, torch.Tensor) else v)
                         for k, v in _cache_parts(value).items()}
    return out


def train_state_from_jax(state: Any, device: DeviceLike = None):
    """The JAX package's ``TrainState`` (params, an AdamW ``OptState`` with
    ``step``/``mu``/``nu``, ``step``; leaves jax or numpy arrays) -> the
    port's ``train.trainer.TrainState``: the params nested as they are, the
    moments flat by parameter path (``utils.tree.flatten_paths``), the
    optimizer step on ``device`` and the train step on the host."""
    from repro_torch.optim.optimizers import OptState
    from repro_torch.train.trainer import TrainState
    from repro_torch.utils.tree import flatten_paths

    dev = resolve_device(device)
    opt = state.opt_state

    def moments(tree):
        return None if tree is None else flatten_paths(
            params_from_jax(tree, dev))

    return TrainState(
        params=params_from_jax(state.params, dev),
        opt_state=OptState(
            step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                              device=dev),
            mu=moments(opt.mu), nu=moments(opt.nu)),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32))


def train_state_to_numpy(state: Any) -> Dict[str, Any]:
    """A port ``TrainState`` (a sharded one's DTensors gathered, so every
    rank of the mesh must call it) -> ``{"params": {path: array}, "mu":
    .., "nu": .., "step": int, "opt_step": int}``, the arrays copies in
    their tensors' dtypes (:func:`tensor_to_array`)."""
    from repro_torch.utils.tree import flatten_paths

    def arrays(flat):
        return {k: np.array(tensor_to_array(_whole(v)))
                for k, v in flat.items()}

    opt = state.opt_state
    return {"params": arrays(flatten_paths(state.params)),
            "mu": arrays(opt.mu), "nu": arrays(opt.nu),
            "step": int(state.step), "opt_step": int(opt.step)}
