"""A small optimizer stack over dict-of-tensor parameters: sgd, momentum,
adam and adamw, with a cosine schedule.

Counterpart of ``repro/optim/optimizers.py``, with the same gradient-
transform interface:

    opt = adamw(schedule, b1=0.9, b2=0.95, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

States are plain values (a step count and dicts of float32 moments) that
mirror the parameter dict.  ``update`` returns new dicts and never writes its
inputs.  Scalars enter the arithmetic as float32, in the JAX package's op
order, so the trajectories agree with it to float32 rounding.  K1's ``adam``
mode (``fused_aggregate_adam``) computes the update of :func:`adam` fused
into the uplink.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.utils.tree import Params, tree_global_norm_sq, tree_keys

Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]


class OptState(NamedTuple):
    step: torch.Tensor               # int32 scalar
    mu: Optional[Params] = None      # first moment (momentum / adam)
    nu: Optional[Params] = None      # second moment (adam)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[..., Tuple[Params, OptState]]


def _lr_at(lr: ScalarOrSchedule, step: torch.Tensor) -> torch.Tensor:
    return lr(step) if callable(lr) else torch.tensor(
        lr, dtype=torch.float32, device=step.device)


def _step0(params: Params) -> torch.Tensor:
    dev = params[tree_keys(params)[0]].device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros_f32(params: Params) -> Params:
    return {k: torch.zeros_like(v, dtype=torch.float32)
            for k, v in params.items()}


def sgd(lr: ScalarOrSchedule) -> Optimizer:
    def init(params):
        return OptState(step=_step0(params))

    def update(grads, state, params=None):
        del params
        step = state.step + 1
        a = _lr_at(lr, step)
        upd = {k: (-a * g.float()).to(g.dtype) for k, g in grads.items()}
        return upd, OptState(step=step)

    return Optimizer(init=init, update=update)


def momentum(lr: ScalarOrSchedule, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return OptState(step=_step0(params), mu=_zeros_f32(params))

    def update(grads, state, params=None):
        del params
        step = state.step + 1
        a = _lr_at(lr, step)
        mu = {k: beta * state.mu[k] + g.float() for k, g in grads.items()}
        if nesterov:
            upd = {k: (-a * (beta * mu[k] + g.float())).to(g.dtype)
                   for k, g in grads.items()}
        else:
            upd = {k: (-a * mu[k]).to(g.dtype) for k, g in grads.items()}
        return upd, OptState(step=step, mu=mu)

    return Optimizer(init=init, update=update)


def _adam_core(lr: ScalarOrSchedule, b1: float, b2: float, eps: float,
               weight_decay: float) -> Optimizer:
    def init(params):
        return OptState(step=_step0(params), mu=_zeros_f32(params),
                        nu=_zeros_f32(params))

    def update(grads, state, params=None):
        if weight_decay and params is None:
            raise ValueError("adamw.update needs params for weight decay")
        step = state.step + 1
        a = _lr_at(lr, step)
        t = step.float()
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float()
              for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.float())
              for k, g in grads.items()}
        upd = {}
        for k, g in grads.items():
            u = -(a * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
            if weight_decay:
                u = u - a * weight_decay * params[k].float()
            upd[k] = u.to(g.dtype)
        return upd, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def adam(lr: ScalarOrSchedule, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0)


def adamw(lr: ScalarOrSchedule, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p.float() + updates[k].float()).to(p.dtype)
            for k, p in params.items()}


def clip_by_global_norm(grads: Params, max_norm: float, counted=None,
                        group=None) -> Tuple[Params, torch.Tensor]:
    """``grads`` scaled to a global norm of at most ``max_norm``, and the
    norm.  ``counted``/``group``: the mesh form of the norm, over a rank's
    shards (``utils.tree.tree_global_norm_sq``)."""
    norm = torch.sqrt(tree_global_norm_sq(grads, counted, group))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def cosine_schedule(base_lr: float, total_steps: int,
                    final_frac: float = 0.1) -> Schedule:
    def fn(step):
        frac = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        warm = base_lr * step.float() / max(warmup, 1)
        return torch.where(step <= warmup, warm, cos(step - warmup))

    return fn
