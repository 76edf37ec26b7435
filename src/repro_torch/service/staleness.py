"""Bounded stale-gradient replay buffer of the round service.

Counterpart of ``repro/service/staleness.py``.  When an agent misses a
round the server may replay its last contributed gradient, kept in an
``(N, ...)`` buffer indexed by ABSOLUTE agent id, with the weight
``decay ** (age - 1)`` while the copy is at most ``max_age`` rounds old.
Replayed terms are server memory: they enter the update after the uplink
(no gain, no noise), normalised by the same contribution weight ``W`` as
the fresh participants (``service.participation``).

Ages: entering round k, ``age[i]`` is the number of rounds since agent i
last contributed (1: last round; ``AGE_NEVER``: never, its row is zeros and
never replays).  After the round participants reset to 1, everyone else
ages by one (saturating).  Weights and statistics come from the ``(N,)``
mask and age vectors before any block loop, so the streamed round is the
same for every block size.  The buffer is O(N x d) by design.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.service.participation import safe_inv
from repro_torch.utils.tree import Params

__all__ = ["AGE_NEVER", "StaleState", "StalenessConfig", "advance",
           "init_state", "normalize", "replay_sum_stacked",
           "replay_weights", "stats"]

AGE_NEVER = 2 ** 30   # "never contributed", and the age cap (int32-safe)


@dataclass(frozen=True)
class StalenessConfig:
    """Replay policy; ``max_age=0`` turns replay off."""

    max_age: int = 0         # replay copies at most this many rounds old
    decay: float = 1.0       # weight decay ** (age - 1)

    def __post_init__(self):
        if self.max_age < 0:
            raise ValueError("max_age must be >= 0")
        if not 0.0 <= self.decay <= 1.0:
            raise ValueError("decay must be in [0, 1]")


def normalize(staleness: Optional[StalenessConfig],
              participation=None) -> Optional[StalenessConfig]:
    """``max_age=0``, or staleness without active participation (nobody
    ever misses a round), is staleness-off."""
    if staleness is None or staleness.max_age < 1 or participation is None:
        return None
    return staleness


class StaleState(NamedTuple):
    """The ``(N, ...)`` last contributions and the ``(N,)`` int32 ages."""

    grads: Params
    age: torch.Tensor


def init_state(scfg: StalenessConfig, theta: Params,
               n_agents: int) -> StaleState:
    grads = {k: torch.zeros((n_agents,) + tuple(v.shape), dtype=v.dtype,
                            device=v.device) for k, v in theta.items()}
    dev = next(iter(theta.values())).device
    return StaleState(grads=grads, age=torch.full(
        (n_agents,), AGE_NEVER, dtype=torch.int32, device=dev))


def replay_weights(scfg: StalenessConfig, mask: torch.Tensor,
                   age: torch.Tensor) -> torch.Tensor:
    """(N,) float32 replay weights: zero for participants, copies older
    than ``max_age`` and rows never contributed, else
    ``decay ** (age - 1)``."""
    replay = ~mask & (age >= 1) & (age <= scfg.max_age)
    a = torch.clamp(age, 1, scfg.max_age).float()
    w = torch.pow(torch.full_like(a, scfg.decay), a - 1.0)
    return torch.where(replay, w, torch.zeros_like(w))


def advance(scfg: StalenessConfig, state: StaleState, mask: torch.Tensor,
            fresh_grads: Params) -> StaleState:
    """After the round: participants' rows take their fresh gradient at
    age 1, the others age by one round."""
    keep = {k: torch.where(mask.reshape((-1,) + (1,) * (g.ndim - 1)), g,
                           state.grads[k]) for k, g in fresh_grads.items()}
    return StaleState(grads=keep, age=next_age(state.age, mask))


def next_age(age: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1 for participants, one more (saturating at ``AGE_NEVER``) for the
    rest."""
    return torch.where(mask, torch.ones_like(age),
                       torch.clamp(age + 1, max=AGE_NEVER))


def replay_sum_stacked(state: StaleState, weights: torch.Tensor) -> Params:
    """``sum_i w_i S_i`` over the buffer (the stacked round's batched sum)."""
    return {k: torch.sum(weights.reshape((-1,) + (1,) * (s.ndim - 1))
                         .to(s.dtype) * s, dim=0)
            for k, s in state.grads.items()}


def stats(scfg: StalenessConfig, mask: torch.Tensor,
          age: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(total replay weight, replayed count, mean replayed age), from the
    ``(N,)`` vectors alone."""
    w = replay_weights(scfg, mask, age)
    replayed = w > 0
    cnt = torch.sum(replayed.float())
    mean_age = torch.sum(torch.where(replayed, age, 0).float()) \
        * safe_inv(cnt)
    return torch.sum(w), cnt, mean_age
