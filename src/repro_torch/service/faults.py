"""Declarative fault injection for the round service.

Counterpart of ``repro/service/faults.py``.  Three failure modes, composed
into one per-round availability mask that multiplies the participation mask
(``service.participation``):

* **Stragglers**: each agent draws an upload delay (exponential, or a
  Pareto/Lomax tail); the round commits with whoever made the deadline
  (``delay <= deadline``).
* **Crashes**: a ``frac`` of the agents follows a periodic crash/rejoin
  schedule, down for ``down`` out of every ``period`` rounds, each with its
  own phase.
* **Deadline**: ``math.inf`` never closes a round early.

The closed forms (``prob_within``, ``up_prob``, ``availability``) are the
JAX package's formulas in Python double.  The draws come from the
counter-hash stream of ``service.stream`` keyed on ``(seed, round, agent
id)``, not from threefry: the port's masks agree with the JAX package's in
distribution, and exactly when the JAX mask is injected
(``fedpg.RoundDraws.mask``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.service import stream

__all__ = ["CrashSchedule", "FaultConfig", "StragglerModel"]


@dataclass(frozen=True)
class StragglerModel:
    """Per-(round, agent) upload-delay distribution: ``"exp"`` draws
    ``Exp(mean)``; ``"pareto"`` a Lomax(shape) tail scaled to mean ``mean``
    (``shape > 1``).  Both are inverse-CDF transforms of one uniform."""

    dist: str = "exp"        # "exp" | "pareto"
    mean: float = 1.0        # mean delay (same unit as the deadline)
    shape: float = 2.5       # Lomax tail index (pareto only)

    def __post_init__(self):
        if self.dist not in ("exp", "pareto"):
            raise ValueError(f"unknown straggler dist {self.dist!r}")
        if self.mean <= 0:
            raise ValueError("straggler mean delay must be > 0")
        if self.dist == "pareto" and self.shape <= 1:
            raise ValueError("pareto straggler needs shape > 1 for a "
                             "finite mean delay")

    def _scale(self) -> float:
        return self.mean * (self.shape - 1.0)   # Lomax mean = scale/(shape-1)

    def delays(self, u: torch.Tensor) -> torch.Tensor:
        """Inverse-CDF transform of float32 uniforms ``u`` in [0, 1)."""
        if self.dist == "exp":
            return -self.mean * torch.log1p(-u)
        return self._scale() * (torch.pow(1.0 - u, -1.0 / self.shape) - 1.0)

    def prob_within(self, deadline: float) -> float:
        """Closed-form ``P(delay <= deadline)``."""
        if not math.isfinite(deadline):
            return 1.0
        if self.dist == "exp":
            return 1.0 - math.exp(-deadline / self.mean)
        return 1.0 - (1.0 + deadline / self._scale()) ** (-self.shape)


@dataclass(frozen=True)
class CrashSchedule:
    """Periodic crash/rejoin: a ``frac`` subset of agents is down for
    ``down`` out of every ``period`` rounds.  Which agents crash and their
    phase are round-independent draws, so an agent's outages are fixed for
    the whole run."""

    frac: float = 0.1        # fraction of the fleet that ever crashes
    period: int = 10         # schedule period in rounds
    down: int = 1            # rounds spent down per period

    def __post_init__(self):
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError("crash frac must be in [0, 1]")
        if self.period < 1 or not 0 <= self.down <= self.period:
            raise ValueError("need 0 <= down <= period and period >= 1")

    def up_mask(self, seed: stream.Seed, round_idx: int,
                agent_ids: torch.Tensor) -> torch.Tensor:
        """(len(agent_ids),) bool: True where the agent is up this round."""
        crashes = stream.agent_uniform(seed, 0, agent_ids,
                                       stream.SALT_CRASH) < self.frac
        phase = (stream.agent_bits(seed, 0, agent_ids, stream.SALT_PHASE)
                 * self.period) >> 24            # uniform in [0, period)
        in_outage = (round_idx + phase) % self.period < self.down
        return ~(crashes & in_outage)

    def up_prob(self) -> float:
        """Closed-form per-round ``P(agent is up)``."""
        return 1.0 - self.frac * (self.down / self.period)


@dataclass(frozen=True)
class FaultConfig:
    """Composed fault model for one service run.  ``deadline`` closes the
    round on the straggler delays; ``math.inf`` (the default) never does."""

    stragglers: Optional[StragglerModel] = None
    deadline: float = math.inf
    crashes: Optional[CrashSchedule] = None

    def __post_init__(self):
        if self.deadline < 0:
            raise ValueError("deadline must be >= 0")

    @property
    def active(self) -> bool:
        """Whether this config can ever drop an agent: stragglers need a
        finite deadline, crashes a positive fraction and outage."""
        straggle = self.stragglers is not None \
            and not math.isinf(self.deadline)
        crash = self.crashes is not None and self.crashes.frac > 0 \
            and self.crashes.down > 0
        return bool(straggle or crash)

    def availability(self) -> float:
        """Closed-form per-round ``P(agent contributes)`` (delays and crash
        schedules are independent): the factor the ``"expected"`` debias
        normaliser multiplies in."""
        p = 1.0
        if self.stragglers is not None:
            p *= self.stragglers.prob_within(float(self.deadline))
        if self.crashes is not None:
            p *= self.crashes.up_prob()
        return p

    def up_mask(self, seed: stream.Seed, round_idx: int,
                agent_ids: torch.Tensor) -> torch.Tensor:
        """(len(agent_ids),) bool availability this round: made the
        deadline AND not in a crash outage.  Delays are fresh each round;
        the crash schedule is fixed for the run."""
        up = torch.ones(agent_ids.shape, dtype=torch.bool,
                        device=agent_ids.device)
        if self.stragglers is not None:
            u = stream.agent_uniform(seed, round_idx, agent_ids,
                                     stream.SALT_DELAY)
            up = up & (self.stragglers.delays(u) <= self.deadline)
        if self.crashes is not None:
            up = up & self.crashes.up_mask(seed, round_idx, agent_ids)
        return up
