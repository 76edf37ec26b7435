"""Participation semantics of the round service.

Counterpart of ``repro/service/participation.py``.  Algorithm 2 assumes
every agent broadcasts in every round; the service relaxes that to a
per-round participation mask and renormalises the update:

* **Masks** come from the counter-hash stream of ``service.stream``, keyed
  on the run's seed, the round index and the ABSOLUTE agent id, so the mask
  of ``(round, agent)`` is the same for every ``agent_blocks``.
  ``kind="bernoulli"`` draws each agent with probability ``rate``;
  ``kind="subset"`` is the round-robin window of ``subset`` agents (no
  randomness, equal to the JAX package's mask); faults
  (``service.faults``) AND into either.
* **Normalisers**: with ``W`` the round's contribution weight
  (participating count plus any staleness replay weight) the service
  multiplies the full-fleet update by ``N / W``, so it is normalised by
  the realised participation (``debias="realized"``; an exact-zero update
  when nobody makes the round) or by the closed-form ``E[W]``
  (``debias="expected"``).

A config that can never drop an agent normalises to ``None`` and the round
is the plain round, bit for bit.  Not ported: ``scale_jaxpr``, a jaxpr hook
of the JAX package's static checker.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.service import stream
from repro_torch.service.faults import FaultConfig
from repro_torch.utils.tree import Params

__all__ = [
    "ParticipationConfig", "ServiceState", "expected_count", "init_state",
    "mask_agent_axis", "normalize", "participation_factor", "round_mask",
    "safe_inv",
]


@dataclass(frozen=True)
class ParticipationConfig:
    """The participation model of a service run."""

    kind: str = "bernoulli"      # "bernoulli" | "subset" | "full"
    rate: float = 1.0            # Bernoulli participation probability
    subset: int = 0              # round-robin window size (kind="subset")
    debias: str = "realized"     # "realized" | "expected"
    faults: Optional[FaultConfig] = None

    def __post_init__(self):
        if self.kind not in ("bernoulli", "subset", "full"):
            raise ValueError(f"unknown participation kind {self.kind!r}")
        if self.debias not in ("realized", "expected"):
            raise ValueError(f"unknown debias mode {self.debias!r}")
        if self.kind == "subset" and self.subset < 1:
            raise ValueError("kind='subset' needs subset >= 1")
        if self.kind == "bernoulli" and not 0.0 < self.rate <= 1.0:
            raise ValueError("bernoulli rate must be in (0, 1]")


class ServiceState(NamedTuple):
    """What a service round carries from one round to the next.
    ``round_idx`` is the absolute round counter (a resumed service replays
    the same masks); ``seed`` keys the counter-hash stream (an int64 0-dim
    tensor, drawn once from the run's generator: it takes the place of the
    JAX package's two keys); ``stale`` is the staleness buffer
    (:class:`repro_torch.service.staleness.StaleState`) or None."""

    theta: Params
    round_idx: int
    seed: torch.Tensor
    stale: Optional[Any] = None


def normalize(participation: Optional[ParticipationConfig],
              n_agents: int) -> Optional[ParticipationConfig]:
    """A config that can never drop an agent is participation-off."""
    p = participation
    if p is None:
        return None
    if p.faults is not None and p.faults.active:
        return p
    if p.kind == "full":
        return None
    if p.kind == "bernoulli" and p.rate >= 1.0:
        return None
    if p.kind == "subset" and p.subset >= n_agents:
        return None
    return p


def init_state(theta: Params, seed: torch.Tensor, n_agents: int,
               staleness=None) -> ServiceState:
    """The service state at round 0; ``staleness`` is a normalised
    :class:`~repro_torch.service.staleness.StalenessConfig` or None."""
    stale = None
    if staleness is not None:
        from repro_torch.service import staleness as _staleness

        stale = _staleness.init_state(staleness, theta, n_agents)
    return ServiceState(theta=theta, round_idx=0, seed=seed, stale=stale)


def round_mask(p: ParticipationConfig, seed: stream.Seed, round_idx: int,
               agent_ids: torch.Tensor, n_agents: int) -> torch.Tensor:
    """(len(agent_ids),) bool participation mask for one round.
    ``agent_ids`` are absolute agent indices: a block passes its slice of
    ``arange(N)`` and gets exactly those rows of the fleet's mask."""
    if p.kind == "bernoulli":
        mask = stream.agent_uniform(seed, round_idx, agent_ids,
                                    stream.SALT_BERNOULLI) < p.rate
    elif p.kind == "subset":
        w = min(int(p.subset), n_agents)
        offset = (int(round_idx) * w) % n_agents   # rotates by w a round
        mask = (agent_ids - offset) % n_agents < w
    else:  # "full": only faults can drop agents
        mask = torch.ones(agent_ids.shape, dtype=torch.bool,
                          device=agent_ids.device)
    if p.faults is not None and p.faults.active:
        mask = mask & p.faults.up_mask(seed, round_idx, agent_ids)
    return mask


def expected_count(p: ParticipationConfig, n_agents: int) -> float:
    """Closed-form ``E[participating count]``: the ``"expected"`` debias
    normaliser."""
    if p.kind == "bernoulli":
        base = p.rate * n_agents
    elif p.kind == "subset":
        base = float(min(int(p.subset), n_agents))
    else:
        base = float(n_agents)
    if p.faults is not None and p.faults.active:
        base = base * p.faults.availability()
    return base


def safe_inv(w) -> torch.Tensor:
    """``1 / w`` in float32, an exact zero at ``w == 0``."""
    w = torch.as_tensor(w, dtype=torch.float32)
    # ones / w, not 1.0 / w: PyTorch takes a scalar numerator as
    # reciprocal(w) * 1.0, which need not be the rounded division
    return torch.where(w > 0, torch.ones_like(w) / torch.where(w > 0, w, 1.0),
                       torch.zeros_like(w))


def participation_factor(n_agents: int, w_norm) -> torch.Tensor:
    """``N / W``: turns the full-fleet normaliser ``1 / (N m_h)`` into
    ``1 / (W m_h)``; an exact zero when ``W == 0``."""
    return n_agents * safe_inv(w_norm)


def mask_agent_axis(tree: Params, mask: torch.Tensor) -> Params:
    """Rows of the leading agent axis outside ``mask`` become exact zeros."""
    return {k: torch.where(mask.reshape((-1,) + (1,) * (g.ndim - 1)), g,
                           torch.zeros_like(g)) for k, g in tree.items()}
