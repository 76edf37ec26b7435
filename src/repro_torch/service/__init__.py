"""The round service: partial, stale and faulty agent participation.

Counterpart of ``repro/service``.  The pieces thread through
``fedpg.run(participation=..., staleness=...)`` and
``event_triggered.run(participation=...)``, and the driver runs them as a
long-running service:

* ``service.participation``: per-round masks (Bernoulli, round-robin
  subset) on the counter-hash stream of ``service.stream``, and the
  realised / expected debias normalisers;
* ``service.staleness``: the bounded stale-gradient replay buffer;
* ``service.faults``: stragglers with a round deadline, crash schedules;
* ``service.driver``: :class:`RoundService` and :class:`ServiceConfig`,
  commit segments with one ledger event each, round deadlines, and
  checkpoint/resume bitwise equal to an uninterrupted run.
"""
from repro_torch.service.driver import (  # noqa: F401
    RoundService, ServiceConfig,
)
from repro_torch.service.faults import (  # noqa: F401
    CrashSchedule, FaultConfig, StragglerModel,
)
from repro_torch.service.participation import (  # noqa: F401
    ParticipationConfig, ServiceState,
)
from repro_torch.service.staleness import (  # noqa: F401
    StalenessConfig, StaleState,
)

__all__ = [
    "CrashSchedule", "FaultConfig", "ParticipationConfig", "RoundService",
    "ServiceConfig", "ServiceState", "StalenessConfig", "StaleState",
    "StragglerModel",
]
