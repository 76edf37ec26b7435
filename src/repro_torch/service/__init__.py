"""The round service: partial, stale and faulty agent participation.

Counterpart of ``repro/service`` without the host-side driver
(``RoundService``, ``ServiceConfig``), which needs the telemetry ledger,
the trace and checkpointing and comes with them.  The pieces thread
through ``fedpg.run(participation=..., staleness=...)`` and
``event_triggered.run(participation=...)``:

* ``service.participation``: per-round masks (Bernoulli, round-robin
  subset) on the counter-hash stream of ``service.stream``, and the
  realised / expected debias normalisers;
* ``service.staleness``: the bounded stale-gradient replay buffer;
* ``service.faults``: stragglers with a round deadline, crash schedules.
"""
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
    "CrashSchedule", "FaultConfig", "ParticipationConfig", "ServiceState",
    "StalenessConfig", "StaleState", "StragglerModel",
]
