"""Observability of the port: in-round probes, the span tracer, run ledgers.

Counterpart of ``repro/telemetry``:

* :mod:`repro_torch.telemetry.probes` — a :class:`TelemetryConfig` that,
  passed to ``fedpg.run`` / ``monte_carlo`` / ``sweep``, makes every round
  emit a :class:`RoundTelemetry` (effective SNR, pre/post-aggregation
  gradient norms, channel-moment drift, per-agent norm dispersion, and the
  service probes).  Telemetry off leaves every bit of a run unchanged.
* :mod:`repro_torch.telemetry.trace` — the span tracer that owns wall-clock
  timing, synchronising the card where a span asks it to, with a Chrome
  trace-event export and a ``torch.profiler`` bridge.
* :mod:`repro_torch.telemetry.ledger` — a JSONL event log per run
  (platform, round-service commits, per-scenario sweep results against the
  Theorem-1/2 floors) rendered to markdown by
  ``python -m repro_torch.telemetry.report``.
"""
from repro_torch.telemetry import trace  # noqa: F401
from repro_torch.telemetry.ledger import (  # noqa: F401
    Ledger, get_ledger, read_ledger, set_ledger, using_ledger,
)
from repro_torch.telemetry.probes import (  # noqa: F401
    RoundTelemetry, TelemetryConfig, summarize,
)

__all__ = ["Ledger", "RoundTelemetry", "TelemetryConfig", "get_ledger",
           "read_ledger", "set_ledger", "summarize", "trace", "using_ledger"]
