"""Observability of the port: in-round probes and the span tracer.

Counterpart of ``repro/telemetry`` without the run ledger and its report
(``ledger.py``, ``report.py``), which come with the round-service driver:

* :mod:`repro_torch.telemetry.probes` — a :class:`TelemetryConfig` that,
  passed to ``fedpg.run`` / ``monte_carlo`` / ``sweep``, makes every round
  emit a :class:`RoundTelemetry` (effective SNR, pre/post-aggregation
  gradient norms, channel-moment drift, per-agent norm dispersion, and the
  service probes).  Telemetry off leaves every bit of a run unchanged.
* :mod:`repro_torch.telemetry.trace` — the span tracer that owns wall-clock
  timing, synchronising the card where a span asks it to, with a Chrome
  trace-event export and a ``torch.profiler`` bridge.
"""
from repro_torch.telemetry import trace  # noqa: F401
from repro_torch.telemetry.probes import (  # noqa: F401
    RoundTelemetry, TelemetryConfig, summarize,
)

__all__ = ["RoundTelemetry", "TelemetryConfig", "summarize", "trace"]
