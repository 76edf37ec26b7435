"""Structured run ledger: one JSONL event stream per run.

Counterpart of ``repro/telemetry/ledger.py`` (which imports no JAX; the port
keeps its own copy).  A :class:`Ledger` appends one JSON object per line:
platform records (``repro_torch.utils.platform.describe``), round-service
commits (``service.driver.RoundService``), and per-scenario sweep records
carrying the measured ``avg_grad_sq`` next to the Theorem-1/2 noise floors
(``repro_torch.core.theory.floor_report``) and the telemetry summaries.
``python -m repro_torch.telemetry.report LEDGER.jsonl`` renders the stream
as a markdown report.

The JAX ledger's ``count_compiles`` (a ``jax.monitoring`` compile counter)
has no meaning for eager PyTorch and is not ported.

The *ambient* ledger (:func:`set_ledger` / :func:`get_ledger`) lets deep
call sites log without threading a handle through every signature.

Every value is sanitised to strict JSON (non-finite floats become the
strings ``"inf"``/``"nan"``) so artifacts survive any JSON parser.
"""
from __future__ import annotations

import json
import math
import time
import warnings
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Ledger", "get_ledger", "read_ledger", "set_ledger",
           "using_ledger"]

_SCHEMA_VERSION = 1


def _json_safe(v: Any) -> Any:
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, bool) or v is None or isinstance(v, (int, str)):
        return v
    if isinstance(v, float):
        if math.isfinite(v):
            return v
        return "nan" if math.isnan(v) else ("inf" if v > 0 else "-inf")
    try:  # numpy scalars
        return _json_safe(float(v))
    except (TypeError, ValueError):
        return repr(v)


class Ledger:
    """Append-only JSONL event log.  Usable as a context manager."""

    def __init__(self, path: str, *, mode: str = "w") -> None:
        self.path = str(path)
        self._f = open(self.path, mode, encoding="utf-8")
        self.event("ledger_start", schema_version=_SCHEMA_VERSION)

    # -- core --------------------------------------------------------------

    def event(self, kind: str, **payload: Any) -> Dict[str, Any]:
        rec = {"ts": time.time(), "kind": kind, **payload}
        self._f.write(json.dumps(_json_safe(rec)) + "\n")
        self._f.flush()
        return rec

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "Ledger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- canned records ----------------------------------------------------

    def log_platform(self) -> None:
        """One ``platform`` event from
        ``repro_torch.utils.platform.describe()``."""
        from repro_torch.utils import platform as rplat

        self.event("platform", **rplat.describe())

    def log_service(self, **payload: Any) -> None:
        """One ``service`` event per round-service commit
        (``repro_torch.service.driver.RoundService``): the commit's round range,
        mean reward / grad-sq / gain, the realised participation rate and
        debias drift, and — when staleness replay is on — the live buffer's
        age histogram."""
        self.event("service", **payload)

    def log_sweep(self, result, *, constants=None, V: Optional[float] = None,
                  label: str = "") -> None:
        """Per-scenario records for one ``repro_torch.core.sweep.
        SweepResult``.

        Each ``scenario`` event carries the flat descriptor
        (``Scenario.describe()``), the measured ``final_reward`` /
        ``avg_grad_sq`` / ``mean_gain``, the per-scenario wall-time share,
        and — when in-jit telemetry ran — the probe summary.  With ``V``
        (or ``constants``, an ``MDPConstants`` whose ``V()`` is used) the
        Theorem-1/2 floors and the measured distance-to-floor are attached
        via ``theory.floor_report``.
        """
        from repro_torch.core import theory

        v_env = V if V is not None else (
            constants.V() if constants is not None else None)
        self.event("sweep", label=label, n_scenarios=len(result),
                   n_partitions=result.n_partitions, mc_runs=result.mc_runs,
                   mode=result.mode, n_devices=result.n_devices)
        for i, s in enumerate(result.scenarios):
            rec: Dict[str, Any] = {"index": i, "label": label, **s.describe()}
            rec["final_reward"] = result.final_reward(i)
            rec["avg_grad_sq"] = result.avg_grad_sq(i)
            rec["scenario_time_us"] = result.scenario_time_us(i)
            tel = result.telemetry_summary(i)
            if tel is not None:
                rec["telemetry"] = tel
            if v_env is not None:
                m_h, sigma_h2 = s.effective_moments()
                fr = theory.floor_report(
                    n_agents=s.n_agents, batch_m=s.batch_m, m_h=m_h,
                    sigma_h2=sigma_h2, noise_sigma2=s.noise_sigma**2, V=v_env)
                rec.update(fr)
                rec["distance_to_floor"] = rec["avg_grad_sq"] - fr["floor"]
            self.event("scenario", **rec)


# ---------------------------------------------------------------------------
# Ambient ledger.
# ---------------------------------------------------------------------------

_AMBIENT: Optional[Ledger] = None


def set_ledger(ledger: Optional[Ledger]) -> None:
    global _AMBIENT
    _AMBIENT = ledger


def get_ledger() -> Optional[Ledger]:
    return _AMBIENT


@contextmanager
def using_ledger(ledger: Ledger) -> Iterator[Ledger]:
    """Install ``ledger`` as the ambient ledger for the block."""
    prev = get_ledger()
    set_ledger(ledger)
    try:
        yield ledger
    finally:
        set_ledger(prev)


# ---------------------------------------------------------------------------
# Reading.
# ---------------------------------------------------------------------------

def read_ledger(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL ledger, skipping malformed lines with a warning (a
    crashed run may truncate its last record — the rest stays usable)."""
    events: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                warnings.warn(f"{path}:{lineno}: skipping malformed ledger "
                              "line", stacklevel=2)
                continue
            if not isinstance(rec, dict) or "kind" not in rec:
                warnings.warn(f"{path}:{lineno}: skipping non-event record",
                              stacklevel=2)
                continue
            events.append(rec)
    return events
