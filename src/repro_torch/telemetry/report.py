"""Render a JSONL run ledger as a markdown report.

    python -m repro_torch.telemetry.report LEDGER.jsonl [-o REPORT.md]

Counterpart of ``repro/telemetry/report.py`` (which imports no JAX; the port
keeps its own copy).

Sections (each only when the ledger carries matching events): platform,
compile counts, the per-scenario sweep table — measured ``avg_grad_sq``
against the Theorem-1/2 floors with the distance-to-floor and the in-jit
telemetry summaries (effective SNR, moment drift, grad-norm dispersion,
and — for service scenarios — the realised participation rate and mean
staleness) — the round-service commit log, and the benchmark rows.  This
is the human end of the observability pipeline: sweep/bench/service run
-> ``Ledger`` -> this report.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.telemetry.ledger import read_ledger

__all__ = ["render"]


def _fmt(v: Any) -> str:
    if v is None or v == "":
        return "-"
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _table(cols: Sequence[str], rows: List[Dict[str, Any]]) -> List[str]:
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "---|" * len(cols)]
    for row in rows:
        lines.append("| " + " | ".join(_fmt(row.get(c)) for c in cols) + " |")
    return lines


def _scenario_row(ev: Dict[str, Any]) -> Dict[str, Any]:
    tel = ev.get("telemetry") or {}
    return {
        "tag": ev.get("tag") or ev.get("index"),
        "env": ev.get("env"), "channel": ev.get("channel"),
        "noise_sigma": ev.get("noise_sigma"), "m_h_eff": ev.get("m_h_eff"),
        "final_reward": ev.get("final_reward"),
        "avg_grad_sq": ev.get("avg_grad_sq"),
        "floor": ev.get("floor"), "floor_which": ev.get("floor_which"),
        "dist_to_floor": ev.get("distance_to_floor"),
        "snr": tel.get("snr"), "drift": tel.get("moment_drift"),
        "dispersion": tel.get("dispersion"),
        # round-service probes: realised participation rate and mean
        # replayed age (present only for scenarios run with an active
        # ParticipationConfig / staleness replay)
        "part_rate": tel.get("participation_rate"),
        "staleness": tel.get("staleness_mean"),
    }


def render(events: List[Dict[str, Any]], title: str = "Run report") -> str:
    by_kind: Dict[str, List[Dict[str, Any]]] = {}
    for ev in events:
        by_kind.setdefault(ev.get("kind", "?"), []).append(ev)
    out: List[str] = [f"# {title}", ""]

    for ev in by_kind.get("platform", []):
        out += ["## Platform", ""]
        out += [f"- **{k}**: `{_fmt(v)}`" for k, v in sorted(ev.items())
                if k not in ("kind", "ts")]
        out.append("")

    if "compiles" in by_kind:
        out += ["## Compiled programs", ""]
        out += _table(["label", "count"], by_kind["compiles"])
        out.append("")

    sweeps = by_kind.get("sweep", [])
    scenarios = by_kind.get("scenario", [])
    if sweeps or scenarios:
        out += ["## Sweeps", ""]
        if sweeps:
            out += _table(["label", "n_scenarios", "n_partitions", "mc_runs",
                           "mode", "n_devices", "n_compiles"], sweeps)
            out.append("")
    if scenarios:
        out += ["### Scenarios: measured avg_grad_sq vs theory floors", ""]
        out += _table(
            ["tag", "env", "channel", "noise_sigma", "m_h_eff",
             "final_reward", "avg_grad_sq", "floor", "floor_which",
             "dist_to_floor", "snr", "drift", "dispersion",
             "part_rate", "staleness"],
            [_scenario_row(ev) for ev in scenarios])
        out.append("")

    if "service" in by_kind:
        out += ["## Round service", ""]
        out += _table(
            ["round_start", "round_end", "reward", "grad_sq", "gain_mean",
             "participation_rate", "participation_drift", "staleness_mean",
             "staleness_hist", "deadline_exceeded", "wall_us"],
            by_kind["service"])
        out.append("")

    if "bench_row" in by_kind:
        out += ["## Benchmark rows", ""]
        out += _table(["name", "us_per_call", "compile_us", "run_us",
                       "derived"], by_kind["bench_row"])
        out.append("")

    return "\n".join(out).rstrip() + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="render a JSONL run ledger as markdown")
    ap.add_argument("ledger", help="path to a LEDGER.jsonl file")
    ap.add_argument("-o", "--out", default="",
                    help="write the report here (default: stdout)")
    ap.add_argument("--title", default="Run report")
    args = ap.parse_args(argv)

    text = render(read_ledger(args.ledger), title=args.title)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
