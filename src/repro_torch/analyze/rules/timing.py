"""``raw-timing``: ad-hoc wall-clock timing bypassing the span tracer.

Counterpart of ``repro/analyze/rules/timing.py``, same id.
``repro_torch.telemetry.trace`` owns wall-clock measurement: spans nest,
carry attributes, export to Chrome trace JSON, wait for a card's queued
work (``sync_device``) and keep ``wall_time_us``-style bookkeeping
consistent across the sweep engine and the chip's timings (``timed_call``).
A raw ``time.perf_counter()`` pair anywhere else produces a float that
never reaches trace exports or run ledgers (and, on the card, times the
enqueue rather than the work), so the rule flags every direct
monotonic-clock call outside the owning package:

* ``time.perf_counter()`` / ``time.perf_counter_ns()``
* ``time.monotonic()`` / ``time.monotonic_ns()``

(also through ``import time as t`` aliases and ``from time import
perf_counter`` names).  ``time.time()`` stays fine: it is a timestamp, not
an interval measurement.  The rare legitimate raw use (a chip timing loop
where per-iteration span overhead would bias the medians) opts out per
line with ``# repro: noqa[raw-timing]``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analyze.astutils import ModuleContext, dotted_name
from repro_torch.analyze.findings import Finding
from repro_torch.analyze.rules import Rule, register_rule

_CLOCKS = frozenset(
    {"perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns"})
_OWNER_PREFIX = "src/repro_torch/telemetry/"
_FIX = ("wrap the timed region in repro_torch.telemetry.trace.span() or "
        "use trace.timed_call() for call timing")


@register_rule
class RawTimingRule(Rule):
    id = "raw-timing"
    severity = "warning"
    description = ("raw monotonic-clock timing bypassing "
                   "repro_torch.telemetry.trace")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.relpath.startswith(_OWNER_PREFIX):
            return
        time_aliases = {"time"}
        clock_names = {}  # local name -> clock, from `from time import ...`
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        time_aliases.add(a.asname or a.name)
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in _CLOCKS:
                        clock_names[a.asname or a.name] = a.name
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            if "." in dotted:
                mod, _, attr = dotted.rpartition(".")
                if mod in time_aliases and attr in _CLOCKS:
                    yield ctx.finding(
                        self, node, f"raw {dotted}() timing; {_FIX}")
            elif dotted in clock_names:
                yield ctx.finding(
                    self, node,
                    f"raw {clock_names[dotted]}() timing; {_FIX}")
