"""``deprecated-aggregation``: calls/imports of the legacy aggregation API.

Counterpart of ``repro/analyze/rules/deprecated_api.py``, same id.  The
four legacy entry points (``aggregate_stacked``, ``exact_aggregate``,
``psum_aggregate``, ``psum_aggregate_stacked``) survive only as
DeprecationWarning shims in ``core/ota.py``: every in-repo aggregation call
must go through ``ota.aggregate`` / ``ota.aggregate_apply``.

The rule flags call syntax on a legacy name (bare or attribute) and ``from
repro_torch.core.ota import <legacy>`` imports, anywhere outside
``core/ota.py`` itself.  Being AST-based, prose mentions in
strings/comments cannot false-positive, and ``# repro:
noqa[deprecated-aggregation]`` marks sanctioned exceptions in-diff.
``tests/`` is outside the default scan roots on purpose: the suite keeps
legacy-name coverage so the deprecated wrappers stay correct until removal.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analyze.astutils import ModuleContext, dotted_name
from repro_torch.analyze.findings import Finding
from repro_torch.analyze.rules import Rule, register_rule

DEPRECATED = frozenset({
    "aggregate_stacked",
    "exact_aggregate",
    "psum_aggregate",
    "psum_aggregate_stacked",
})


@register_rule
class DeprecatedAggregationRule(Rule):
    id = "deprecated-aggregation"
    severity = "error"
    description = ("caller of a deprecated aggregation wrapper; use "
                   "ota.aggregate / ota.aggregate_apply")
    exclude = ("src/repro_torch/core/ota.py",)

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func).rpartition(".")[2]
                if name in DEPRECATED:
                    yield ctx.finding(
                        self, node,
                        f"call to deprecated ota.{name}; use ota.aggregate"
                        " / ota.aggregate_apply",
                    )
            elif isinstance(node, ast.ImportFrom):
                if node.module and node.module.endswith("ota"):
                    for alias in node.names:
                        if alias.name in DEPRECATED:
                            yield ctx.finding(
                                self, node,
                                f"import of deprecated ota.{alias.name}; "
                                "use ota.aggregate / ota.aggregate_apply",
                            )
