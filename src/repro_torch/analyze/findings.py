"""Finding records, suppression syntax, and report rendering.

Counterpart of ``repro/analyze/findings.py``, record for record.  A
:class:`Finding` is one analyzer hit: ``(rule, severity, file, line,
message)``.  Both analysis layers, the AST rule engine
(:mod:`repro_torch.analyze.engine`) and the trace-level contract checkers
(:mod:`repro_torch.analyze.contracts`), emit the same record type, so one
report (text + ``ANALYZE_torch_report.json``) covers the whole run.

Suppression is inline and therefore visible in-diff, with the JAX
package's syntax, so one source line means the same to both checkers::

    os.environ["CUDA_VISIBLE_DEVICES"] = "0"  # repro: noqa[device-env] pin

``# repro: noqa[rule-a,rule-b]`` silences the named rules on that physical
line; a bare ``# repro: noqa`` silences every rule on the line.  Suppressed
findings are dropped from the exit-code accounting but still counted in the
JSON report (``counts.suppressed``) so exceptions never become invisible.
"""
from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence

SEVERITIES = ("error", "warning", "info")

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\[([A-Za-z0-9_\-, ]+)\])?")


@dataclass(frozen=True)
class Finding:
    """One analyzer hit (AST rule or trace-level contract violation)."""

    rule: str
    severity: str      # "error" | "warning" | "info"
    path: str          # repo-relative (or "<trace>" for contract checks)
    line: int          # 1-based; 0 when the finding has no source anchor
    message: str
    col: int = 0

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}")

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.severity}: {self.message}"


def noqa_rules(line: str) -> Optional[frozenset]:
    """The rule ids suppressed by ``line``'s trailing comment.

    Returns ``None`` when the line carries no ``repro: noqa`` marker, an
    empty frozenset for the bare blanket form (suppress everything), and a
    frozenset of rule ids for the bracketed form.
    """
    m = _NOQA_RE.search(line)
    if m is None:
        return None
    if m.group(1) is None:
        return frozenset()
    return frozenset(t.strip() for t in m.group(1).split(",") if t.strip())


def is_suppressed(finding: Finding, source_line: str) -> bool:
    rules = noqa_rules(source_line)
    if rules is None:
        return False
    return not rules or finding.rule in rules


@dataclass
class Report:
    """The full result of one analyzer run."""

    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    skipped: List[str] = field(default_factory=list)   # disabled checks + why
    files_scanned: int = 0

    def extend(self, findings: Sequence[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def counts(self) -> Dict[str, int]:
        c = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            c[f.severity] += 1
        c["suppressed"] = len(self.suppressed)
        return c

    def exit_code(self, strict: bool = False) -> int:
        """0 when clean; 1 on any error, or on any finding under --strict."""
        if strict:
            return 1 if self.findings else 0
        return 1 if self.counts["error"] else 0

    def to_json(self) -> str:
        return json.dumps(
            {
                "version": 1,
                "generated_by": "repro_torch.analyze",
                "counts": self.counts,
                "files_scanned": self.files_scanned,
                "skipped": self.skipped,
                "findings": [asdict(f) for f in self.findings],
                "suppressed": [asdict(f) for f in self.suppressed],
            },
            indent=2, sort_keys=True,
        )

    def render_text(self) -> str:
        lines = []
        order = {s: i for i, s in enumerate(SEVERITIES)}
        for f in sorted(self.findings,
                        key=lambda f: (order[f.severity], f.path, f.line)):
            lines.append(f.render())
        for note in self.skipped:
            lines.append(f"skipped: {note}")
        c = self.counts
        lines.append(
            f"{len(self.findings)} finding(s) "
            f"({c['error']} error, {c['warning']} warning, {c['info']} info; "
            f"{c['suppressed']} suppressed) in {self.files_scanned} file(s)")
        return "\n".join(lines)
