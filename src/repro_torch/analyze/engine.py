"""Layer 1: the AST scan driver.

Counterpart of ``repro/analyze/engine.py``.  Parses every Python file under
the configured roots (the port's package, ``src/repro_torch/``, by
default), hands each module to every registered rule
(:mod:`repro_torch.analyze.rules`), and applies the inline ``# repro:
noqa[rule-id]`` suppressions.  The shared AST analyses rules build on live
in :mod:`repro_torch.analyze.astutils`; nothing in this layer imports
torch.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Iterator, List, Optional, Sequence, Tuple

from repro_torch.analyze.astutils import ModuleContext, parse_module
from repro_torch.analyze.findings import Finding, Report, is_suppressed
from repro_torch.analyze.rules import Rule, all_rules

# Directories scanned by default, relative to the repo root: the port's
# package.  ``benchmarks/`` and ``examples/`` import only the JAX package,
# and ``tests/`` keeps legacy-name and hazard coverage (deprecated wrappers
# must stay tested until they are removed); ``chip_smoke.py`` can be passed
# as a path.
DEFAULT_ROOTS = ("src/repro_torch",)

_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", "node_modules"}


def repo_root() -> pathlib.Path:
    """The repository root (three levels above this file's package)."""
    return pathlib.Path(__file__).resolve().parents[3]


def iter_python_files(
    root: pathlib.Path, targets: Sequence[str],
) -> Iterator[Tuple[pathlib.Path, str]]:
    """Yield ``(abs_path, repo_relative_posix)`` for every .py under
    ``targets`` (files or directories, absolute or relative to ``root``)."""
    for target in targets:
        p = pathlib.Path(target)
        if not p.is_absolute():
            p = root / target
        if p.is_file() and p.suffix == ".py":
            yield p, _rel(p, root)
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not _SKIP_DIRS.intersection(f.parts):
                    yield f, _rel(f, root)


def _rel(p: pathlib.Path, root: pathlib.Path) -> str:
    try:
        return p.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return p.as_posix()


def scan_module(ctx: ModuleContext, rules: Sequence[Rule],
                report: Report) -> None:
    for rule in rules:
        if ctx.relpath in rule.exclude:
            continue
        for f in rule.check(ctx):
            line = ""
            if 1 <= f.line <= len(ctx.source_lines):
                line = ctx.source_lines[f.line - 1]
            if is_suppressed(f, line):
                report.suppressed.append(f)
            else:
                report.findings.append(f)


def scan(root: pathlib.Path, targets: Sequence[str] = DEFAULT_ROOTS,
         rules: Optional[Sequence[Rule]] = None,
         report: Optional[Report] = None) -> Report:
    """Run the AST rules over every Python file under ``targets``."""
    report = report if report is not None else Report()
    rules = list(rules) if rules is not None else all_rules()
    for path, relpath in iter_python_files(root, targets):
        ctx = parse_module(path, relpath)
        if ctx is None:
            report.skipped.append(f"{relpath}: unparseable, not scanned")
            continue
        report.files_scanned += 1
        scan_module(ctx, rules, report)
    return report


def scan_source(source: str, relpath: str = "<string>",
                rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Scan one source string (the test-fixture entry point).

    Suppressions apply exactly as in file scans; returns the surviving
    findings.
    """
    report = Report()
    tree = ast.parse(source)
    ctx = ModuleContext(path=pathlib.Path(relpath), relpath=relpath,
                        tree=tree, source_lines=source.splitlines())
    scan_module(ctx, list(rules) if rules is not None else all_rules(),
                report)
    return report.findings
