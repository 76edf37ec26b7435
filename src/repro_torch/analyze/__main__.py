"""CLI: ``python -m repro_torch.analyze [--strict] [paths...]``.

Counterpart of ``python -m repro.analyze``.  Runs the AST rule engine over
the default roots (or explicit paths) and, unless ``--ast-only``, the
trace-level contract checkers, on the card unless ``--device cpu``.
Always writes the JSON report (``ANALYZE_torch_report.json`` by default)
next to the human rendering on stdout.  Exit code: 1 on any error-severity
finding, and on *any* finding under ``--strict``.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analyze import (
    DEFAULT_ROOTS, all_rules, get_rules, repo_root, scan,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="static + trace-level contract checker for the PyTorch "
                    "port",
    )
    parser.add_argument(
        "paths", nargs="*", default=None,
        help=f"files/dirs to scan (default: {', '.join(DEFAULT_ROOTS)})")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 on ANY finding, not just errors")
    parser.add_argument("--ast-only", action="store_true",
                        help="skip the trace-level contract checkers (no "
                             "torch)")
    parser.add_argument("--rules", default=None, metavar="ID[,ID...]",
                        help="run only these AST rule ids")
    parser.add_argument("--checks", default=None, metavar="NAME[,NAME...]",
                        help="run only these contract checks")
    parser.add_argument("--device", default=None, metavar="DEVICE",
                        help="where the contracts run (default: cuda, which "
                             "raises without a card; 'cpu' runs the plain "
                             "versions and traces the cuda backend on a fake "
                             "card)")
    parser.add_argument("--json", default="ANALYZE_torch_report.json",
                        metavar="PATH",
                        help="JSON report path ('' to disable)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print every rule/check id and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id:24s} [{rule.severity:7s}] {rule.description}")
        from repro_torch.analyze.contracts import all_checks
        for name in sorted(all_checks()):
            print(f"{name:24s} [error  ] trace-level contract check")
        return 0

    rules = (get_rules(args.rules.split(",")) if args.rules else None)
    report = scan(repo_root(), args.paths or DEFAULT_ROOTS, rules=rules)

    if not args.ast_only:
        from repro_torch.analyze.contracts import run_contracts
        checks = args.checks.split(",") if args.checks else None
        run_contracts(report, checks=checks, device=args.device)

    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            f.write(report.to_json() + "\n")
    print(report.render_text())
    return report.exit_code(strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
