"""``repro_torch.analyze``: the port's static contract checker.

Counterpart of ``repro.analyze``, with its records, JSON and exit codes,
its suppression syntax and its contract ids, each in PyTorch's meaning.
Two layers behind one CLI (``python -m repro_torch.analyze``):

* **AST rules** (:mod:`repro_torch.analyze.engine`,
  :mod:`repro_torch.analyze.rules`) parse every Python file under
  ``src/repro_torch/`` and flag source-level hazards: draws from the global
  random generator, deprecated aggregation callers, host round trips and
  tensor branches on the round path, compiles in loops, ad-hoc CUDA/torch
  settings.  No torch import: pre-commit cheap.
* **Trace-level contracts** (:mod:`repro_torch.analyze.contracts`) import
  the real registries and run representative programs: the lane-packing
  contract, the sanctioned-narrowing wire-dtype rule (aten ops under a
  dispatch mode, K1's launch records), build budgets
  (:mod:`repro_torch.analyze.budget`), the agent mesh's collectives, the
  streamed memory claim, the round service's contracts, and the host-sync
  count on the card.

Both layers emit :class:`~repro_torch.analyze.findings.Finding` records
into one :class:`~repro_torch.analyze.findings.Report` (text +
``ANALYZE_torch_report.json``); ``# repro: noqa[rule-id]`` suppresses AST
findings inline.  ``python -m repro_torch.analyze --strict`` fails on any
finding.  It imports nothing of JAX or of the JAX package.
"""
from repro_torch.analyze.engine import (  # noqa: F401
    DEFAULT_ROOTS, repo_root, scan, scan_source,
)
from repro_torch.analyze.findings import Finding, Report  # noqa: F401
from repro_torch.analyze.rules import (  # noqa: F401
    Rule, all_rules, get_rules, register_rule,
)

__all__ = [
    "DEFAULT_ROOTS", "Finding", "Report", "Rule", "all_rules", "get_rules",
    "register_rule", "repo_root", "run", "scan", "scan_source",
]


def run(targets=None, *, rules=None, ast_only: bool = False,
        checks=None, device=None) -> "Report":
    """One full analyzer pass: AST scan + (unless ``ast_only``) contracts.

    The importable equivalent of the CLI; the contracts run on the card
    unless ``device="cpu"`` (``None`` means ``cuda`` and raises without
    one).  ``repro_torch.analyze.contracts`` is imported lazily so
    AST-only callers never import torch.
    """
    report = scan(repo_root(), targets or DEFAULT_ROOTS, rules=rules)
    if not ast_only:
        from repro_torch.analyze.contracts import run_contracts

        run_contracts(report, checks=checks, device=device)
    return report
