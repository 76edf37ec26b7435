"""The pluggable AST rule registry.

Counterpart of ``repro/analyze/rules/__init__.py``, with the same API.
A rule is a class with a unique ``id``, a ``severity``, a one-line
``description``, and a ``check(ctx)`` generator yielding
:class:`repro_torch.analyze.findings.Finding` for one parsed module
(:class:`repro_torch.analyze.engine.ModuleContext`).  Registration is by
decorator::

    from repro_torch.analyze.rules import Rule, register_rule

    @register_rule
    class MyRule(Rule):
        id = "my-rule"
        severity = "warning"
        description = "what this catches"

        def check(self, ctx):
            yield ctx.finding(self, node, "message")

``exclude`` lists repo-relative paths a rule never applies to (e.g. the
module that *owns* the guarded invariant).  Importing this package loads
every built-in rule module so ``all_rules()`` is complete.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Sequence, TYPE_CHECKING

from repro_torch.analyze.findings import Finding

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.analyze.engine import ModuleContext

_RULES: Dict[str, "Rule"] = {}


class Rule:
    """Base class for AST rules; subclasses override ``check``."""

    id: str = ""
    severity: str = "error"
    description: str = ""
    # repo-relative posix paths this rule never fires on (invariant owners)
    exclude: Sequence[str] = ()

    def check(self, ctx: "ModuleContext") -> Iterator[Finding]:
        raise NotImplementedError
        yield  # pragma: no cover


def register_rule(cls: type) -> type:
    """Class decorator adding a rule (by its ``id``) to the registry."""
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _RULES and type(_RULES[cls.id]) is not cls:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    _RULES[cls.id] = cls()
    return cls


def all_rules() -> List[Rule]:
    return [_RULES[k] for k in sorted(_RULES)]


def get_rules(ids: Iterable[str]) -> List[Rule]:
    rules = []
    for rid in ids:
        if rid not in _RULES:
            raise KeyError(
                f"unknown rule {rid!r}; known: {sorted(_RULES)}")
        rules.append(_RULES[rid])
    return rules


# Built-in rule modules register themselves on import.
from repro_torch.analyze.rules import deprecated_api  # noqa: E402,F401
from repro_torch.analyze.rules import jit_pitfalls    # noqa: E402,F401
from repro_torch.analyze.rules import platform        # noqa: E402,F401
from repro_torch.analyze.rules import prng            # noqa: E402,F401
from repro_torch.analyze.rules import timing          # noqa: E402,F401
