"""``global-rng``: a draw from, or a write to, a global random generator.

The port's form of ``repro/analyze/rules/prng.py`` (``key-reuse``).  JAX's
keys are values, so JAX's hazard is consuming one key twice.  A
``torch.Generator`` is a stateful stream that every draw advances, so
reusing one is how a run is meant to draw (``fedpg.run`` keeps one
sequential generator a run; ``utils.device.index_generator`` is the port's
``fold_in``).  Torch's hazard is the *global* generator: a draw that takes
no ``generator=`` reads process-wide state that any other draw (a test, a
library, another lane) advances, so the run stops being a function of its
seed: the counterpart of JAX's correlated-draws bug.  The rule flags:

* ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` / ``bernoulli`` /
  ``multinomial`` / ``normal`` / ``poisson`` called without a
  ``generator=`` keyword, and ``torch.rand_like`` / ``randn_like`` /
  ``randint_like``, which take none;
* the in-place samplers ``.normal_`` / ``.uniform_`` / ``.exponential_`` /
  ``.random_`` / ``.bernoulli_`` / ``.cauchy_`` / ``.log_normal_`` /
  ``.geometric_`` (on any receiver, ``torch.nn.init``'s too) without
  ``generator=``;
* NumPy's legacy global stream, ``np.random.<draw>`` (``default_rng``,
  ``SeedSequence`` and the bit generators are explicit and fine);
* seeding or restoring the global state (``torch.manual_seed``,
  ``torch.seed``, ``torch.cuda.manual_seed[_all]``, ``torch.cuda.seed[_all]``,
  ``torch.[cuda.]set_rng_state``, ``np.random.seed``) anywhere but
  ``utils/device.py``, which owns the port's generators.

Keywords are read from the call node, so a ``generator=`` on a continuation
line counts; a call that splats ``**kwargs`` is taken to pass one.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analyze.astutils import ModuleContext
from repro_torch.analyze.findings import Finding
from repro_torch.analyze.rules import Rule, register_rule

_DRAWS = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.bernoulli", "torch.multinomial", "torch.normal", "torch.poisson",
})
_NO_GENERATOR = frozenset({
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
})
_INPLACE = frozenset({
    "normal_", "uniform_", "exponential_", "random_", "bernoulli_",
    "cauchy_", "log_normal_", "geometric_",
})
_SEEDING = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
    "torch.set_rng_state", "torch.random.set_rng_state",
    "torch.cuda.set_rng_state", "torch.cuda.set_rng_state_all",
    "numpy.random.seed", "numpy.random.set_state",
})
_NP_EXPLICIT = frozenset({
    "default_rng", "Generator", "SeedSequence", "BitGenerator", "PCG64",
    "PCG64DXSM", "Philox", "SFC64", "MT19937", "RandomState",
})
_OWNER = "src/repro_torch/utils/device.py"
_FIX = ("pass generator= (utils.device.make_generator / index_generator) "
        "so the draw is a function of the run's seed")


def _passes_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" or kw.arg is None
               for kw in call.keywords)


@register_rule
class GlobalRngRule(Rule):
    id = "global-rng"
    severity = "error"
    description = ("a draw from (or a seeding of) the global torch/numpy "
                   "random generator; pass an explicit generator")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        owner = ctx.relpath == _OWNER
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            full = ctx.resolve(node.func)
            if full in _SEEDING:
                if not owner:
                    yield ctx.finding(
                        self, node,
                        f"{full}() sets process-wide random state; seed a "
                        "torch.Generator (utils.device) instead")
            elif full in _DRAWS:
                if not _passes_generator(node):
                    yield ctx.finding(
                        self, node,
                        f"{full}() without generator= draws from the global "
                        f"generator; {_FIX}")
            elif full in _NO_GENERATOR:
                yield ctx.finding(
                    self, node,
                    f"{full}() always draws from the global generator; "
                    f"use the matching factory with generator= ({_FIX})")
            elif full.startswith("numpy.random."):
                fn = full[len("numpy.random."):]
                if fn.partition(".")[0] not in _NP_EXPLICIT:
                    yield ctx.finding(
                        self, node,
                        f"{full}() draws from NumPy's global stream; use "
                        "np.random.default_rng(seed)")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _INPLACE \
                    and not _passes_generator(node):
                yield ctx.finding(
                    self, node,
                    f".{node.func.attr}() without generator= draws from the "
                    f"global generator; {_FIX}")
