"""Host round trips and rebuilds on the round and step path.

The port's form of ``repro/analyze/rules/jit_pitfalls.py``.  JAX's four
rules guard traced functions: numpy, ``float()`` and Python branches on a
tracer raise (or constant-fold), and a ``jax.jit`` in a loop recompiles.
Eager PyTorch raises on none of these: the same code runs, and on a CUDA
tensor each one silently waits for the card (``.item()`` copies to the host
and blocks the stream's queue).  The port's main cell is host-bound, so
a round trip a round is the cost these rules keep out.  Four twins, each
over the functions of the modules on the round and step path
(``ROUND_PATH``; a file outside the package, as a fixture or a script
handed to the checker, is held to them too), with tensors found by
:meth:`ModuleContext.is_tensor`:

``numpy-on-device`` (JAX ``np-under-trace``)
    A ``np.*`` call with a tensor argument, or ``.numpy()``: numpy needs
    host memory, so a CUDA tensor is copied (and the stream drained) first.
    Dtype mentions and static scalar math (``np.sqrt(2.0)``) pass.

``host-sync`` (JAX ``tracer-leak``)
    ``.item()`` / ``.tolist()`` (on anything not known to be a numpy
    array), ``.cpu()``, or ``float()`` / ``int()`` / ``bool()`` of a tensor
    expression: each reads the card's value on the host.

``tensor-branch`` (JAX ``traced-branch``)
    ``if`` / ``while`` / ``assert`` / a conditional expression whose test is
    a tensor expression: Python asks the tensor for a ``bool``, a host
    sync per evaluation; use ``torch.where`` or keep the decision a tensor.

``compile-in-loop`` (JAX ``jit-in-loop``)
    ``torch.compile``, ``torch.jit.script`` / ``trace``, or
    ``kernels.build.build`` / ``load`` inside a ``for`` / ``while`` body (or
    a comprehension): a fresh compile (or a library lookup) per iteration;
    hoist it.

A sanctioned round trip (a history built on the host at the end of a run,
a chip timing loop) carries ``# repro: noqa[rule-id]`` with its reason.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analyze.astutils import FuncNode, ModuleContext
from repro_torch.analyze.findings import Finding
from repro_torch.analyze.rules import Rule, register_rule

PACKAGE = "src/repro_torch/"
# the modules whose functions run on the round and step path
ROUND_PATH = (
    "src/repro_torch/core/fedpg.py", "src/repro_torch/core/lanes.py",
    "src/repro_torch/core/ota.py", "src/repro_torch/core/gpomdp.py",
    "src/repro_torch/core/channel.py", "src/repro_torch/core/power_control.py",
    "src/repro_torch/core/event_triggered.py", "src/repro_torch/rl/",
    "src/repro_torch/service/", "src/repro_torch/kernels/",
    "src/repro_torch/train/trainer.py",
)

# numpy attributes that are fine anywhere: dtypes and type checks
_NP_STATIC_OK = frozenset({
    "dtype", "ndarray", "generic", "isscalar", "ndim", "shape", "float32",
    "float64", "int32", "int64", "uint32", "uint64", "bool_", "integer",
    "floating", "issubdtype",
})
_COMPILERS = frozenset({
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "repro_torch.kernels.build.build", "repro_torch.kernels.build.load",
})
_LOOPS = (ast.For, ast.AsyncFor, ast.While,
          ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def on_round_path(relpath: str) -> bool:
    """Whether the round-path rules hold ``relpath`` (module docstring)."""
    if not relpath.startswith(PACKAGE):
        return True
    return any(relpath == p or (p.endswith("/") and relpath.startswith(p))
               for p in ROUND_PATH)


def _in_function(ctx: ModuleContext, node: ast.AST) -> bool:
    return ctx.enclosing_function(node) is not None


def _is_numpy(ctx: ModuleContext, node: ast.AST) -> bool:
    """A numpy value where it stands: a ``np.*`` call, or an attribute or
    method of one (``np.asarray(x).sum()``)."""
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        if isinstance(node, ast.Call):
            if ctx.resolve(node.func).startswith("numpy."):
                return True
            node = node.func
        else:
            node = node.value
    return False


class _RoundPathRule(Rule):
    def applies(self, ctx: ModuleContext) -> bool:
        return on_round_path(ctx.relpath)


@register_rule
class NumpyOnDeviceRule(_RoundPathRule):
    id = "numpy-on-device"
    severity = "error"
    description = ("numpy on a tensor (or .numpy()) on the round/step path: "
                   "a device-to-host copy")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not self.applies(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not _in_function(ctx, node):
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "numpy" and not node.args:
                yield ctx.finding(
                    self, node,
                    ".numpy() copies the tensor to the host (a sync on the "
                    "card); keep it a tensor on the round path")
                continue
            full = ctx.resolve(node.func)
            if not full.startswith("numpy.") \
                    or full[len("numpy."):] in _NP_STATIC_OK:
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            if any(ctx.is_tensor(a) for a in args):
                yield ctx.finding(
                    self, node,
                    f"{full}(...) on a tensor copies it to the host; use "
                    "the torch op (or hoist the host math out of the round)")


@register_rule
class HostSyncRule(_RoundPathRule):
    id = "host-sync"
    severity = "error"
    description = (".item()/.tolist()/.cpu()/float()/int()/bool() of a "
                   "tensor on the round/step path")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not self.applies(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not _in_function(ctx, node):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and not node.args:
                if f.attr == "cpu" or (f.attr in ("item", "tolist")
                                       and not _is_numpy(ctx, f.value)):
                    yield ctx.finding(
                        self, node,
                        f".{f.attr}() reads the tensor on the host (a sync "
                        "on the card); keep it a tensor, or read it once "
                        "after the loop")
            elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
                    and len(node.args) == 1 and ctx.is_tensor(node.args[0]):
                yield ctx.finding(
                    self, node,
                    f"{f.id}() of a tensor reads it on the host (a sync on "
                    "the card); keep it a tensor")


@register_rule
class TensorBranchRule(_RoundPathRule):
    id = "tensor-branch"
    severity = "error"
    description = "Python if/while/assert on a tensor on the round/step path"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not self.applies(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.If, ast.While, ast.Assert,
                                     ast.IfExp)):
                continue
            if not _in_function(ctx, node):
                continue
            if ctx.is_tensor(node.test):
                kind = type(node).__name__.lower()
                yield ctx.finding(
                    self, node,
                    f"python {kind} on a tensor asks the card for a bool "
                    "(a host sync); use torch.where or keep the decision a "
                    "tensor")


@register_rule
class CompileInLoopRule(_RoundPathRule):
    id = "compile-in-loop"
    severity = "warning"
    description = ("torch.compile / torch.jit / a kernel build inside a "
                   "loop (a compile or lookup per iteration)")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not self.applies(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            full = ctx.resolve(node.func)
            if full not in _COMPILERS:
                continue
            for anc in ctx.ancestors(node):
                if isinstance(anc, FuncNode):
                    break  # a def inside the loop is a fresh scope per
                           # call anyway; only flag compiles directly in a
                           # loop
                if isinstance(anc, _LOOPS):
                    yield ctx.finding(
                        self, node,
                        f"{full}(...) inside a loop compiles (or looks up) "
                        "per iteration; hoist it out of the loop")
                    break
