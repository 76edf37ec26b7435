"""Shared AST analyses for the rule engine.

Counterpart of ``repro/analyze/astutils.py``.  Rules receive a
:class:`ModuleContext`: one parsed module plus the lazily-computed analyses
every rule needs:

* ``dotted_name(node)``: the dotted name of a ``Name``/``Attribute`` chain
  (``torch.cuda.manual_seed``), empty string otherwise;
* ``ctx.resolve(node)``: the same name with its head resolved through the
  module's imports (``np.mean`` -> ``numpy.mean``, ``from torch import
  randn`` -> ``torch.randn``, a module's own top-level functions under the
  module's dotted path);
* ``ctx.is_tensor(node)``: whether an expression is (heuristically) a
  ``torch.Tensor``: a ``torch.*`` call that returns one, a name bound to
  one in the enclosing functions (a parameter annotated ``torch.Tensor``,
  or assigned from a tensor expression), and what indexing, arithmetic,
  comparisons and tensor methods make of those;
* ``ctx.parents``: child -> parent AST links, for ancestor queries.

JAX's analysis asks which functions run under a trace; in eager PyTorch
every function runs eagerly, so the port's rules ask instead which values
are tensors, and the round-path rules (``rules/jit_pitfalls.py``) name the
modules they hold to.  The analysis is deliberately heuristic (no
interprocedural dataflow): rules built on it aim for high precision on
this repo's idioms, with ``# repro: noqa[rule-id]`` as the escape hatch for
deliberate exceptions.  Nothing in the AST layer imports torch: it stays
cheap enough to run as a pre-commit-grade lint.
"""
from __future__ import annotations

import ast
import pathlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

# torch.* callables that return no tensor (devices, generators, dtypes,
# predicates, context managers, settings)
_TORCH_NON_TENSOR = frozenset({
    "torch.device", "torch.Generator", "torch.dtype", "torch.Size",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.numel", "torch.get_default_dtype", "torch.finfo", "torch.iinfo",
    "torch.no_grad", "torch.inference_mode", "torch.enable_grad",
    "torch.set_grad_enabled", "torch.is_grad_enabled", "torch.manual_seed",
    "torch.seed", "torch.initial_seed", "torch.promote_types",
    "torch.result_type", "torch.can_cast", "torch.compile",
    "torch.get_num_threads", "torch.set_num_threads", "torch.equal",
    "torch.allclose", "torch.are_deterministic_algorithms_enabled",
    "torch.use_deterministic_algorithms", "torch.set_printoptions",
})
_TORCH_NON_TENSOR_PREFIXES = (
    "torch.cuda.", "torch.distributed.", "torch.backends.", "torch.jit.",
    "torch.utils.", "torch.testing.", "torch.overrides.", "torch.library.",
    "torch.profiler.", "torch.compiler.", "torch._",
)
# tensor methods and attributes that give no tensor
_NON_TENSOR_METHODS = frozenset({
    "item", "tolist", "numpy", "numel", "nelement", "dim", "ndimension",
    "size", "element_size", "data_ptr", "is_contiguous", "stride",
    "storage_offset", "get_device", "is_floating_point", "is_complex",
    "untyped_storage", "is_pinned", "is_set_to", "has_names", "type",
    "equal", "allclose", "__len__", "is_shared", "is_nonzero",
})
_NON_TENSOR_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "is_meta", "is_sparse",
    "layout", "requires_grad", "is_leaf", "names", "itemsize", "nbytes",
})
_TENSOR_ANNOTATIONS = frozenset({"torch.Tensor", "Tensor"})
_ARITH_COMPARE = (ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq)


def dotted_name(node: ast.AST) -> str:
    """``torch.cuda.manual_seed`` for a Name/Attribute chain; "" when not a
    chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def module_dotted(relpath: str) -> str:
    """``repro_torch.kernels.build`` for ``src/repro_torch/kernels/build.py``
    ("" for a path outside ``src/``)."""
    p = pathlib.PurePosixPath(relpath)
    if len(p.parts) < 2 or p.parts[0] != "src" or p.suffix != ".py":
        return ""
    parts = list(p.with_suffix("").parts[1:])
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def import_aliases(tree: ast.Module, module: str = "") -> Dict[str, str]:
    """Local name -> full dotted name of every import in ``tree``, and of the
    module's own top-level functions (under ``module``, its dotted path)."""
    aliases: Dict[str, str] = {}
    package = module.rpartition(".")[0]
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and module:
            aliases[node.name] = f"{module}.{node.name}"
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    head = a.name.partition(".")[0]
                    aliases[head] = head
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package.split(".") if package else []
                up = up[:len(up) - (node.level - 1)] if node.level > 1 else up
                base = ".".join(p for p in up + [base] if p)
            for a in node.names:
                if a.name != "*":
                    aliases[a.asname or a.name] = \
                        f"{base}.{a.name}" if base else a.name
    return aliases


def _is_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, ast.Subscript) and dotted_name(ann.value) in (
            "Optional", "typing.Optional"):
        return _is_tensor_annotation(ann.slice)
    return dotted_name(ann) in _TENSOR_ANNOTATIONS


@dataclass
class ModuleContext:
    """One parsed module plus the lazily-computed shared analyses."""

    path: pathlib.Path           # absolute
    relpath: str                 # repo-relative posix path
    tree: ast.Module
    source_lines: List[str]
    _parents: Optional[Dict[ast.AST, ast.AST]] = field(default=None,
                                                       repr=False)
    _aliases: Optional[Dict[str, str]] = field(default=None, repr=False)
    _tensors: Dict[ast.AST, Set[str]] = field(default_factory=dict,
                                              repr=False)

    def finding(self, rule, node: ast.AST, message: str,
                severity: Optional[str] = None):
        from repro_torch.analyze.findings import Finding

        return Finding(
            rule=rule.id, severity=severity or rule.severity,
            path=self.relpath, line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0), message=message,
        )

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {
                child: parent
                for parent in ast.walk(self.tree)
                for child in ast.iter_child_nodes(parent)
            }
        return self._parents

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, FuncNode):
                return anc
        return None

    # -- import resolution ------------------------------------------------

    @property
    def aliases(self) -> Dict[str, str]:
        if self._aliases is None:
            self._aliases = import_aliases(self.tree,
                                           module_dotted(self.relpath))
        return self._aliases

    def resolve(self, node: ast.AST) -> str:
        """The dotted name of ``node`` with its head resolved through the
        module's imports ("" when ``node`` is not a name chain)."""
        dotted = dotted_name(node)
        if not dotted:
            return ""
        head, dot, rest = dotted.partition(".")
        full = self.aliases.get(head)
        if full is None:
            return dotted
        return f"{full}{dot}{rest}"

    # -- tensor inference -------------------------------------------------

    def tensor_names(self, fn: Optional[ast.AST]) -> Set[str]:
        """Names bound to tensors in ``fn`` and the functions around it: a
        parameter annotated ``torch.Tensor`` (or ``Optional`` of it), or a
        name assigned (or looped over) from a tensor expression."""
        if fn is None:
            return set()
        if fn in self._tensors:
            return self._tensors[fn]
        names = set(self.tensor_names(self.enclosing_function(fn)))
        self._tensors[fn] = names
        if not isinstance(fn, ast.Lambda):
            a = fn.args
            for p in a.posonlyargs + a.args + a.kwonlyargs:
                if _is_tensor_annotation(p.annotation):
                    names.add(p.arg)
        body = [n for n in ast.walk(fn) if self.enclosing_function(n) is fn]
        for _ in range(2):   # two passes reach names bound from names
            for node in body:
                if isinstance(node, ast.Assign):
                    if self._tensor_in(node.value, names):
                        for t in node.targets:
                            _bind(t, names)
                elif isinstance(node, ast.AnnAssign):
                    if _is_tensor_annotation(node.annotation) or (
                            node.value is not None
                            and self._tensor_in(node.value, names)):
                        _bind(node.target, names)
                elif isinstance(node, ast.AugAssign):
                    if self._tensor_in(node.value, names):
                        _bind(node.target, names)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    if self._tensor_in(node.iter, names):
                        _bind(node.target, names)
        return names

    def is_tensor(self, node: ast.AST) -> bool:
        """Whether ``node`` is (heuristically) a ``torch.Tensor`` where it
        stands."""
        return self._tensor_in(node,
                               self.tensor_names(self.enclosing_function(node)))

    def _tensor_in(self, node: ast.AST, names: Set[str]) -> bool:
        if isinstance(node, ast.Name):
            return node.id in names
        if isinstance(node, ast.Call):
            full = self.resolve(node.func)
            if full.startswith("torch."):
                return full not in _TORCH_NON_TENSOR and not full.startswith(
                    _TORCH_NON_TENSOR_PREFIXES)
            if isinstance(node.func, ast.Attribute):
                return (node.func.attr not in _NON_TENSOR_METHODS
                        and self._tensor_in(node.func.value, names))
            return False
        if isinstance(node, ast.Attribute):
            return (node.attr not in _NON_TENSOR_ATTRS
                    and self._tensor_in(node.value, names))
        if isinstance(node, ast.Subscript):
            return self._tensor_in(node.value, names)
        if isinstance(node, ast.BinOp):
            return (self._tensor_in(node.left, names)
                    or self._tensor_in(node.right, names))
        if isinstance(node, ast.UnaryOp):
            return self._tensor_in(node.operand, names)
        if isinstance(node, ast.Compare):
            if not all(isinstance(op, _ARITH_COMPARE) for op in node.ops):
                return False
            return any(self._tensor_in(x, names)
                       for x in [node.left] + node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self._tensor_in(v, names) for v in node.values)
        if isinstance(node, ast.IfExp):
            return (self._tensor_in(node.body, names)
                    or self._tensor_in(node.orelse, names))
        if isinstance(node, ast.NamedExpr):
            return self._tensor_in(node.value, names)
        return False


def _bind(target: ast.AST, names: Set[str]) -> None:
    if isinstance(target, ast.Name):
        names.add(target.id)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            _bind(e, names)
    elif isinstance(target, ast.Starred):
        _bind(target.value, names)


def parse_module(path: pathlib.Path, relpath: str) -> Optional[ModuleContext]:
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    return ModuleContext(path=path, relpath=relpath, tree=tree,
                         source_lines=source.splitlines())
