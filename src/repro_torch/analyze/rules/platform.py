"""``device-env``: ad-hoc device and library settings outside their owner.

The port's form of ``repro/analyze/rules/platform.py`` (``xla-flags``).
``repro_torch.utils.device`` owns which device a run takes and how its
generators are made.  Environment variables that steer CUDA, NCCL or
PyTorch (``CUDA_*``, ``NCCL_*``, ``TORCH_*``, ``PYTORCH_*``) and the
process-wide ``torch.backends.*`` switches (TF32 matmuls, cuDNN autotuning,
SDPA backends) change what every later kernel computes or where it runs,
for the whole process: set from some module, they silently alter the
numbers of code that never asked.  The rule flags every mutation outside
the owning module:

* ``os.environ["CUDA_..."] = ...`` (and ``+=``);
* ``os.environ.setdefault(...)`` / ``os.environ.update(...)`` /
  ``os.putenv(...)`` naming such a variable;
* an assignment to a ``torch.backends.*`` attribute.

Reads (``os.environ.get("CUDA_VISIBLE_DEVICES")``) are fine.
``chip_smoke.py`` pins its timings' matmul precision this way on purpose;
it is not a default root, and scanned it shows those lines.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analyze.astutils import ModuleContext, dotted_name
from repro_torch.analyze.findings import Finding
from repro_torch.analyze.rules import Rule, register_rule

PREFIXES = ("CUDA_", "NCCL_", "TORCH_", "PYTORCH_")
_FIX = "route device and library settings through repro_torch.utils.device"


def _guarded(value) -> bool:
    return isinstance(value, str) and value.startswith(PREFIXES)


def _is_environ_sub(node: ast.AST) -> bool:
    return (isinstance(node, ast.Subscript)
            and dotted_name(node.value).endswith("environ")
            and isinstance(node.slice, ast.Constant)
            and _guarded(node.slice.value))


def _mentioned(node: ast.AST) -> str:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and _guarded(n.value):
            return n.value
    return ""


@register_rule
class DeviceEnvRule(Rule):
    id = "device-env"
    severity = "error"
    description = ("CUDA_/NCCL_/TORCH_/PYTORCH_ environment or torch.backends "
                   "mutation bypassing repro_torch.utils.device")
    exclude = ("src/repro_torch/utils/device.py",)

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if _is_environ_sub(t):
                        yield ctx.finding(
                            self, node,
                            f"direct os.environ[{t.slice.value!r}] write; "
                            f"{_FIX}")
                    elif isinstance(t, ast.Attribute) and ctx.resolve(
                            t).startswith("torch.backends."):
                        yield ctx.finding(
                            self, node,
                            f"process-wide {ctx.resolve(t)} setting; {_FIX}")
            elif isinstance(node, ast.Call):
                dotted = dotted_name(node.func)
                if (dotted.endswith("environ.setdefault")
                        or dotted.endswith("environ.update")
                        or dotted.endswith("putenv")):
                    var = _mentioned(node)
                    if var:
                        yield ctx.finding(
                            self, node,
                            f"{dotted.rpartition('.')[2]}() mutation of "
                            f"{var}; {_FIX}")
