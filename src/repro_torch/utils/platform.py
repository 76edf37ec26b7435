"""The port's platform record, ``describe()``.

Counterpart of ``repro/utils/platform.py::describe``: what a run ledger's
``platform`` event says about where the numbers came from.  Here that is the
Python, torch and CUDA versions and the visible cards (name, compute
capability, count).  The JAX module's XLA flags, x64 switch and emulated
host devices have no meaning for PyTorch and are not ported.
"""
from __future__ import annotations

import platform as _platform
from typing import Any, Dict

import torch


def describe() -> Dict[str, Any]:
    """A JSON-ready record of the torch build and the visible devices."""
    rec: Dict[str, Any] = {
        "python": _platform.python_version(),
        "torch": torch.__version__,
        "cuda_build": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count(),
    }
    if rec["cuda_available"]:
        rec["device_name"] = torch.cuda.get_device_name(0)
        rec["capability"] = ".".join(
            str(x) for x in torch.cuda.get_device_capability(0))
    else:
        rec["device_name"] = "cpu"
    return rec
