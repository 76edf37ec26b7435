"""Device resolution for the port's entry points.

Counterpart of ``repro/utils/platform.py`` without emulated devices: the
default device is ``cuda``.  A run that asks for no device on a machine with
no GPU raises instead of falling back to the CPU, so a measurement can never
silently come from the wrong device.  Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is visible); anything else
    goes through ``torch.device`` and is checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = (" (pass device='cpu' to run the plain PyTorch path)"
                if device is None else "")
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available{hint}")
    return dev


def make_generator(seed: int, device: DeviceLike) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` — the
    counterpart of ``jax.random.key(seed)``; draws on a CUDA tensor need a
    generator of the same device."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
