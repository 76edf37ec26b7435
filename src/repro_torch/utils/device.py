"""Device resolution for the port's entry points.

Counterpart of ``repro/utils/platform.py`` without emulated devices: the
default device is ``cuda``.  A run that asks for no device on a machine with
no GPU raises instead of falling back to the CPU, so a measurement can never
silently come from the wrong device.  Tests pass ``device="cpu"`` explicitly.

:func:`index_generator` is the port's ``fold_in``: a generator per (seed,
index), so the round service's round k and the trainer's step k draw the
same values fresh or after a resume, and a checkpoint holds no generator
state (a CPU mt19937 state or a CUDA Philox offset would tie it to one
device and one torch version).  ``fedpg.run`` keeps one sequential
generator per run.
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


_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """One splitmix64 step (Steele, Lea and Flood 2014) over a uint64."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def index_seed(seed: int, index: int) -> int:
    """The uint64 seed of draw ``index`` of a run seeded ``seed``: a fixed
    mix of both (splitmix64 of the seed, xor the index, splitmix64 again),
    the same on every machine and torch version.  ``index`` may be
    negative (``-1`` is a run's set-up draw)."""
    return _splitmix64(_splitmix64(int(seed) & _M64) ^ (int(index) & _M64))


def index_generator(seed: int, index: int,
                    device: DeviceLike = None) -> torch.Generator:
    """A generator on ``device`` for draw ``index`` of a run seeded
    ``seed`` — the counterpart of ``jax.random.fold_in(key, index)``.  What
    it draws is a function of ``(seed, index)`` alone, so round (or step)
    ``k`` draws the same values whether the run started at 0 or resumed at
    ``k`` from a checkpoint that holds no generator state."""
    return make_generator(index_seed(seed, index), device)
