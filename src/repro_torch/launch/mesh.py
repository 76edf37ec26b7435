"""Sweep-shaped device meshes: counterpart of ``repro/launch/mesh.py``'s
``make_sweep_mesh``.

A :class:`Mesh` is a grid of ``torch.device`` s with named axes, the shape
``core/distribute.py`` lays a sweep partition's lanes and Monte-Carlo runs
across (``mode="sharded"``).  Nothing here touches a device until a
partition runs on it, and a mesh may list one device more than once (a CPU
mesh of four ``torch.device("cpu")`` in the tests, ``[cuda:0] * 2`` on one
card).  The LLM meshes and the agent mesh of the JAX module are not here:
the agent-mesh forms come with the next slice (``ROADMAP.md``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_sweep_mesh"]


@dataclass(frozen=True)
class Mesh:
    """``devices``: an object array of ``torch.device`` s, one axis per
    name in ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-axis device grid needs "
                             f"as many names, got {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> its length, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _grid(devices: Sequence[torch.device], shape) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    return grid.reshape(shape)


def make_sweep_mesh(lane_shards: Optional[int] = None, mc_shards: int = 1,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A ``("lane", "mc")`` mesh for ``sweep(mode="sharded")``: the lanes
    (the scenario axis of one partition) lie across ``lane``, the
    Monte-Carlo runs across ``mc``.  ``devices`` defaults to every visible
    CUDA device, and the lane axis to all of them; a request for more
    devices than there are raises, as it does without a GPU."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if mc_shards < 1:
        raise ValueError(f"mc_shards must be >= 1, got {mc_shards}")
    if lane_shards is not None and lane_shards < 1:
        raise ValueError(f"lane_shards must be >= 1, got {lane_shards}")
    if lane_shards is None:
        lane_shards = max(len(devices) // mc_shards, 1)
    n = lane_shards * mc_shards
    if n > len(devices):
        hint = "" if devices else " (no CUDA device is visible: pass devices=)"
        raise ValueError(f"mesh wants {lane_shards}x{mc_shards}={n} devices "
                         f"but only {len(devices)} are available{hint}")
    return Mesh(_grid(devices[:n], (lane_shards, mc_shards)), ("lane", "mc"))
