"""Build and sync counting as importable checkers.

The port's form of ``repro/analyze/budget.py``.  JAX counts XLA backend
compilations; the port compiles nothing at run time but its kernels (one
``nvcc`` per source, loaded once with ``ctypes``), and what JAX's compile
cache saves, the port saves by reusing its lane programs
(``core.lanes.lanes_for``).  So a :class:`BuildCounter` counts, while it is
open:

* ``nvcc`` builds and library loads by source name
  (``kernels.build.BUILT`` / ``LOADED``, kept where ``build.build`` and
  ``build.load`` make them);
* lane-program constructions: each ``_Lanes`` made
  (``core.lanes.LANES_BUILT``) and each partition's lane function that
  ``sweep`` and ``sweep.lane_program`` make (``core.sweep.LANE_PROGRAMS``).

A :class:`SyncCounter` counts host-device synchronisations on the card:
``torch.cuda.set_sync_debug_mode("warn")`` makes PyTorch warn at every
synchronising call it makes itself (a device-to-host copy, ``.item()``,
``nonzero``, a blocking copy), and the counter records those warnings.  A
kernel launched through ``ctypes`` (K1) is invisible to it, and so is a
``torch.cuda.synchronize()``: the count covers the syncs PyTorch's own ops
make.  It raises on a host without CUDA.

``analyze.contracts``' ``build-budget`` and ``host-sync`` checks use these;
nesting counters of one kind is not supported.
"""
from __future__ import annotations

import warnings
from typing import Dict, List


def process_builds() -> Dict[str, Dict[str, int]]:
    """This process's builds and loads so far, by source name."""
    from repro_torch.kernels import build

    return {"built": dict(build.BUILT), "loaded": dict(build.LOADED)}


class BuildCounter:
    """``with BuildCounter() as c: ...``: ``c.builds`` / ``c.loads`` (by
    source name), ``c.lanes`` (``_Lanes`` made) and ``c.lane_programs``
    (partitions' lane functions made) inside the block."""

    def __init__(self):
        self.builds: Dict[str, int] = {}
        self.loads: Dict[str, int] = {}
        self.lanes = 0
        self.lane_programs = 0

    def __enter__(self):
        from repro_torch.core import lanes, sweep

        self._start = (process_builds(), lanes.LANES_BUILT,
                       sweep.LANE_PROGRAMS)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import lanes, sweep

        counts, n_lanes, n_programs = self._start
        now = process_builds()
        self.builds = {k: v - counts["built"].get(k, 0)
                       for k, v in now["built"].items()
                       if v != counts["built"].get(k, 0)}
        self.loads = {k: v - counts["loaded"].get(k, 0)
                      for k, v in now["loaded"].items()
                      if v != counts["loaded"].get(k, 0)}
        self.lanes = lanes.LANES_BUILT - n_lanes
        self.lane_programs = sweep.LANE_PROGRAMS - n_programs
        return False


_SYNC_MESSAGE = "called a synchronizing CUDA operation"


class SyncCounter:
    """``with SyncCounter() as c: ...``: ``c.count`` host-device syncs that
    PyTorch reported inside the block (``c.marks()`` reads the running
    count without closing it).  CUDA only (module docstring)."""

    def __init__(self):
        self.count = 0
        self._records: List[warnings.WarningMessage] = []

    def __enter__(self):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("SyncCounter counts syncs with the card: CUDA "
                               "is not available")
        self._prev = torch.cuda.get_sync_debug_mode()
        self._catch = warnings.catch_warnings(record=True)
        self._records = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def marks(self) -> int:
        return sum(_SYNC_MESSAGE in str(w.message) for w in self._records)

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(self._prev)
        self.count = self.marks()
        self._catch.__exit__(*exc)
        return False
