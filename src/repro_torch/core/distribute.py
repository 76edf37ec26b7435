"""Device-mesh execution for the sweep engine: lanes x Monte-Carlo runs on
a mesh.

Counterpart of the lane-placement half of ``repro/core/distribute.py``.
``sweep(..., mode="sharded")`` lays each partition's (scenarios x runs)
batch across a ``("lane", "mc")`` mesh (``launch/mesh.py``):

* the scenarios (the lane axis) split across ``"lane"``; a count the axis
  does not divide is padded with copies of the last scenario
  (:func:`pad_lanes`), which run and are dropped when the results are
  gathered;
* the Monte-Carlo seeds split across ``"mc"`` when ``mc_runs`` divides it;
  otherwise every cell of a lane row runs every seed, and the row's first
  device alone runs them (the JAX package runs such a replicated program on
  every device of the row, with the same result);
* a partition whose scenarios pack to nothing (the replicate path: one
  scenario runs and every scenario takes its history) spreads its seeds
  over the whole mesh when ``mc_runs`` divides the mesh's size, and runs on
  the mesh's first device otherwise.

Each mesh cell runs ``lanes.run_lanes`` on its device for its scenarios x
seeds (:func:`dispatch_partition`): the cells launch one after another with
no host synchronisation, so the device work of a partition overlaps the
host's set-up of the next, and the sweep gathers every partition after its
dispatch loop (:func:`gather`: one device-to-host copy per leaf per
partition).  Eager PyTorch compiles nothing, so there is no ``compile``
span: a partition records ``dispatch`` here and ``materialize`` in the
sweep.

The contract: the result is bitwise ``mode="vmap"``'s.  It follows from the
lane contract of ``core/lanes.py`` (lane l of a lane-batched run is bitwise
``fedpg.run`` of its settings and seed, whatever the other lanes are), under
any grouping of the lanes into cells.  A cell runs with its device
current, and every kernel wrapper makes its operands' device current for
its launch, so a cell on another card launches there.  One H100 verifies
only the one-device mesh and a mesh that lists one device more than once;
``tests/test_torch_cuda.py::test_sharded_cells_launch_k1_on_their_own_card``
runs the mesh over every visible card, so only a host with two or more
checks the placement across cards.
The agent-mesh forms (``agent_mesh_for``, ``fedpg.run(agent_mesh=)``) come
with the next slice (``ROADMAP.md``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fedpg import History
from repro_torch.launch.mesh import Mesh, make_sweep_mesh
from repro_torch.telemetry import trace as rtrace
from repro_torch.telemetry.probes import RoundTelemetry

LANE_AXIS = "lane"
MC_AXIS = "mc"

__all__ = [
    "LANE_AXIS", "MC_AXIS", "Cell", "Placement", "default_sweep_mesh",
    "dispatch_partition", "gather", "pad_lanes", "place_partition",
    "plan_placement",
]


def default_sweep_mesh() -> Mesh:
    """Every visible CUDA device on the lane axis (``("lane", "mc")``)."""
    return make_sweep_mesh()


@dataclass(frozen=True)
class Cell:
    """One mesh cell's share of a partition: its ``device``, a slice of the
    padded lane axis (``None`` on the replicate path) and a slice of the
    seeds."""

    device: torch.device
    lanes: Optional[slice]
    runs: slice


@dataclass(frozen=True)
class Placement:
    """How one partition's (lanes x mc_runs) batch lands on the mesh.
    ``n_lanes == 0`` marks the replicate path; ``n_pad`` copies of the last
    lane fill the lane axis to a multiple of the mesh's lane dimension;
    ``cells`` in lane-major order."""

    mesh: Mesh
    n_lanes: int
    n_pad: int
    cells: Tuple[Cell, ...]

    @property
    def n_devices(self) -> int:
        return self.mesh.size


def _lane_grid(mesh: Mesh) -> np.ndarray:
    """The mesh's devices as a ``(lane, mc)`` grid."""
    names = tuple(mesh.axis_names)
    if LANE_AXIS not in names:
        raise ValueError(
            f"sweep mesh needs a {LANE_AXIS!r} axis; got {names} (build one "
            f"with launch.mesh.make_sweep_mesh)")
    if set(names) - {LANE_AXIS, MC_AXIS}:
        raise ValueError(f"a sweep mesh has only the axes {LANE_AXIS!r} and "
                         f"{MC_AXIS!r}; got {names}")
    order = [names.index(LANE_AXIS)] + (
        [names.index(MC_AXIS)] if MC_AXIS in names else [])
    grid = np.transpose(mesh.devices, order)
    return grid.reshape(grid.shape[0], -1)


def plan_placement(mesh: Mesh, n_lanes: int, mc_runs: int) -> Placement:
    """Choose each cell's lanes and seeds for one partition (module
    docstring): the lanes split over ``"lane"``, padded to a multiple of
    it; the seeds over ``"mc"`` when ``mc_runs`` divides it.  With nothing
    packed (``n_lanes == 0``) the seeds split over the whole mesh when
    ``mc_runs`` divides its size, else one device runs them all."""
    grid = _lane_grid(mesh)
    lane_d, mc_d = grid.shape
    if n_lanes == 0:
        flat = list(mesh.devices.flat)
        if mesh.size > 1 and mc_runs % mesh.size == 0:
            per = mc_runs // mesh.size
            cells = tuple(Cell(d, None, slice(i * per, (i + 1) * per))
                          for i, d in enumerate(flat))
        else:
            cells = (Cell(flat[0], None, slice(0, mc_runs)),)
        return Placement(mesh=mesh, n_lanes=0, n_pad=0, cells=cells)
    n_pad = -n_lanes % lane_d
    per_lane = (n_lanes + n_pad) // lane_d
    split = mc_d if mc_d > 1 and mc_runs % mc_d == 0 else 1
    per_run = mc_runs // split
    cells = tuple(
        Cell(grid[i, j], slice(i * per_lane, (i + 1) * per_lane),
             slice(j * per_run, (j + 1) * per_run))
        for i in range(lane_d) for j in range(split))
    return Placement(mesh=mesh, n_lanes=n_lanes, n_pad=n_pad, cells=cells)


def pad_lanes(packed: Any, n_pad: int) -> Any:
    """Append ``n_pad`` copies of the last lane to every leaf of
    ``packed`` (nested dicts of tensors, or a list of lanes such as a
    partition's scenarios).  The copies run as lanes of their own and
    are dropped when the results are gathered."""
    if n_pad == 0:
        return packed
    if isinstance(packed, dict):
        return {k: pad_lanes(v, n_pad) for k, v in packed.items()}
    if isinstance(packed, torch.Tensor):
        return torch.cat([packed] + [packed[-1:]] * n_pad)
    return list(packed) + [packed[-1]] * n_pad


Work = List[Tuple[Cell, list, list]]


def place_partition(scenarios: Sequence, seeds: Sequence[int], mesh: Mesh,
                    *, replicate: bool = False) -> Tuple[Work, Placement]:
    """Each cell's ``(cell, scenarios, seeds)`` for one partition, without
    running anything.  ``replicate``: the scenarios pack to nothing, so
    only the first runs (the replicate path)."""
    placement = plan_placement(mesh, 0 if replicate else len(scenarios),
                               len(seeds))
    lanes = pad_lanes(list(scenarios), placement.n_pad)
    seeds = list(seeds)
    work = [(cell, lanes[:1] if cell.lanes is None else lanes[cell.lanes],
             seeds[cell.runs]) for cell in placement.cells]
    return work, placement


def dispatch_partition(lane_fn: Callable[[list, list, torch.device],
                                         History],
                       scenarios: Sequence, seeds: Sequence[int], mesh: Mesh,
                       *, replicate: bool = False
                       ) -> Tuple[List[History], Placement]:
    """Launch one partition on the mesh and return without waiting for the
    device: ``lane_fn(scenarios, seeds, device)`` runs each cell's lanes
    (a History of ``(scenarios, seeds, K)`` leaves on ``device``), inside a
    ``dispatch`` span.  :func:`gather` assembles the cells' outputs."""
    work, placement = place_partition(scenarios, seeds, mesh,
                                      replicate=replicate)
    outs = []
    with rtrace.span("dispatch", lanes=placement.n_lanes,
                     pad=placement.n_pad, devices=mesh.size):
        for cell, scens, cell_seeds in work:
            with _current(cell.device):
                outs.append(lane_fn(scens, cell_seeds, cell.device))
    return outs, placement


def _current(device: torch.device):
    """``device`` as the current CUDA device while its cell runs, so that
    whatever a cell launches without naming a device lands there too."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _assemble(parts: List[torch.Tensor], placement: Placement
              ) -> torch.Tensor:
    """The cells' ``(lanes, runs, ...)`` leaves as one tensor on the first
    cell's device: runs joined within a lane row, rows joined, the pad
    lanes dropped."""
    dev = placement.cells[0].device
    rows: dict = {}
    for cell, x in zip(placement.cells, parts):
        key = 0 if cell.lanes is None else cell.lanes.start
        rows.setdefault(key, []).append(x.to(dev))
    out = torch.cat([torch.cat(rows[k], 1) for k in sorted(rows)], 0)
    return out if placement.n_lanes == 0 else out[:placement.n_lanes]


def gather(outs: List[History], placement: Placement) -> History:
    """One History over the partition's real lanes and every seed, on the
    first cell's device (the replicate path keeps its one lane)."""
    def leaf(xs):
        return None if xs[0] is None else _assemble(list(xs), placement)

    tel = None
    if outs[0].telemetry is not None:
        tel = RoundTelemetry(*(leaf(xs) for xs in
                               zip(*(h.telemetry for h in outs))))
    return History(*(leaf(xs) for xs in zip(*outs)), telemetry=tel)
