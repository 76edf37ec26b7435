"""Device meshes: counterpart of ``repro/launch/mesh.py``.

Three kinds:

* the LLM meshes (``make_tiny_mesh``, ``make_production_mesh``): a
  ``torch.distributed`` ``DeviceMesh`` named ``("data", "model")`` (or
  ``("pod", "data", "model")``) over the initialised default group, one
  rank a device, for the sharded serve path (``train.server.
  shard_for_serving``); ``gloo`` on the CPU, ``nccl`` on the cards, as
  below;
* a :class:`Mesh` is a grid of ``torch.device`` s with named axes, the shape
  ``core/distribute.py`` lays a sweep partition's lanes and Monte-Carlo runs
  across (``mode="sharded"``).  Nothing here touches a device until a
  partition runs on it, and a mesh may list one device more than once (a
  CPU mesh of four ``torch.device("cpu")`` in the tests, ``[cuda:0] * 2``
  on one card);
* an :class:`AgentMesh` is the counterpart of JAX's ``("agents",)`` mesh:
  one process per rank of a ``torch.distributed`` group, each rank on its
  own device with its slice of the fleet (``fedpg.run(agent_mesh=)``,
  ``ota.aggregate(mesh=)``, ``trainer.make_psum_train_step``).  JAX's
  ``shard_map`` is one program over the mesh; here every rank runs the
  same program and the cross-rank sums are ``all_reduce`` s.  The backend
  follows the device: ``gloo`` on the CPU, ``nccl`` on the card
  (``cuda:rank``); nothing falls back from one to the other.
  :func:`run_local` spawns the ranks of a group on this host (the tests and
  ``chip_smoke.py`` use it); under ``torchrun`` initialise the group
  yourself and call :func:`make_agent_mesh` on every rank.
"""
from __future__ import annotations

import io
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["AGENT_AXIS", "AgentMesh", "Mesh", "RankError",
           "make_agent_mesh", "make_production_mesh", "make_sweep_mesh",
           "make_tiny_mesh", "n_data_shards", "run_local"]

AGENT_AXIS = "agents"
# Collectives an AgentMesh issued in this process, counted where each is
# issued (chip_smoke.py and the tests read them beside K1's launch count).
ALL_REDUCES = 0
ALL_GATHERS = 0


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


def _llm_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over every rank of
    the initialised default group, on the backend's device type."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("an LLM mesh needs an initialised torch."
                           "distributed group (launch.mesh.run_local, or "
                           "init_process_group under torchrun)")
    n = int(np.prod(shape))
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_rank_device().type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's pod meshes: ``("data", "model")`` (16, 16) = 256
    ranks; multi-pod ``("pod", "data", "model")`` (2, 16, 16) = 512.  The
    group must hold exactly that many ranks."""
    if multi_pod:
        return _llm_mesh((2, 16, 16), ("pod", "data", "model"))
    return _llm_mesh((16, 16), ("data", "model"))


def make_tiny_mesh(data: int = 2, model: int = 2):
    """A ``("data", "model")`` mesh of ``data x model`` ranks, the whole
    default group (four ``gloo`` ranks in the tests; one ``nccl`` rank
    a card)."""
    return _llm_mesh((data, model), ("data", "model"))


def n_data_shards(mesh) -> int:
    """Number of OTA 'agents' = data-parallel replica groups."""
    from repro_torch.models.param import mesh_shape

    shape = mesh_shape(mesh)
    n = 1
    for axis in ("pod", "data"):
        n *= shape.get(axis, 1)
    return n


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


# ---------------------------------------------------------------------------
# The agent mesh: one rank of a torch.distributed group per slice of the fleet
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class AgentMesh:
    """This rank's view of an agent mesh: the process ``group`` (None is
    the default group), this ``rank`` in it, the group's ``size``, this
    rank's ``device`` and the axis name.  :meth:`all_reduce` and
    :meth:`all_gather` are the only collectives the agent-mesh forms issue;
    each adds one to its module counter."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis_name: str = AGENT_AXIS

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the group, in place; returns ``x``."""
        global ALL_REDUCES
        _check_on(x, self.device)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        ALL_REDUCES += 1
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (one shape on every rank), joined along
        ``dim`` in rank order."""
        global ALL_GATHERS
        _check_on(x, self.device)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        ALL_GATHERS += 1
        return torch.cat(parts, dim)


def _check_on(x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"a collective of this rank takes tensors on "
                         f"{device}, got {x.device}")


def _rank_device() -> torch.device:
    """The device the default group's backend serves: this process's
    current card under ``nccl``, the CPU under ``gloo``."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_agent_mesh(n_shards: Optional[int] = None) -> Optional[AgentMesh]:
    """The agent mesh over the first ``n_shards`` ranks of the initialised
    default group (all of them by default); more than the group holds
    raises, as JAX's does beyond its device count.  Every rank of the
    default group must call it (a smaller mesh is a new group, which all
    ranks create together); ranks outside the mesh get None.  A rank's
    device is the backend's: this process's current card under ``nccl``,
    the CPU under ``gloo``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_agent_mesh needs an initialised "
                           "torch.distributed group (launch.mesh.run_local, "
                           "or init_process_group under torchrun)")
    world = dist.get_world_size()
    if n_shards is None:
        n_shards = world
    if n_shards < 1 or n_shards > world:
        raise ValueError(f"n_shards={n_shards} out of range for a group of "
                         f"{world} ranks")
    rank = dist.get_rank()
    group = None if n_shards == world else dist.new_group(
        list(range(n_shards)))
    if rank >= n_shards:
        return None
    return AgentMesh(group=group, rank=rank, size=n_shards,
                     device=_rank_device())


class RankError(RuntimeError):
    """A rank of :func:`run_local` raised or died; ``rank`` and the rank's
    traceback (``rank_traceback``) say where.  The rank's own exception,
    when it could be sent back, is the ``__cause__``."""

    def __init__(self, rank: int, rank_traceback: str):
        super().__init__(f"rank {rank} failed:\n{rank_traceback}")
        self.rank = rank
        self.rank_traceback = rank_traceback


def _cpu_tensor(x):
    return x


class _HostPickler(pickle.Pickler):
    """Pickles a rank's result by value with every CUDA tensor moved to
    the CPU, so nothing of the rank's device or memory outlives it."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            return _cpu_tensor, (obj.detach().cpu(),)
        return NotImplemented


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _rank_main(fn, rank: int, world: int, store: str, device_type: str,
               timeout: float, args: tuple, results) -> None:
    """One spawned rank: join the group, build the mesh, run ``fn``, send
    back its result (or its exception and traceback).  A failing rank's
    message is flushed before it leaves the group, so it reaches the
    caller before the errors its departure raises on the other ranks."""
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"file://{store}", world_size=world, rank=rank,
            timeout=timedelta(seconds=timeout))
        results.put((rank, True, _dumps(fn(make_agent_mesh(), *args))))
    except Exception as exc:   # sent back to the caller, re-raised there
        try:
            cause = pickle.dumps(exc)
        except (pickle.PicklingError, TypeError, AttributeError):
            cause = None
        results.put((rank, False, (traceback.format_exc(), cause)))
        results.close()
        results.join_thread()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _raise_if_dead(procs, then: str = "") -> None:
    """Raise for a rank that exited with an error code: it died without
    sending anything back (a rank that raises sends its error and exits
    with 0)."""
    for r, p in enumerate(procs):
        if p.exitcode not in (None, 0):
            raise RankError(r, f"exited with code {p.exitcode} and sent "
                               f"nothing back{then}")


_POLL_S = 0.5        # how long the caller waits on the results a poll
_GRACE_POLLS = 40    # a failing rank's peers: 2 s for a dead rank to show
_JOIN_S = 30.0       # a rank that has sent its result exits within this


def _loads_cause(cause: Optional[bytes]) -> Optional[BaseException]:
    """A rank's exception, when it unpickles here."""
    try:
        return None if cause is None else pickle.loads(cause)
    except Exception:
        return None


def run_local(fn: Callable[..., Any], world_size: int, *args,
              device: str = "cuda", timeout: float = 600.0) -> List[Any]:
    """Spawn ``world_size`` ranks on this host, join them in one group and
    return every rank's ``fn(mesh, *args)``, in rank order.

    ``device="cuda"``: rank r runs on ``cuda:r`` under ``nccl`` (the host
    needs ``world_size`` cards); ``device="cpu"``: ``gloo``, one thread per
    rank.  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function); the results come back by value, CUDA tensors on the CPU.
    The rendezvous is a ``file://`` store in a fresh temporary directory.
    A rank that raises or dies fails the call with :class:`RankError` (the
    other ranks are stopped); after ``timeout`` seconds with no result
    every rank is stopped and the call raises ``TimeoutError``, so it never
    hangs."""
    device_type = torch.device(device).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"run_local runs ranks on 'cuda' or 'cpu', got "
                         f"{device!r}")
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if device_type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks on cuda need as many cards; "
                           f"{torch.cuda.device_count()} visible")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="agent_mesh_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world_size, os.path.join(tmp, "store"), device_type, timeout,
        args, results)) for r in range(world_size)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        idle = 0
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=_POLL_S)
            except queue.Empty:
                _raise_if_dead(procs)
                idle += 1
                if idle * _POLL_S > timeout:
                    raise TimeoutError(
                        f"run_local: {world_size - len(out)} rank(s) sent "
                        f"nothing for {timeout} s")
                continue
            if not ok:
                # a rank that died takes the others' collectives down with
                # it: name the dead rank, not the first to notice
                tb, cause = payload
                for _ in range(_GRACE_POLLS):
                    _raise_if_dead(procs, f"; rank {rank} then failed:\n{tb}")
                    time.sleep(_POLL_S / 10)
                raise RankError(rank, tb) from _loads_cause(cause)
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=_JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
