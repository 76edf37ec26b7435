"""Dry run: one step of every (arch x shape x mesh), traced as rank 0 of a
fake pod, with its roofline on the H100's published peaks.

Counterpart of ``repro/launch/dryrun.py``.  The JAX package lowers and
compiles each step with ``ShapeDtypeStruct`` stand-ins on 512 emulated
devices and reads XLA's cost and memory analyses.  The port has no
compiler to ask, so "lowering" here means running the step once, eagerly,
as rank 0 of a fake process group (``launch/fake_card.py``): 256 ranks for
``pod16x16``, 512 for ``pod2x16x16``, ``d x m`` for ``--tiny N`` and
``--mesh-shape DxM``.  The state is made with no storage on a fake card
and laid out by the port's own code: ``trainer.shard_for_training``
(train: FSDP over ``data``, tensor parallelism over ``model``,
``n_data_shards`` agents, K1 over the rank's row) or
``server.shard_for_serving`` (prefill and decode).  The step runs the
card's path: each kernel's launch is abstract (``kernels/abstract.py``)
and no plain version runs.  What it records, per rank:

* the rank's argument bytes: params, moments, batch and cache, each the
  local shards (``utils.tree.tree_bytes``);
* FLOPs: ``FlopCounterMode``'s aten count plus each abstract launch's
  formula (``utils/roofline.py``);
* bytes: each aten op's tensor operands read once and its results written
  once (view ops move nothing), plus each abstract launch's formula;
* ``MemTracker``'s peak, the arguments tracked from the start, so that
  the peak less what it held before the step is what the step allocates;
* the abstract launches by kernel, the collectives by kind with their
  wire bytes (``shard_hints.collective_stats``);
* ``RooflineReport(...).finalize()`` and, for train shapes, K1's own
  fused-against-unfused cost (``ota_fused_cost(total, n_agents,
  mode="adam")``).

There is no depth calibration: XLA's ``cost_analysis`` counts a ``while``
body once, which is why the JAX package lowers shallow unrolled variants
and extrapolates; eager torch runs every layer and every microbatch, so
these counts are already the whole step's.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch X --shape Y --tiny 2

Records go to ``experiments/dryrun_torch/`` (``--out``);
``launch/report.py`` renders them.  ``--all`` traces the combinations in
parallel, one process each, as many at once as the host has cores.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.kernels import abstract
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.fake_card import fake_card, fake_group, on_card
from repro_torch.models import model as model_lib
from repro_torch.telemetry import trace as trace_lib
from repro_torch.utils import shard_hints
from repro_torch.utils.roofline import (
    RooflineReport, model_flops_per_step, ota_fused_cost,
)
from repro_torch.utils.tree import (
    flatten_paths, tree_bytes, tree_leaves, tree_map,
)

OUT_DIR = "experiments/dryrun_torch"


def input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input (no allocation)."""
    return model_lib.abstract_inputs(cfg, shape)


def _default_microbatch(cfg, shape, n_agents: int) -> int:
    """1 sequence per agent per microbatch for big models (keeps the
    microbatch's activations bounded); single-shot for small ones."""
    per_agent = max(shape.global_batch // n_agents, 1)
    if cfg.d_model >= 3072 or shape.seq_len > 8192:
        return per_agent
    return 1


@dataclass
class Lowering:
    """One step of the port on rank 0's fake state: ``run()`` takes it;
    ``args`` holds the rank's arguments by name (``params``,
    ``opt_state``, ``batch``, ``cache``)."""

    run: Callable[[], Any]
    args: Dict[str, Any] = field(default_factory=dict)


def _fake_params(model):
    return tree_map(on_card, model.abstract())


def _fake_batch(cfg, shape, mesh, names) -> Dict[str, Any]:
    """The rank's shards of the ``names`` inputs as DTensors laid out by
    ``data.make_batch_specs``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.models.param import local_shard

    specs = make_batch_specs(cfg, shape, mesh)
    out = {}
    for k, meta in input_specs(cfg, shape).items():
        if k not in names:
            continue
        sh = specs[k]
        out[k] = DTensor.from_local(local_shard(on_card(meta), sh.spec, mesh),
                                    mesh, sh.placements, run_check=False)
    return out


def build_train_lowering(cfg, shape, mesh, *, aggregator: str = "ota",
                         microbatch: Optional[int] = None, fsdp: bool = True,
                         n_agents: Optional[int] = None,
                         **train_kw) -> Tuple[Lowering, Dict[str, Any]]:
    """The sharded train step (``trainer.shard_for_training``) of ``cfg`` at
    ``shape`` on ``mesh``, ``n_agents`` agents (default
    ``n_data_shards(mesh)``); ``train_kw`` goes to ``TrainConfig`` (e.g.
    ``wire_dtype``).  Step 0's draws are injected (unit gains, K1 seed 0):
    a fake card has no generator, and the draws change no count."""
    from repro_torch.train import trainer

    model = model_lib.build(cfg)
    n_agents = n_agents or mesh_lib.n_data_shards(mesh)
    mb = microbatch or _default_microbatch(cfg, shape, n_agents)
    tcfg = trainer.TrainConfig(aggregator=aggregator, n_agents=n_agents,
                               microbatch=mb, total_steps=10_000, **train_kw)
    params = _fake_params(model)
    with unset_fake_temporarily():     # the step counter is a host scalar
        step0 = torch.zeros((), dtype=torch.int32)
    state = trainer.TrainState(
        params=params,
        opt_state=trainer.make_optimizer(tcfg).init(flatten_paths(params)),
        step=step0)
    state, step = trainer.shard_for_training(model, tcfg, state, mesh,
                                             fsdp=fsdp)
    batch = _fake_batch(cfg, shape, mesh, ("tokens", "labels", "memory"))
    draws = None if aggregator == "exact" else (
        torch.ones(n_agents, device="cuda"), 0)
    st = state.opt_state
    args = {"params": state.params, "opt_state": (st.mu, st.nu, st.step),
            "batch": batch}
    return Lowering(run=lambda: step(state, batch, draws), args=args), {
        "microbatch": mb, "n_agents": n_agents}


def build_prefill_lowering(cfg, shape, mesh) -> Tuple[Lowering, Dict]:
    """The sharded prefill (``server.shard_for_serving``) of ``cfg`` at
    ``shape`` on ``mesh``."""
    from repro_torch.train import server

    model = model_lib.build(cfg)
    srv = server.shard_for_serving(model, _fake_params(model), mesh)
    batch = _fake_batch(cfg, shape, mesh, ("tokens", "memory"))
    args = {"params": srv.params, "batch": batch}
    return Lowering(run=lambda: srv.prefill(batch["tokens"],
                                            batch.get("memory")),
                    args=args), {}


def build_decode_lowering(cfg, shape, mesh) -> Tuple[Lowering, Dict]:
    """One sharded decode step (``ShardedServer.make_serve_step``) of
    ``cfg`` at ``shape`` on ``mesh``: a cache of ``serve_capacity`` slots
    full up to ``seq_len - 1``, as ``server.init_cache_for_shape``."""
    from repro_torch.models import transformer
    from repro_torch.train import server

    model = model_lib.build(cfg)
    srv = server.shard_for_serving(model, _fake_params(model), mesh)
    b = shape.global_batch
    cache = srv.init_cache(b, model_lib.serve_capacity(cfg, shape.seq_len),
                           transformer.cross_len(cfg, shape.seq_len))
    cache = cache._replace(pos=shape.seq_len - 1)
    token = on_card(input_specs(cfg, shape)["token"])
    step = srv.make_serve_step(shape)
    args = {"params": srv.params, "cache": cache, "batch": {"token": token}}
    return Lowering(run=lambda: step(cache, token), args=args), {}


class _Traffic(TorchDispatchMode):
    """Bytes the aten ops move: each op's tensor operands read once and
    its tensor results written once; a view op moves nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for x in tree_flatten((args, kwargs, out))[0]:
                if isinstance(x, torch.Tensor):
                    self.bytes += x.numel() * x.element_size()
        return out


@dataclass
class Traced:
    """What one traced step counted (per rank)."""

    aten_flops: float
    aten_bytes: float
    kernel_flops: Dict[str, float]
    kernel_bytes: Dict[str, float]
    launches: Dict[str, int]
    collectives: Any                 # utils.collectives.CollectiveStats
    collective_counts: Dict[str, int]
    memory: Dict[str, int]           # MemTracker's peak by kind, bytes
    memory_before: Dict[str, int]    # ... and before the step (arguments)
    arg_bytes: Dict[str, int]
    seconds: float


def _mem_snapshot(tracker, kind: str = "peak") -> Dict[str, int]:
    """A MemTracker snapshot (``"peak"`` or ``"current"``) summed over
    devices, by kind."""
    out: Dict[str, int] = {}
    for per_dev in tracker.get_tracker_snapshot(kind).values():
        for kind, n in per_dev.items():
            name = str(getattr(kind, "value", kind))
            out[name] = out.get(name, 0) + int(n)
    return out


def trace(lowering: Lowering, label: str = "dryrun") -> Traced:
    """Run ``lowering`` once (inside ``fake_card``) under the counters."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    shard_hints.reset_counts()
    abstract.reset()
    flops = FlopCounterMode(display=False)
    mem = MemTracker()
    # the arguments exist before the step: known to the tracker, so its
    # peak less what it holds at the start is what the step allocates
    mem.track_external(*(x.to_local() if hasattr(x, "to_local") else x
                         for x in tree_leaves(lowering.args)))
    before = _mem_snapshot(mem, "current")
    traffic = _Traffic()
    with trace_lib.span(label) as sp:
        with flops, mem, traffic:
            lowering.run()
    return Traced(
        aten_flops=float(flops.get_total_flops()),
        aten_bytes=float(traffic.bytes),
        kernel_flops=dict(abstract.FLOPS), kernel_bytes=dict(abstract.BYTES),
        launches=dict(abstract.LAUNCHES),
        collectives=shard_hints.collective_stats(),
        collective_counts=shard_hints.counts(),
        memory=_mem_snapshot(mem), memory_before=before,
        arg_bytes={k: tree_bytes(v) for k, v in lowering.args.items()},
        seconds=sp.duration_us / 1e6)


def analyze(traced: Traced, cfg, shape, mesh_name: str, n_chips: int,
            extra: Dict[str, Any]) -> Dict[str, Any]:
    """The record of one traced combination (the JAX package's keys where
    they have a meaning here)."""
    coll = traced.collectives
    kflops = sum(traced.kernel_flops.values())
    kbytes = sum(traced.kernel_bytes.values())
    flops = traced.aten_flops + kflops
    hbm_bytes = traced.aten_bytes + kbytes
    total, active = cfg.param_counts()
    mf_total = model_flops_per_step(
        n_params_active=active, tokens=shape.tokens_per_step,
        training=shape.kind == "train")
    report = RooflineReport(
        arch=cfg.arch_id, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=flops, hlo_bytes=hbm_bytes,
        collective_bytes=coll.total_bytes,
        model_flops=mf_total / n_chips).finalize()
    ota_est = None
    if shape.kind == "train":
        ota_est = ota_fused_cost(total, int(extra.get("n_agents", 1)),
                                 mode="adam")
    args_total = sum(traced.arg_bytes.values())
    peak = traced.memory.get("Total", 0)
    step_peak = peak - traced.memory_before.get("Total", 0)
    return {
        "arch": cfg.arch_id,
        "shape": shape.name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "n_chips": n_chips,
        "params_total": total,
        "params_active": active,
        "ota_fused_roofline": ota_est,
        "collectives_rolled": {
            "bytes_by_kind": coll.bytes_by_kind,
            "count_by_kind": coll.count_by_kind,
            "total_bytes": coll.total_bytes,
        },
        "roofline": report.row(),
        "microbatch": extra.get("microbatch"),
        "n_agents": extra.get("n_agents"),
        "flops": {"aten": traced.aten_flops, "kernels": kflops,
                  "total": flops,
                  "by_kernel": abstract.by_kernel(traced.kernel_flops)},
        "bytes": {"aten": traced.aten_bytes, "kernels": kbytes,
                  "total": hbm_bytes,
                  "by_kernel": abstract.by_kernel(traced.kernel_bytes)},
        "launches": {"by_name": traced.launches,
                     "by_kernel": abstract.by_kernel(traced.launches)},
        "memory": {"argument_bytes": traced.arg_bytes,
                   "argument_total": args_total, "peak": traced.memory,
                   "before": traced.memory_before, "step_peak": step_peak,
                   "total": args_total + step_peak},
        "collective_counts": traced.collective_counts,
        "t_trace_s": traced.seconds,
    }


def make_mesh(*, multi_pod: bool = False, tiny: int = 0,
              mesh_shape: str = ""):
    """``(mesh, name)``: the pod mesh (or ``--tiny``/``--mesh-shape``'s)
    over a fake group of as many ranks, this process its rank 0."""
    if tiny:
        fake_group(tiny * tiny)
        return mesh_lib.make_tiny_mesh(tiny, tiny), f"tiny{tiny}x{tiny}"
    if mesh_shape:
        d, m = (int(x) for x in mesh_shape.split("x"))
        fake_group(d * m)
        return mesh_lib.make_tiny_mesh(d, m), f"pod{d}x{m}"
    fake_group(512 if multi_pod else 256)
    return (mesh_lib.make_production_mesh(multi_pod=multi_pod),
            "pod2x16x16" if multi_pod else "pod16x16")


def lower(cfg, shape, mesh, *, aggregator: str = "ota",
          microbatch: Optional[int] = None, fsdp: bool = True,
          **train_kw) -> Tuple[Lowering, Dict[str, Any]]:
    """The lowering of one combination (inside ``fake_card``);
    ``train_kw`` goes to :func:`build_train_lowering`."""
    if shape.kind == "train":
        return build_train_lowering(cfg, shape, mesh, aggregator=aggregator,
                                    microbatch=microbatch, fsdp=fsdp,
                                    **train_kw)
    if shape.kind == "prefill":
        return build_prefill_lowering(cfg, shape, mesh)
    return build_decode_lowering(cfg, shape, mesh)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            tiny: int = 0, out_dir: str = OUT_DIR, aggregator: str = "ota",
            microbatch: Optional[int] = None, fsdp: bool = True,
            verbose: bool = True, mesh_shape: str = "", tag: str = "",
            cfg=None, train_kw: Optional[Dict[str, Any]] = None
            ) -> Dict[str, Any]:
    """Trace one combination and write its record to ``out_dir`` (none
    when empty).  ``cfg`` replaces ``get_config(arch)`` (a smoke config, a
    cut depth), ``shape_name`` may be an ``InputShape``, ``train_kw`` goes
    to :func:`build_train_lowering` (``n_agents``, ``TrainConfig``
    fields)."""
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name) if isinstance(shape_name, str) \
        else shape_name
    mesh, mesh_name = make_mesh(multi_pod=multi_pod, tiny=tiny,
                                mesh_shape=mesh_shape)
    with fake_card():
        with trace_lib.span("dryrun.build") as built:
            lowering, extra = lower(cfg, shape, mesh, aggregator=aggregator,
                                    microbatch=microbatch, fsdp=fsdp,
                                    **(train_kw or {}))
        traced = trace(lowering)
        del lowering
    record = analyze(traced, cfg, shape, mesh_name, mesh.size(), extra)
    record["t_build_s"] = built.duration_us / 1e6
    record["aggregator"] = aggregator if shape.kind == "train" else None

    if verbose:
        r = record["roofline"]
        print(
            f"[{arch} x {shape.name} x {mesh_name}] "
            f"trace={record['t_trace_s']:.1f}s "
            f"bytes/rank={record['memory']['total'] / 1e9:.3f}GB "
            f"compute={r['compute_s']*1e3:.3f}ms "
            f"memory={r['memory_s']*1e3:.3f}ms "
            f"coll={r['collective_s']*1e3:.3f}ms "
            f"dominant={r['dominant']} mfu={r['mfu']:.4f}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fn = f"{arch}_{shape.name}_{mesh_name}{suffix}.json".replace("/", "_")
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(record, f, indent=1)
    return record


def _combo(job) -> Tuple[str, str, Optional[str]]:
    """Run one combination; its traceback (None on success)."""
    arch, shape, kw = job
    try:
        run_one(arch, shape, **kw)
        return arch, shape, None
    except Exception:
        return arch, shape, traceback.format_exc()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tiny", type=int, default=0,
                    help="use a (tiny x tiny) mesh instead of production")
    ap.add_argument("--mesh-shape", default="",
                    help="(data x model) factorisation, e.g. 32x8")
    ap.add_argument("--aggregator", default="ota", choices=("ota", "exact"))
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]
    kw = dict(multi_pod=args.multi_pod, tiny=args.tiny, out_dir=args.out,
              aggregator=args.aggregator, microbatch=args.microbatch,
              fsdp=not args.no_fsdp, mesh_shape=args.mesh_shape,
              tag=args.tag)
    jobs = [(a, s, kw) for a, s in combos]
    failures = []

    def report(results):
        for arch, shape, err in results:
            if err is not None:
                print(f"FAILED: {arch} x {shape}\n{err}", flush=True)
                failures.append((arch, shape))

    if len(jobs) > 1:
        # one process a combination, as many at once as the host has cores
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(
                min(len(jobs), os.cpu_count() or 1)) as pool:
            report(pool.imap_unordered(_combo, jobs))
    else:
        report(_combo(j) for j in jobs)
    if failures:
        print("failures:", failures)
        return 1
    print(f"all {len(combos)} combination(s) traced OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
