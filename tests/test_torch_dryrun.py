"""The port's dry run (``launch/dryrun.py``) against the JAX package's
shardings and against the port's own steps run for real.

One spawned process runs every dry run of this module on fake process
groups (``launch.fake_card``; a group is process-global, so none is
started in pytest's process), beside one group of four ``gloo`` ranks
(``launch.mesh.run_local``) that runs the same smoke train steps for
real; the JAX side runs in this process on ``jax.sharding.AbstractMesh``
(no compile, no host-device flag).

* The bytes a rank holds: params and both moments (``train_4k``), params
  and cache (``decode_32k``, ``long_500k``) of every arch on (16, 16) and
  (2, 16, 16), the dry run's state (DTensors, ``tree_bytes`` of the local
  shards) against the sums of JAX's ``NamedSharding(AbstractMesh,
  spec).shard_shape``.  mamba2-130m's 24 SSD heads on a 16-way ``model``
  axis are refused (``NotImplementedError``, ROADMAP §1 item 3(d)) by the
  dry run's step; its bytes come from the same layout
  (``distribute_params``).
* The collectives by kind of smoke llama3.2-3b's sharded train step at
  (2, 2): the dry run's counts (and wire bytes) equal
  ``shard_hints.counts()`` (``collective_stats()``) of rank 0's real
  ``gloo`` step.
* With ``aggregator="exact"`` (no kernel on the path) the dry run's FLOPs
  equal ``FlopCounterMode``'s count of rank 0's real step.
* The replicated-weights layout (``shard_for_training(..., fsdp=False)``,
  the dry run's ``--no-fsdp``: the weights replicated over ``data``, each
  gradient summed over the batch axes): float32 smoke llama3.2-3b's OTA
  step on (2, 2), with injected draws, against the port's unsharded step
  from the same state, batch and draws (the metrics at rtol 1e-5, the
  state as ``test_torch_sharded_train.py`` holds the sharded step's), and
  its collectives by kind and wire bytes against the dry run's.
* With every plain version in ``kernels/ref.py`` patched to raise, dry runs
  of train, prefill and decode (smoke llama3.2-3b and mamba2-130m at (2,
  2)) complete, launching K1, K3 and K4 abstractly: no plain version is
  traced.
* ``--all``'s CLI is not run here (``PERF.md``); ``main`` on one small
  combination writes a record and ``launch.report`` reads it.
"""
import dataclasses
import math
from concurrent.futures import ProcessPoolExecutor
import multiprocessing

import pytest
import torch

from repro_torch.configs import ARCH_IDS

SMOKE = "llama3.2-3b"
RTOL = 1e-5
DRAWS = ([0.7, 1.3], 777)
BYTES_SHAPES = ("train_4k", "decode_32k", "long_500k")
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PLAIN = ("ota_fused_ref", "ota_fused_sgd_ref", "ota_fused_adam_ref",
         "ota_fused_lanes_ref", "ota_fused_sgd_lanes_ref", "counter_noise",
         "counter_noise_at", "ota_channel_plain", "flash_attention_plain",
         "flash_attention_ref", "ssd_tc", "ssd_sequential_ref")


def _smoke_shape(kind="train"):
    from repro_torch.configs.base import InputShape

    return InputShape(name=f"smoke_{kind}", seq_len=32, global_batch=8,
                      kind=kind)


def _replicated_start():
    """Float32 smoke llama, its train config, initial state, batch and
    draws for the replicated-weights step (the same in every process)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib
    from repro_torch.train import trainer

    cfg = get_smoke_config(SMOKE).with_(dtype="float32")
    m = model_lib.build(cfg)
    shape = _smoke_shape()
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (shape.global_batch,
                                             shape.seq_len), generator=gen)
             for k in ("tokens", "labels")}
    tcfg = trainer.TrainConfig(aggregator="ota", n_agents=2, microbatch=1,
                               total_steps=10_000)
    state = trainer.init_state(m, tcfg, torch.Generator().manual_seed(1))
    return m, tcfg, state, batch, (torch.tensor(DRAWS[0]), DRAWS[1])


def _port_bytes(multi_pod):
    """The dry run's argument bytes a rank, every arch and BYTES_SHAPES."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import get_shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.fake_card import fake_card, on_card
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import distribute_params, train_rules
    from repro_torch.utils.tree import tree_bytes, tree_map

    mesh, _ = dryrun.make_mesh(multi_pod=multi_pod)
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name in BYTES_SHAPES:
            with fake_card():
                try:
                    lowering, _ = dryrun.lower(cfg, get_shape(name), mesh)
                except NotImplementedError as e:
                    m = model_lib.build(cfg)
                    params = distribute_params(
                        tree_map(on_card, m.abstract()), m.plan,
                        train_rules(fsdp=True), mesh)
                    out[arch, name] = {"refused": str(e),
                                       "params": tree_bytes(params)}
                    continue
                a = lowering.args
                rec = {"params": tree_bytes(a["params"])}
                if "opt_state" in a:
                    mu, nu, _ = a["opt_state"]
                    rec.update(mu=tree_bytes(mu), nu=tree_bytes(nu))
                if "cache" in a:
                    rec["cache"] = tree_bytes(a["cache"])
                out[arch, name] = rec
                del lowering
    return out


def _dry_worker():
    """Every dry run of this module, in one spawned process."""
    from unittest import mock

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ref
    from repro_torch.launch import dryrun

    out = {"bytes": {m: _port_bytes(m == "pod2x16x16") for m in MESHES}}
    cfg = get_smoke_config(SMOKE)
    for agg in ("ota", "exact"):
        r = dryrun.run_one(SMOKE, _smoke_shape(), tiny=2, cfg=cfg,
                           aggregator=agg, out_dir="", verbose=False)
        out[agg] = {"counts": r["collective_counts"],
                    "stats": r["collectives_rolled"], "flops": r["flops"],
                    "launches": r["launches"]["by_name"]}
    r = dryrun.run_one(SMOKE, _smoke_shape(), tiny=2, fsdp=False,
                       cfg=cfg.with_(dtype="float32"), out_dir="",
                       verbose=False)
    out["replicated"] = {"counts": r["collective_counts"],
                         "stats": r["collectives_rolled"],
                         "launches": r["launches"]["by_name"]}

    def raising(name):
        def plain(*a, **k):
            raise AssertionError(f"a dry run traced ref.{name}")
        return plain

    traced = {}
    with mock.patch.multiple(ref, **{n: raising(n) for n in PLAIN}):
        traced["train", SMOKE] = dryrun.run_one(
            SMOKE, _smoke_shape(), tiny=2, cfg=cfg, out_dir="",
            verbose=False)["launches"]["by_name"]
        with mock.patch.object(ref, "ssd_ref", raising("ssd_ref")):
            for arch in (SMOKE, "mamba2-130m"):
                for kind in ("prefill", "decode"):
                    traced[kind, arch] = dryrun.run_one(
                        arch, _smoke_shape(kind), tiny=2, out_dir="",
                        cfg=get_smoke_config(arch),
                        verbose=False)["launches"]["by_name"]
    out["traced"] = traced
    return out


def _real_rank(_mesh):
    """Rank r of four ``gloo`` ranks: smoke llama's sharded train step on
    (2, 2), OTA and exact, its collectives and FLOPs counted; then the
    replicated-weights step, its collectives counted and its state
    gathered."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import interop

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    from repro_torch.train import trainer
    from repro_torch.utils import shard_hints

    cfg = get_smoke_config(SMOKE)
    m = model_lib.build(cfg)
    mesh = mesh_lib.make_tiny_mesh(2, 2)
    shape = _smoke_shape()
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (shape.global_batch,
                                             shape.seq_len), generator=gen)
             for k in ("tokens", "labels")}
    out = {}
    for agg in ("ota", "exact"):
        tcfg = trainer.TrainConfig(aggregator=agg, n_agents=2, microbatch=1,
                                   total_steps=10_000)
        state, step = trainer.shard_for_training(
            m, tcfg, trainer.init_state(m, tcfg,
                                        torch.Generator().manual_seed(1)),
            mesh)
        shard_hints.reset_counts()
        with FlopCounterMode(display=False) as fc:
            step(state, batch)
        stats = shard_hints.collective_stats()
        out[agg] = {"counts": shard_hints.counts(),
                    "flops": fc.get_total_flops(),
                    "bytes_by_kind": stats.bytes_by_kind,
                    "count_by_kind": stats.count_by_kind}
    m, tcfg, start, batch, draws = _replicated_start()
    state, step = trainer.shard_for_training(m, tcfg, start, mesh,
                                             fsdp=False)
    shard_hints.reset_counts()
    state, met = step(state, batch, draws)
    stats = shard_hints.collective_stats()
    full = interop.train_state_to_numpy(state)   # every rank gathers
    out["replicated"] = {
        "counts": shard_hints.counts(), "bytes_by_kind": stats.bytes_by_kind,
        "count_by_kind": stats.count_by_kind,
        "metrics": {k: v.item() for k, v in met.items()},
        "state": full if torch.distributed.get_rank() == 0 else None}
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch import mesh as mesh_lib

    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
            "spawn")) as ex:
        dry = ex.submit(_dry_worker)
        real = mesh_lib.run_local(_real_rank, 4, device="cpu", timeout=600)
        return dry.result(timeout=600), real


def _jax_bytes(arch, name, mesh_name):
    """Per-device bytes of JAX's params and moments (train) or params and
    cache (decode) on the AbstractMesh: sums of ``shard_shape``."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

    from repro.configs import get_config
    from repro.configs.shapes import get_shape
    from repro.models import model as model_lib
    from repro.models.param import serve_rules, train_rules
    from repro.train import server

    sizes, names = MESHES[mesh_name]
    mesh = AbstractMesh(sizes, names)
    cfg, shape = get_config(arch), get_shape(name)
    model = model_lib.build(cfg)

    def total(tree, specs, itemsize=None):
        def one(a, spec):
            n = math.prod(NamedSharding(mesh, spec).shard_shape(a.shape))
            return n * (itemsize or a.dtype.itemsize)
        return sum(jax.tree.leaves(jax.tree.map(
            one, tree, specs,
            is_leaf=lambda x: isinstance(x, PartitionSpec))))

    ab = model.abstract()
    if shape.kind == "train":
        specs = model.specs(train_rules(fsdp=True), mesh)
        return {"params": total(ab, specs), "mu": total(ab, specs, 4),
                "nu": total(ab, specs, 4)}
    cache = server.abstract_cache_for_shape(model, shape)
    cspecs = server.cache_specs(cfg, shape, mesh)
    return {"params": total(ab, model.specs(serve_rules(), mesh)),
            "cache": total(cache._replace(pos=None),
                           cspecs._replace(pos=None))}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bytes_per_rank_match_jax(runs, arch, mesh_name):
    dry, _ = runs
    for name in BYTES_SHAPES:
        got = dict(dry["bytes"][mesh_name][arch, name])
        want = _jax_bytes(arch, name, mesh_name)
        if "refused" in got:
            # SSD heads that the model axis does not divide (ROADMAP §1 3(d))
            assert arch == "mamba2-130m" and "SSM" in got["refused"], got
            want = {"params": _jax_bytes(arch, "train_4k",
                                         mesh_name)["params"]}
            got.pop("refused")
        assert got == want, (name, got, want)


def test_llama_params_on_a_pod(runs):
    dry, _ = runs
    got = dry["bytes"]["pod16x16"]["llama3.2-3b", "train_4k"]["params"]
    assert got == 107717376      # 0.1077 GB a device, as JAX's


def test_collective_counts_match_the_gloo_step(runs):
    dry, real = runs
    for agg in ("ota", "exact"):
        assert dry[agg]["counts"] == real[0][agg]["counts"], agg
        assert dry[agg]["stats"]["count_by_kind"] \
            == real[0][agg]["count_by_kind"]
        assert dry[agg]["stats"]["bytes_by_kind"] \
            == real[0][agg]["bytes_by_kind"]
    assert dry["ota"]["counts"]["all_gather"] > 0
    assert dry["ota"]["counts"]["reduce_scatter"] > 0
    assert dry["ota"]["launches"] == {"ota_fused_mapped": 1}


def test_exact_step_flops_match_flop_counter(runs):
    dry, real = runs
    assert dry["exact"]["launches"] == {}
    assert dry["exact"]["flops"]["kernels"] == 0
    assert dry["exact"]["flops"]["total"] == real[0]["exact"]["flops"] > 0


def test_replicated_weights_step_matches_unsharded(runs):
    """``fsdp=False`` on (2, 2) against the port's unsharded step (itself
    held to JAX by ``test_torch_trainer.py``) from the same state, batch
    and draws; its collectives equal its dry run's."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.optim.optimizers import warmup_cosine
    from repro_torch.train import trainer

    dry, real = runs
    got = real[0]["replicated"]
    assert all(r["replicated"]["metrics"] == got["metrics"] for r in real)
    m, tcfg, start, batch, draws = _replicated_start()
    want, met = trainer.make_train_step(m, tcfg)(start, batch, draws)
    for k, v in met.items():
        np.testing.assert_allclose(got["metrics"][k], v.item(), rtol=RTOL,
                                   err_msg=k)
    want = interop.train_state_to_numpy(want)
    have = got["state"]
    assert have["step"] == want["step"] == 1
    lr_t = warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.total_steps)(
        torch.tensor(1, dtype=torch.int32)).item()
    n_out = n_all = 0
    for k, w in want["params"].items():
        diff = np.abs(have["params"][k] - w)
        n_out += int((diff > 1e-6 + RTOL * np.abs(w)).sum())
        n_all += w.size
        assert diff.max() <= 2 * lr_t * 1.01 + 1e-6, k
    assert n_out <= 5e-4 * n_all, (n_out, n_all)
    for name in ("mu", "nu"):
        assert set(have[name]) == set(want[name])
        for k, w in want[name].items():
            np.testing.assert_allclose(
                have[name][k], w, rtol=RTOL,
                atol=1e-5 * float(np.abs(w).max()), err_msg=f"{name}/{k}")
    # replicated over data: no FSDP gather or reduce-scatter of a weight
    assert got["counts"]["reduce_scatter"] == 0
    assert got["counts"]["all_reduce"] > real[0]["ota"]["counts"][
        "all_reduce"]
    d = dry["replicated"]
    assert d["counts"] == got["counts"]
    assert d["stats"]["count_by_kind"] == got["count_by_kind"]
    assert d["stats"]["bytes_by_kind"] == got["bytes_by_kind"]
    assert d["launches"] == {"ota_fused_mapped": 1}


def test_no_plain_version_is_traced(runs):
    dry, _ = runs
    t = dry["traced"]
    assert t["train", SMOKE] == {"ota_fused_mapped": 1}
    assert set(t["prefill", SMOKE]) <= {"flash_attention",
                                        "flash_attention_wgmma"}
    assert sum(t["prefill", SMOKE].values()) == 2     # smoke llama's layers
    assert set(t["prefill", "mamba2-130m"]) <= {"ssd_scan", "ssd_scan_tc"}
    assert sum(t["prefill", "mamba2-130m"].values()) == 2
    assert t["decode", SMOKE] == {} and t["decode", "mamba2-130m"] == {}


def test_cli_writes_a_record_the_report_reads(tmp_path, monkeypatch):
    """``main`` on the smallest combination: mamba2-130m's ``long_500k``
    decode on a (1, 1) group (one rank: the group may start here)."""
    from repro_torch.launch import dryrun, report

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(1, mp_context=ctx) as ex:
        rc = ex.submit(dryrun.main, [
            "--arch", "mamba2-130m", "--shape", "long_500k",
            "--mesh-shape", "1x1", "--out", str(tmp_path)]).result(300)
    assert rc == 0
    recs = report.load(str(tmp_path))
    (rec,) = recs.values()
    assert rec["mesh"] == "pod1x1" and rec["kind"] == "decode"
    assert rec["flops"]["total"] > 0 and rec["memory"]["total"] > 0
    assert rec["roofline"]["dominant"] == "memory"
    assert any("mamba2-130m | long_500k | pod16x16 | MISSING" in line
               for line in report.dryrun_table(recs))
