"""The port's sharded train step (``train.trainer.shard_for_training``) on
``torch.distributed`` ranks against the JAX package's unsharded
``make_train_step``.

JAX's production step (``launch/dryrun.py``'s ``build_train_lowering``)
is ``make_train_step`` with ``n_agents = n_data_shards(mesh)``,
partitioned by GSPMD under ``train_rules(fsdp=True)``; its function is the
unsharded step's, so the references are that step, run once per arch,
agent count and dtype (``ota_backend="pallas"``, the Pallas kernel in
interpret mode, with the draws it takes passed to the port): each arch's
in a process of its own, the three at once (XLA compiling the steps is
most of this module's time), and their states, batches and draws (numpy)
go to the ranks through one file.  One group of four ``gloo`` ranks
(``launch.mesh.run_local``) runs every mesh case of this module once (the
module-scoped fixture), and a one-rank group, started beside the
references, the (1, 1) cases; the tests read their results.

* smoke llama3.2-3b, granite-moe-1b-a400m and mamba2-130m on (2, 2),
  (4, 1) and (1, 4), ``n_agents = n_data_shards``, two float32 steps, each
  from the JAX state (so a comparison sees one step's rounding): the four
  metrics at rtol 1e-5; ``mu`` and ``nu`` at rtol 1e-5 with an atol of
  1e-5 of the leaf's largest value; the parameters as
  ``test_torch_trainer.py`` holds the unsharded step's (rtol 1e-5, atol
  1e-6 on all but 5e-4 of the elements, those within the step's ``2 *
  lr_t``: AdamW divides each element by its own RMS, so an element whose
  gradient cancels to rounding level moves by rounding over rounding);
* bfloat16, one step on (2, 2) with ``n_agents = n_data_shards``:
  llama3.2-3b and mamba2-130m against JAX's bf16 step from its state
  (parameters, ``mu`` and ``sqrt(nu)``, each element within 2e-2 of the
  largest value of its part of the state; the metrics at rtol 2e-2); all
  three against the port's unsharded step from the same state (each
  element within 2e-2 of its leaf's largest value: the sharding's own
  rounding); granite against the port only, because its bf16 routing has
  near-ties (a token whose top-k margin is below what one bf16 rounding
  of the router's input can move a logit by, shown on the CPU), where two
  correct bf16 steps pick different experts;
* every rank's metrics bitwise the others';
* ``n_agents = 2 n_data`` on (2, 2) against JAX; microbatching (2) on
  (2, 2) against the port's unsharded step (rtol 1e-5); a batch laid out
  by ``data.make_batch_specs`` bitwise the whole batch;
* the noise: on (2, 2), where ``layers/mlp/gate`` is ``(layers, d_model /
  data, d_ff / model)``, each rank's K1 plain version under the step's
  counter map is bitwise ``ref.counter_noise(seed, d)`` at its elements;
* each autograd collective's gradient against the unsharded gradient
  (``copy_to`` into a column-parallel product and the row-parallel
  all-reduce, the vocabulary gather, an all-reduce that sums in backward,
  FSDP's gather with its reduce-scatter): a missing or doubled sum shows
  as a gradient ``model`` or ``n_data`` times off;
* replicated kv heads (smoke llama, H = 4, Hkv = 2, on (1, 4)): the
  layout shards the q heads and not the kv heads, the kv weights match
  JAX, and the norm counts them on one rank of four;
* after a step each rank holds only its shards: local numel = global
  numel / the spec's product, params and moments;
* a (1, 1) mesh is the unsharded step bit for bit (params, moments, all
  four metrics; float32, bf16, microbatch 2), the map path included;
* what is still refused raises: an ``n_agents`` that the data shards do
  not divide (``ValueError``), SSD heads sharded with ``n_groups > 1``
  (``NotImplementedError``; the hybrid, vlm and encdec families are
  sharded, ``tests/test_torch_sharded_families.py``).
"""
import dataclasses
import functools
import math
import multiprocessing
import os
import pickle
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ota_fused, ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models import param
from repro_torch.train import trainer
from repro_torch.utils import shard_hints
from repro_torch.utils.tree import flatten_paths

ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "mamba2-130m")
# the archs whose bf16 step is held to JAX's (granite's routing has
# near-ties at bf16 rounding: ``test_granite_bf16_routing_has_near_ties``)
JAX_BF16 = ("llama3.2-3b", "mamba2-130m")
MESHES = ((2, 2), (4, 1), (1, 4))
BATCH, SEQ, STEPS = 8, 16, 2
RTOL = 1e-5
TCFG = dict(aggregator="ota", total_steps=10, warmup=2)
# AdamW moves each element by about lr_t whatever its gradient's size, so
# where a bf16 gradient element's sign is within rounding the two packages'
# parameters part by up to 2 lr_t: the bf16 steps take a small lr, and the
# moments carry the comparison of the gradients
LR = {"float32": 1e-2, "bfloat16": 1e-4}


def _n_data(dims):
    return dims[0]


@functools.lru_cache(maxsize=None)
def _mesh(dims):
    """One ``DeviceMesh`` of each shape a rank builds (a mesh's groups are
    made once)."""
    return mesh_lib.make_tiny_mesh(*dims)


def _port_cfg(arch, dtype="float32"):
    return get_smoke_config(arch).with_(dtype=dtype)


# ---------------------------------------------------------------------------
# the JAX references (a process an arch)
# ---------------------------------------------------------------------------

def _numpy_state(state):
    """A JAX ``TrainState`` as numpy leaves in plain namespaces (what
    ``interop.train_state_from_jax`` reads), so that the records unpickle
    without JAX."""
    import jax

    s = jax.tree.map(np.asarray, state)
    return SimpleNamespace(
        params=s.params, step=s.step,
        opt_state=SimpleNamespace(step=s.opt_state.step, mu=s.opt_state.mu,
                                  nu=s.opt_state.nu))


def _jax_train(arch, n_agents, dtype="float32", steps=STEPS):
    """JAX's unsharded train steps: for each step its starting state, the
    batch, the draws it took, the state after and its metrics (numpy)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import InputShape as JaxInputShape
    from repro.core import ota as jax_ota
    from repro.data.pipeline import make_batch as jax_make_batch
    from repro.models import model as jax_model
    from repro.train import trainer as jax_trainer

    cj = jax_smoke_config(arch).with_(dtype=dtype)
    mj = jax_model.build(cj)
    tj = jax_trainer.TrainConfig(ota_backend="pallas", n_agents=n_agents,
                                 lr=LR[dtype], **TCFG)
    state = jax_trainer.init_state(mj, tj, jax.random.key(1))
    step = jax.jit(jax_trainer.make_train_step(mj, tj))
    key = jax.random.key(0)
    out = []
    for i in range(steps):
        b = jax_make_batch(cj, JaxInputShape("t", seq_len=SEQ,
                                             global_batch=BATCH,
                                             kind="train"), i)
        kh, kn = jax.random.split(jax.random.fold_in(key, state.step))
        draws = (np.asarray(jax_ota.sample_gains(tj.ota_config(), kh,
                                                 n_agents)),
                 int(jax_ota._kernel_seed(kn)))
        start = _numpy_state(state)
        state, met = step(state, b, key)
        out.append(dict(
            start=start, batch={k: np.asarray(v).astype(np.int64)
                                for k, v in b.items()},
            draws=draws, end=_numpy_state(state),
            metrics={k: float(v) for k, v in met.items()}))
    return out


def _jax_job(refs):
    """``{(arch, n_agents, dtype, steps): _jax_train(...)}`` of a list of
    such keys (one process's share)."""
    return {key: _jax_train(*key) for key in refs}


def _cases():
    """(name, arch, mesh dims, n_agents, dtype, steps, microbatch)."""
    out = []
    for arch in ARCHS:
        for dims in MESHES:
            out.append((f"{arch}-{dims}", arch, dims, _n_data(dims),
                        "float32", STEPS, 1))
        out.append((f"{arch}-bf16", arch, (2, 2), 2, "bfloat16", 1, 1))
    out.append(("agents-2n", "llama3.2-3b", (2, 2), 4, "float32", STEPS, 1))
    out.append(("micro-2", "llama3.2-3b", (2, 2), 2, "float32", 1, 2))
    return out


def _jax_cases():
    """The float32 cases held to JAX (one microbatch)."""
    return [c for c in _cases() if c[4] == "float32" and c[6] == 1]


def _from_jax(case):
    """Whether a case starts from JAX's state, batch and draws: all but
    granite's bf16 one, which starts from the port's init."""
    return case[4] == "float32" or case[1] in JAX_BF16


def _spec(case):
    """The reference a case starting from JAX takes: (n_agents, dtype,
    steps); the microbatched case takes JAX's first step's inputs."""
    return case[3], case[4], STEPS if case[4] == "float32" else 1


@functools.lru_cache(maxsize=None)
def _references():
    """JAX's steps by ``(arch, n_agents, dtype, steps)``, computed in
    spawned processes at once, one an arch."""
    jobs = {}
    for c in _cases():
        if _from_jax(c):
            jobs.setdefault(c[1], set()).add((c[1],) + _spec(c))
    with ProcessPoolExecutor(
            len(jobs), mp_context=multiprocessing.get_context("spawn")) as ex:
        done = [ex.submit(_jax_job, sorted(keys)) for keys in jobs.values()]
        return {k: v for f in done for k, v in f.result().items()}


def _refs():
    """JAX's steps of every case starting from JAX, by case name."""
    return {c[0]: _references()[(c[1],) + _spec(c)] for c in _cases()
            if _from_jax(c)}


@functools.lru_cache(maxsize=None)
def _rank_inputs():
    """What the ranks take of the references: each step's starting state
    (one copy of each), batch and draws.  Granite's bf16 case starts from
    the port's own init (``_port_start``), the microbatched one from JAX's
    first step's inputs."""
    states, cases = {}, {}
    for case in _cases():
        if not _from_jax(case):
            continue
        name, arch, _, n, dtype, steps, _ = case
        cases[name] = []
        for i, rec in enumerate(_refs()[name][:steps]):
            key = (arch, dtype) if i == 0 else (arch, n, dtype, i)
            states.setdefault(key, rec["start"])
            cases[name].append((key, rec["batch"], rec["draws"]))
    return states, cases


def _port_start(arch, dtype):
    """The port's init, batch and draws of a bf16 case (the same in every
    process)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_batch

    m = model_lib.build(_port_cfg(arch, dtype))
    state = trainer.init_state(m, _tcfg(2, 1, dtype), device="cpu")
    batch = make_batch(m.cfg, InputShape("t", SEQ, BATCH, "train"), 0,
                       device="cpu")
    draws = (torch.tensor([0.7, 1.3]), 777)
    return m, state, batch, draws


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _draws(d):
    return torch.from_numpy(d[0].copy()), d[1]


def _batch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _tcfg(n_agents, micro=1, dtype="float32"):
    return trainer.TrainConfig(ota_backend="torch", n_agents=n_agents,
                               microbatch=micro, lr=LR[dtype], **TCFG)


def _local_counts(state):
    """(local numel, global numel / the spec's product, global numel) of
    every leaf, params and moments."""
    out = {}
    flat = dict(flatten_paths(state.params))
    for name in ("mu", "nu"):
        flat.update({f"{name}/{k}": v for k, v in
                     getattr(state.opt_state, name).items()})
    for k, v in flat.items():
        n_shards = 1
        for axis, p in enumerate(v.placements):
            if p.is_shard():
                n_shards *= v.device_mesh.size(axis)
        out[k] = (v.to_local().numel(), v.numel() // n_shards, v.numel())
    return out


def _run_case(case, inputs):
    name, arch, dims, n, dtype, steps, micro = case
    m = model_lib.build(_port_cfg(arch, dtype))
    mesh = _mesh(dims)
    rank = torch.distributed.get_rank()
    res = {"metrics": [], "states": [], "counts": None}
    if _from_jax(case):
        states, cases = inputs
        steps = [(interop.train_state_from_jax(states[key], "cpu"),
                  _batch(batch), _draws(draws))
                 for key, batch, draws in cases[name]]
    else:
        _, start, batch, draws = _port_start(arch, dtype)
        steps = [(start, batch, draws)]
    for start, batch, draws in steps:
        state, step = trainer.shard_for_training(m, _tcfg(n, micro, dtype),
                                                 start, mesh)
        state, met = step(state, batch, draws)
        res["metrics"].append({k: v.item() for k, v in met.items()})
        full = interop.train_state_to_numpy(state)
        res["states"].append(full if rank == 0 else None)
        res["counts"] = _local_counts(state)
        lay = step.sharded.layout
        res["layout"] = (lay.heads, lay.kv_heads, lay.model, lay.n_batch)
        res["counted"] = sorted(step.sharded.counted)
    return res


def _noise_case():
    """Each rank's K1 plain version under the step's counter map, at (2,
    2), against the whole row's counter noise at the rank's elements."""
    cfg = _port_cfg("llama3.2-3b")
    m = model_lib.build(cfg)
    mesh = _mesh((2, 2))
    state = trainer.init_state(m, _tcfg(2), device="cpu")
    _, step = trainer.shard_for_training(m, _tcfg(2), state, mesh)
    cmap = step.sharded.counter_map
    seed = 12345
    got = ota_fused.fused_aggregate(
        torch.zeros(1, cmap.n), torch.ones(1), sigma=1.0, scale=1.0,
        seed=seed, counter_map=cmap)
    decls = flatten_paths(flatten_paths(m.plan))
    d = sum(math.prod(x.shape) for x in decls.values())
    whole = ref.counter_noise(seed, d)
    want, off = [], 0
    specs = {}
    for k, dc in decls.items():
        idx = torch.arange(off, off + math.prod(dc.shape)).reshape(dc.shape)
        spec = param.spec_for(dc, param.train_rules(), mesh)
        specs[k] = spec
        want.append(param.local_shard(idx, spec, mesh).reshape(-1))
        off += idx.numel()
    want = whole[torch.cat(want)]
    return dict(bitwise=bool(torch.equal(got, want)),
                gate_spec=tuple(specs["layers/mlp/gate"]), n=cmap.n, d=d)


def _grad_cases():
    """Each autograd collective against the unsharded gradient: (name,
    max |got - want| / max |want|) per case, on the meshes (1, 4), (4, 1)
    and (2, 2)."""
    out = {}
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    x, w1, w2, c = rnd(6, 8), rnd(8, 12), rnd(12, 8), rnd(6, 8)
    wv, cv = rnd(8, 16), rnd(6, 16)

    def whole_grads():
        ws = [t.clone().requires_grad_() for t in (x, w1, w2)]
        loss = (((ws[0] @ ws[1]) @ ws[2]) * c).sum()
        xa, wa = x.clone().requires_grad_(), wv.clone().requires_grad_()
        loss2 = ((xa @ wa) * cv).sum()
        y = (x @ w1).clone().requires_grad_()
        v = (y * y).sum(-1, keepdim=True)
        loss3 = ((y * torch.rsqrt(v)) @ w2 * c).sum()
        return (torch.autograd.grad(loss, ws),
                torch.autograd.grad(loss2, (xa, wa)),
                torch.autograd.grad(loss3, y)[0])

    (gx, gw1, gw2), (gxa, gwa), gy = whole_grads()

    def err(got, want):
        return float((got - want).abs().max() / want.abs().max())

    for dims in ((1, 4), (4, 1), (2, 2)):
        mesh = _mesh(dims)
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        nm, nd = dims[1], dims[0]
        lay = shard_hints.Layout(model=nm, model_rank=coord["model"],
                                 batch_axes=("data",), n_batch=nd,
                                 batch_rank=coord["data"])
        with shard_hints.hints(mesh):
            # column-parallel w1 (copy_to), row-parallel w2 (all-reduce)
            lo, hi = lay.span(12)
            xs = x.clone().requires_grad_()
            w1s = w1[:, lo:hi].clone().requires_grad_()
            w2s = w2[lo:hi].clone().requires_grad_()
            y = shard_hints.row_parallel(shard_hints.copy_to(xs) @ w1s, w2s,
                                         lay)
            ga = torch.autograd.grad((y * c).sum(), (xs, w1s, w2s))
            out[f"mlp-{dims}"] = max(err(ga[0], gx), err(ga[1], gw1[:, lo:hi]),
                                     err(ga[2], gw2[lo:hi]))
            # the vocabulary gather: slice in backward
            vlo, vhi = lay.span(16)
            xs = x.clone().requires_grad_()
            wvs = wv[:, vlo:vhi].clone().requires_grad_()
            logits = shard_hints.all_gather(shard_hints.copy_to(xs) @ wvs, -1)
            gb = torch.autograd.grad((logits * cv).sum(), (xs, wvs))
            out[f"gather-{dims}"] = max(err(gb[0], gxa),
                                        err(gb[1], gwa[:, vlo:vhi]))
            # gate_norm's all-reduce: a sum in backward
            ys = (x @ w1)[:, lo:hi].clone().requires_grad_()
            v = shard_hints.all_reduce((ys * ys).sum(-1, keepdim=True),
                                       backward="sum")
            o = shard_hints.row_parallel(ys * torch.rsqrt(v), w2[lo:hi], lay)
            gc = torch.autograd.grad((o * c).sum(), ys)[0]
            out[f"norm-{dims}"] = err(gc, gy[:, lo:hi])
            # FSDP: w2 sharded over data along dim 1, each data rank its
            # rows of the batch, the losses summed over data
            dlo, dhi = coord["data"] * 8 // nd, (coord["data"] + 1) * 8 // nd
            blo, bhi = coord["data"] * 6 // nd, (coord["data"] + 1) * 6 // nd
            w2d = w2[:, dlo:dhi].clone().requires_grad_()
            wfull = shard_hints.unshard(w2d, 1, ("data",))
            yd = (x[blo:bhi] @ w1) @ wfull
            gd = torch.autograd.grad((yd * c[blo:bhi]).sum(), w2d)[0]
            out[f"fsdp-{dims}"] = err(gd, gw2[:, dlo:dhi])
    return out


def _error_cases():
    out = {}
    mesh = _mesh((4, 1))
    m = model_lib.build(_port_cfg("llama3.2-3b"))
    try:
        trainer.shard_for_training(m, _tcfg(2), trainer.init_state(
            m, _tcfg(2), device="cpu"), mesh)
    except ValueError as e:
        out["agents"] = str(e)
    # SSD heads over 'model' with n_groups > 1: not ported (ROADMAP.md)
    cfg = _port_cfg("mamba2-130m")
    m = model_lib.build(cfg.with_(ssm=dataclasses.replace(cfg.ssm,
                                                          n_groups=2)))
    try:
        trainer.shard_for_training(m, _tcfg(1), trainer.init_state(
            m, _tcfg(1), device="cpu"), _mesh((1, 4)))
    except NotImplementedError as e:
        out["n_groups"] = str(e)
    return out


def _dtensor_batch_case():
    """One step on (2, 2) from the same state with the whole batch and
    with the batch as DTensors laid out by ``data.make_batch_specs``: the
    metrics of each."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_batch, make_batch_specs

    m = model_lib.build(_port_cfg("llama3.2-3b"))
    mesh = _mesh((2, 2))
    shape = InputShape("t", SEQ, BATCH, "train")
    batch = make_batch(m.cfg, shape, 0, device="cpu")
    specs = make_batch_specs(m.cfg, shape, mesh)
    out = []
    for b in (batch, {k: param.distribute_tensor(v, specs[k])
                      for k, v in batch.items()}):
        state, step = trainer.shard_for_training(
            m, _tcfg(2), trainer.init_state(m, _tcfg(2), device="cpu"), mesh)
        out.append({k: v.item() for k, v in step(state, b)[1].items()})
    return out


def _wait_for(path, timeout=600.0):
    """The ranks' inputs, once the parent has written them to ``path``."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no inputs at {path} after {timeout} s")
        time.sleep(0.05)
    inputs = pickle.loads(Path(path).read_bytes())
    if inputs is None:
        raise RuntimeError("the JAX references failed in the parent")
    return inputs


def _ranks(agent_mesh, path):
    """Every case of the four ranks: first those that need nothing of JAX,
    while the parent computes the references, then the rest."""
    out = {"noise": _noise_case(), "grads": _grad_cases(),
           "errors": _error_cases(), "dtensor_batch": _dtensor_batch_case(),
           "cases": {c[0]: _run_case(c, None) for c in _cases()
                     if not _from_jax(c)}}
    inputs = _wait_for(path)
    out["cases"].update({c[0]: _run_case(c, inputs) for c in _cases()
                         if _from_jax(c)})
    return out


# ---------------------------------------------------------------------------
# the one-rank mesh: the unsharded step bit for bit
# ---------------------------------------------------------------------------

ONE_CASES = [(arch, "float32", 1) for arch in ARCHS] + [
    ("llama3.2-3b", "bfloat16", 1), ("granite-moe-1b-a400m", "bfloat16", 1),
    ("llama3.2-3b", "float32", 2)]


def _one_rank(agent_mesh):
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_batch

    mesh = mesh_lib.make_tiny_mesh(1, 1)
    out = {}
    for arch, dtype, micro in ONE_CASES:
        m = model_lib.build(_port_cfg(arch, dtype))
        tcfg = _tcfg(4, micro, dtype)
        plain = trainer.init_state(m, tcfg, device="cpu")
        sharded, step = trainer.shard_for_training(
            m, tcfg, trainer.init_state(m, tcfg, device="cpu"), mesh)
        plain_step = trainer.make_train_step(m, tcfg)
        same, launches = [], ota_fused.LAUNCHES_MAPPED
        for i in range(STEPS):
            batch = make_batch(m.cfg, InputShape("t", SEQ, BATCH, "train"),
                               i, device="cpu")
            plain, mp = plain_step(plain, batch)
            sharded, ms = step(sharded, batch)
            a = interop.train_state_to_numpy(plain)
            b = interop.train_state_to_numpy(sharded)
            same.append(all(
                np.array_equal(a[g][k].view(np.uint8), b[g][k].view(np.uint8))
                for g in ("params", "mu", "nu") for k in a[g])
                and all(mp[k].item() == ms[k].item() for k in mp)
                and (a["step"], a["opt_step"]) == (b["step"], b["opt_step"]))
        out[(arch, dtype, micro)] = same
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """(the four ranks' results, the one rank's).  Both groups start
    while the JAX references are computed; the four ranks take theirs from
    one file, written when they are ready (None if they failed)."""
    path = tmp_path_factory.mktemp("sharded_train") / "inputs.pkl"
    with ThreadPoolExecutor(2) as ex:
        one = ex.submit(mesh_lib.run_local, _one_rank, 1, device="cpu")
        four = ex.submit(mesh_lib.run_local, _ranks, 4, str(path),
                         device="cpu")
        inputs = None
        try:
            inputs = _rank_inputs()
        finally:
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(pickle.dumps(inputs))
            os.replace(tmp, path)
        return four.result(), one.result()[0]


@pytest.fixture(scope="module")
def ranks(groups):
    return groups[0]


@pytest.fixture(scope="module")
def one_rank(groups):
    return groups[1]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _lr(step):
    from repro_torch.optim.optimizers import warmup_cosine

    return warmup_cosine(LR["float32"], TCFG["warmup"], TCFG["total_steps"])(
        torch.tensor(step, dtype=torch.int32)).item()


def _flat_np(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_paths(tree).items()}


def _check_params(want, have, lr_t):
    n_out = n_all = 0
    for k, w in want.items():
        h = np.asarray(have[k], np.float32)
        diff = np.abs(h - w)
        n_out += int((diff > 1e-6 + RTOL * np.abs(w)).sum())
        n_all += w.size
        assert diff.max() <= 2 * lr_t * 1.01 + 1e-6, k
    assert n_out <= 5e-4 * n_all, (n_out, n_all)


def _check_moments(rec, have, rtol, scaled_atol):
    for name in ("mu", "nu"):
        want = _flat_np(getattr(rec["end"].opt_state, name))
        assert set(want) == set(have[name])
        for k, w in want.items():
            np.testing.assert_allclose(
                np.asarray(have[name][k], np.float32), w, rtol=rtol,
                atol=scaled_atol * float(np.abs(w).max()),
                err_msg=f"{name}/{k}")


@pytest.mark.parametrize("case", [c[0] for c in _jax_cases()])
def test_sharded_steps_match_jax(ranks, case):
    refs = _refs()[case]
    got = ranks[0]["cases"][case]
    for i, rec in enumerate(refs):
        for k, v in rec["metrics"].items():
            np.testing.assert_allclose(got["metrics"][i][k], v, rtol=RTOL,
                                       err_msg=k)
        have = got["states"][i]
        assert have["step"] == i + 1 and have["opt_step"] == i + 1
        _check_params(_flat_np(rec["end"].params), have["params"], _lr(i + 1))
        _check_moments(rec, have, RTOL, 1e-5)


def _bf16_start(arch):
    """A bf16 case's starting state, batch and draws: JAX's for the archs
    held to JAX, the port's own init for granite."""
    if arch not in JAX_BF16:
        return _port_start(arch, "bfloat16")[1:]
    rec = _refs()[f"{arch}-bf16"][0]
    return (interop.train_state_from_jax(rec["start"], "cpu"),
            _batch(rec["batch"]), _draws(rec["draws"]))


def _bf16_parts(state):
    """params, ``mu`` and ``sqrt(nu)`` (the RMS AdamW divides by) of a
    gathered state, float32."""
    return {name: {k: (np.sqrt if name == "nu" else np.asarray)(
        np.asarray(v, np.float32)) for k, v in state[name].items()}
        for name in ("params", "mu", "nu")}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_bf16_step_matches_unsharded(ranks, arch):
    """bf16 against the port's unsharded step from the same state, batch
    and draws: the sharding's own rounding (bf16 partial sums over ranks)
    within 2e-2 of the leaf's largest value, ``nu`` as its square root."""
    m = model_lib.build(_port_cfg(arch, "bfloat16"))
    want, met = trainer.make_train_step(m, _tcfg(2, 1, "bfloat16"))(
        *_bf16_start(arch))
    want = _bf16_parts(interop.train_state_to_numpy(want))
    got = ranks[0]["cases"][f"{arch}-bf16"]
    for k, v in met.items():
        np.testing.assert_allclose(got["metrics"][0][k], v.item(),
                                   rtol=2e-2, err_msg=k)
    have = _bf16_parts(got["states"][0])
    for name, leaves in want.items():
        for k, w in leaves.items():
            assert np.abs(have[name][k] - w).max() <= \
                2e-2 * np.abs(w).max(), f"{name}/{k}"


@pytest.mark.parametrize("arch", JAX_BF16)
def test_sharded_bf16_step_matches_jax(ranks, arch):
    """bf16 on (2, 2) against JAX's bf16 step from its state, batch and
    draws: the metrics at rtol 2e-2; every element of the parameters,
    ``mu`` and ``sqrt(nu)`` within 2e-2 of the largest value of its part
    of the state.  (Two correct bf16 steps round in different orders: the
    port's unsharded step is itself a few bf16 ulps from JAX's at single
    gradient elements, more than 2e-2 of some small leaf's largest
    value.)"""
    rec = _refs()[f"{arch}-bf16"][0]
    got = ranks[0]["cases"][f"{arch}-bf16"]
    for k, v in rec["metrics"].items():
        np.testing.assert_allclose(got["metrics"][0][k], v, rtol=2e-2,
                                   err_msg=k)
    end = rec["end"]
    want = _bf16_parts({"params": _flat_np(end.params),
                        "mu": _flat_np(end.opt_state.mu),
                        "nu": _flat_np(end.opt_state.nu)})
    have = _bf16_parts(got["states"][0])
    for name, leaves in want.items():
        top = max(np.abs(w).max() for w in leaves.values())
        for k, w in leaves.items():
            assert np.abs(have[name][k] - w).max() <= 2e-2 * top, \
                f"{name}/{k}"


def test_granite_bf16_routing_has_near_ties():
    """Why granite's bf16 step is held to the port's unsharded step and not
    to JAX's: in the port's bf16 forward from the case's state some token's
    margin between its k-th and (k+1)-th router logit is below what one
    bf16 rounding of the router's input can move a logit by, so two
    correct bf16 steps may send it to different experts."""
    from repro_torch.models import moe, transformer

    arch = "granite-moe-1b-a400m"
    m = model_lib.build(_port_cfg(arch, "bfloat16"))
    start, batch, _ = _bf16_start(arch)
    seen = []
    router = moe._router

    def spy(params, x, cfg, generator):
        seen.append((params["router"].float(), x.float()))
        return router(params, x, cfg, generator)

    moe._router = spy
    try:
        with torch.no_grad():
            transformer.forward(start.params, m.cfg, batch["tokens"])
    finally:
        moe._router = router
    k = m.cfg.moe.top_k
    assert len(seen) == m.cfg.n_layers
    ratios = []
    for r, x in seen:
        top = (x @ r).sort(-1, descending=True).values
        margin = top[:, k - 1] - top[:, k]
        # one bf16 ulp of each input element (8 significand bits), and the
        # most it moves a logit
        ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
        reach = (ulp @ r.abs()).max(-1).values
        ratios.append(float((margin / reach).min()))
    assert min(ratios) < 1.0, ratios


@pytest.mark.parametrize("case", [c[0] for c in _cases()])
def test_every_rank_metrics_bitwise(ranks, case):
    mets = [r["cases"][case]["metrics"] for r in ranks]
    assert all(m == mets[0] for m in mets[1:])


def test_microbatch_matches_unsharded_port(ranks):
    """Microbatch 2 on (2, 2) against the port's unsharded step (itself
    held to JAX by ``test_torch_trainer.py``, microbatch 2 included)."""
    states, cases = _rank_inputs()
    key, batch, draws = cases["micro-2"][0]
    m = model_lib.build(_port_cfg("llama3.2-3b"))
    step = trainer.make_train_step(m, _tcfg(2, 2))
    want, met = step(interop.train_state_from_jax(states[key], "cpu"),
                     _batch(batch), _draws(draws))
    got = ranks[0]["cases"]["micro-2"]
    for k, v in met.items():
        np.testing.assert_allclose(got["metrics"][0][k], v.item(), rtol=RTOL,
                                   err_msg=k)
    want = interop.train_state_to_numpy(want)
    _check_params(want["params"], got["states"][0]["params"], _lr(1))
    for name in ("mu", "nu"):
        for k, w in want[name].items():
            np.testing.assert_allclose(
                got["states"][0][name][k], w, rtol=RTOL,
                atol=1e-5 * float(np.abs(w).max()), err_msg=f"{name}/{k}")


def test_batch_as_dtensors_is_the_whole_batch(ranks):
    """A batch laid out by ``data.make_batch_specs`` (each rank its shard)
    gives the step the whole batch gives, bit for bit."""
    for r in ranks:
        whole, dtensors = r["dtensor_batch"]
        assert whole == dtensors


def test_noise_bitwise_the_unsharded_rows(ranks):
    for r in ranks:
        noise = r["noise"]
        assert noise["gate_spec"] == (None, "data", "model")
        assert noise["bitwise"]
    assert sum(r["noise"]["n"] for r in ranks) < 4 * ranks[0]["noise"]["d"]


@pytest.mark.parametrize("kind", ["mlp", "gather", "norm", "fsdp"])
def test_autograd_collectives_match_unsharded(ranks, kind):
    for r in ranks:
        for dims in ((1, 4), (4, 1), (2, 2)):
            assert r["grads"][f"{kind}-{dims}"] < 1e-6, (kind, dims)


def test_replicated_kv_heads_counted_once(ranks):
    case = "llama3.2-3b-(1, 4)"
    for rank, r in enumerate(ranks):
        got = r["cases"][case]
        heads, kv_heads, model, _ = got["layout"]
        assert heads and not kv_heads and model == 4
        # the kv weights are whole on every rank; rank 0 counts them
        assert ("layers/attn/wk" in got["counted"]) == (rank == 0)
        assert "layers/attn/wq" in got["counted"]
    for i, rec in enumerate(_refs()[case]):
        keys = ("layers/attn/wk", "layers/attn/wv")
        want = _flat_np(rec["end"].params)
        have = ranks[0]["cases"][case]["states"][i]
        _check_params({k: want[k] for k in keys}, have["params"], _lr(i + 1))
        for name in ("mu", "nu"):
            for k in keys:
                w = np.asarray(getattr(rec["end"].opt_state, name)["layers"][
                    "attn"][k.rsplit("/", 1)[1]], np.float32)
                np.testing.assert_allclose(
                    have[name][k], w, rtol=RTOL,
                    atol=1e-5 * float(np.abs(w).max()), err_msg=f"{name}/{k}")


@pytest.mark.parametrize("case", [c[0] for c in _cases()])
def test_each_rank_holds_only_its_shards(ranks, case):
    for r in ranks:
        counts = r["cases"][case]["counts"]
        assert counts and all(a == b for a, b, _ in counts.values()), counts
        # FSDP (d_model over data) or the model axis cuts most leaves
        local = sum(a for a, _, _ in counts.values())
        assert local < sum(c for _, _, c in counts.values()) / 1.5


@pytest.mark.parametrize("case", [f"{a}-{d}-{m}" for a, d, m in ONE_CASES])
def test_one_rank_mesh_bitwise_unsharded(one_rank, case):
    arch, dtype, micro = case.rsplit("-", 2)
    assert one_rank[(arch, dtype, int(micro))] == [True] * STEPS


def test_unsharded_families_and_agents_raise(ranks):
    """What is still refused: an ``n_agents`` the data shards do not
    divide, and a layout not ported (SSD heads over ``model`` with
    ``n_groups > 1``).  No family is refused any more."""
    for r in ranks:
        assert "not a multiple" in r["errors"]["agents"]
        assert "n_groups > 1" in r["errors"]["n_groups"]


# ---------------------------------------------------------------------------
# K1's counter map on the CPU (no ranks)
# ---------------------------------------------------------------------------

def test_counter_map_rejects_gaps_overlaps_and_wide_counters():
    ok = ota_fused.CounterMap([(0, 0, [4], [1]), (4, 10, [2, 3], [5, 1])])
    assert ok.n == 10 and len(ok) == 2
    with pytest.raises(ValueError, match="overlap or leave a gap"):
        ota_fused.CounterMap([(0, 0, [4], [1]), (3, 10, [2], [1])])
    with pytest.raises(ValueError, match="overlap or leave a gap"):
        ota_fused.CounterMap([(0, 0, [4], [1]), (5, 10, [2], [1])])
    with pytest.raises(ValueError, match="2\\^32"):
        ota_fused.CounterMap([(0, 0, [4], [2 ** 32])])
    # counters past 2^32 wrap, as the JAX package's uint32 counter does
    wraps = ota_fused.CounterMap([(0, 2 ** 32 - 2, [4], [1])])
    assert wraps.counters("cpu").tolist() == [2 ** 32 - 2, 2 ** 32 - 1, 0, 1]
    with pytest.raises(ValueError, match="sizes"):
        ota_fused.CounterMap([(0, 0, [1, 1, 1, 1, 2], [1, 1, 1, 1, 1])])
    with pytest.raises(ValueError, match="covers"):
        ota_fused.fused_aggregate(torch.zeros(1, 9), torch.ones(1),
                                  counter_map=ok)


def test_shard_counter_map_blocks_and_windows():
    """A block of a 3-D leaf after a whole leaf: the counters are the
    block's positions in the flat gradient, a whole leaf is one segment
    of one dimension, and a window of the plain version is its slice."""
    from repro_torch.core import ota

    shapes = [(5,), (3, 8, 6)]
    cmap = ota.shard_counter_map(shapes, [((0,), (5,)),
                                          ((0, 4, 3), (3, 4, 3))])
    whole = torch.arange(5 + 3 * 8 * 6)
    want = torch.cat([whole[:5], whole[5:].reshape(3, 8, 6)[:, 4:, 3:]
                      .reshape(-1)])
    assert torch.equal(cmap.counters("cpu"), want)
    assert cmap.host[0, 2:2 + ref.MAP_DIMS].tolist() == [1, 1, 1, 5]
    assert torch.equal(ref.counter_map_index(cmap.host, cmap.n, 3, 20),
                       want[3:20])


def test_whole_row_map_is_the_unmapped_noise():
    """A map of whole leaves draws each element at its own index: bitwise
    the unmapped plain version (the one-rank step's map)."""
    from repro_torch.core import ota

    shapes = [(7, 3), (11,), (2, 5, 4)]
    cmap = ota.shard_counter_map(shapes, [((0,) * len(s), s)
                                          for s in shapes])
    g = torch.randn(1, cmap.n, generator=torch.Generator().manual_seed(0))
    kw = dict(sigma=0.3, scale=0.7, seed=41)
    assert torch.equal(
        ota_fused.fused_aggregate(g, torch.ones(1), counter_map=cmap, **kw),
        ota_fused.fused_aggregate(g, torch.ones(1), **kw))
    assert torch.equal(ref.counter_noise_at(41, torch.arange(100, 140)),
                       ref.counter_noise(41, 40, start=100))
