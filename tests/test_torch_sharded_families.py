"""The hybrid, vlm and encdec families on a ``("data", "model")`` mesh:
``train.server.shard_for_serving`` and ``train.trainer.
shard_for_training`` on ``torch.distributed`` ranks against the JAX
package's unsharded model and train step.

Smoke zamba2-7b (cut to 5 layers: two groups of two mamba layers, each
followed by the shared block, and a tail of one, so ``tail_ssm`` is
served and the shared block is used twice), llama-3.2-vision-11b (H = 4,
Hkv = 2: on (1, 4) the q heads are sharded and the kv heads replicated)
and seamless-m4t-large-v2.  The JAX references (its unsharded
``forward``/``prefill``/decode steps and one ``make_train_step`` step
with ``ota_backend="pallas"``, the Pallas kernel in interpret mode, the
draws it took passed to the port) run in spawned processes, one an arch,
the three at once; their params, states, batches and draws (numpy) go to
the ranks through one file.  One group of four ``gloo`` ranks
(``launch.mesh.run_local``) runs every mesh case of this module once,
first those that need nothing of JAX; a one-rank group, started beside
the references, the (1, 1) cases.

* serve, float32, on (2, 2), (4, 1) and (1, 4): batch 4, a prompt of 15
  with its frontend memory (4 divides neither 15 nor 15 + 4, so on (1,
  4) the cache of vision's replicated kv heads stays whole), forward and
  prefill logits, every cache field gathered (``cross_kv`` included) and
  4 decode steps fed JAX's greedy tokens, against JAX at rtol 1e-5 with
  an atol of 1e-5 of the largest value; the same greedy tokens;
* serve, bfloat16, on (2, 2) against the port's unsharded path on the
  same weights: each logit within 2e-2 of the max abs logit;
* train, float32, one step from JAX's state with ``n_agents = 4`` on the
  three meshes against JAX's step: the metrics at rtol 1e-5, ``mu`` and
  ``nu`` at rtol 1e-5 with an atol of 1e-5 of the leaf's largest value,
  the params as ``test_torch_sharded_train.py`` holds them;
* zamba2's ``shared/*`` gradient on (2, 2) (the shared block used at
  both groups, its leaves gathered over ``data`` and cut over ``model``)
  against the unsharded gradient: a missing or doubled sum would show as
  a factor of 2;
* every rank's logits and metrics bitwise the others'; every rank holds
  only its shards (local numel = global numel / the spec's product);
* the collectives of a cross block: one all-reduce after self
  attention's ``wo``, one after cross attention's, one after ``down``;
* the weights' layout and the hints agree for the three configs on (2,
  2), (4, 1) and (1, 4), leaf by leaf, the cross blocks', the encoder's
  and the shared block's included;
* the sequence-sharded KV cache at batch 1 (a prompt of 16 with its
  memory, the cache widened by global slot to 20, 4 fixed tokens fed;
  zamba2 decodes from a zero cache of 20 slots, as its prefill returns
  one slot): zamba2 on (2, 2) (``groups_kv`` over ``data``), vision on
  (1, 4) (``groups_kv`` and ``cross_self_kv`` over ``model``, every q head
  gathered) and seamless on (4, 1) (``kv`` over ``data``), against JAX's
  unsharded prefill, cache, steps and greedy tokens at rtol 1e-5; the
  rank's slots, and the combine's collectives a step beside the batch-4
  serve's on the same mesh (whose cache is not sequence-sharded);
* the (1, 1) mesh is bitwise the unsharded serve and train step.
"""
import functools
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
from repro_torch.configs.base import InputShape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models import attention, param, transformer
from repro_torch.train import server, trainer
from repro_torch.utils import shard_hints
from repro_torch.utils.tree import flatten_paths, replace_paths

ZAMBA, VISION, SEAMLESS = ("zamba2-7b", "llama-3.2-vision-11b",
                           "seamless-m4t-large-v2")
ARCHS = (ZAMBA, VISION, SEAMLESS)
MESHES = ((2, 2), (4, 1), (1, 4))
B, S, STEPS = 4, 15, 4      # serve: 4 divides neither S nor S + STEPS
BATCH, SEQ, N_AGENTS = 8, 16, 4
RTOL = 1e-5
LR = 1e-2
TCFG = dict(aggregator="ota", total_steps=10, warmup=2, lr=LR)
KV_FIELDS = ("kv", "groups_kv", "cross_self_kv")


def _cfg(smoke_config, arch, dtype="float32"):
    """The smoke config of either package; zamba2 cut to 5 layers."""
    cfg = smoke_config(arch).with_(dtype=dtype)
    return cfg.with_(n_layers=5) if arch == ZAMBA else cfg


def _port_cfg(arch, dtype="float32"):
    return _cfg(get_smoke_config, arch, dtype)


def _tokens(vocab, s=S):
    return np.random.default_rng(13).integers(0, vocab, (B, s)).astype(
        np.int64)


def _memory(cfg, s=S):
    """The vlm/encdec frontend memory (B, cross_len, d_model), float32, or
    None."""
    if not model_lib.needs_memory(cfg):
        return None
    return (np.random.default_rng(17).standard_normal(
        (B, transformer.cross_len(cfg, s), cfg.d_model)) * 0.5).astype(
            np.float32)


@functools.lru_cache(maxsize=None)
def _mesh(dims):
    return mesh_lib.make_tiny_mesh(*dims)


B1_S, B1_STEPS = 16, 4        # batch 1: a prompt of 16, 20 slots
B1_MESH = {ZAMBA: (2, 2), VISION: (1, 4), SEAMLESS: (4, 1)}


def _b1_inputs(cfg):
    """Batch 1: (prompt (1, B1_S), fed tokens (1, B1_STEPS), memory (1,
    M, d_model) float32 or None), numpy."""
    rng = np.random.default_rng(31)
    mem = _memory(cfg, B1_S)
    return (rng.integers(0, cfg.vocab, (1, B1_S)),
            rng.integers(0, cfg.vocab, (1, B1_STEPS)),
            None if mem is None else mem[:1])


def _tcfg():
    return trainer.TrainConfig(ota_backend="torch", n_agents=N_AGENTS,
                               **TCFG)


# ---------------------------------------------------------------------------
# the JAX references (a process an arch)
# ---------------------------------------------------------------------------

def _numpy_state(state):
    import jax

    s = jax.tree.map(np.asarray, state)
    return SimpleNamespace(
        params=s.params, step=s.step,
        opt_state=SimpleNamespace(step=s.opt_state.step, mu=s.opt_state.mu,
                                  nu=s.opt_state.nu))


def _jax_job(arch, parts):
    """Of ``parts``, JAX's unsharded serve of ``arch`` (params, forward
    and prefill logits, the prefill's cache, ``STEPS`` greedy steps'
    logits, the tokens fed and the final cache) and one train step (its
    start state, batch, draws, end state and metrics), as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import InputShape as JaxInputShape
    from repro.models import model as jax_model
    from repro.train import server as jax_server

    jc = _cfg(jax_smoke_config, arch)
    jm = jax_model.build(jc)
    # the port's init (XLA compiling JAX's would take most of this job)
    params = interop.params_to_jax(model_lib.build(_port_cfg(arch)).init(
        torch.Generator().manual_seed(0), "cpu"))
    jp = jax.tree.map(jnp.asarray, params)
    out = {}
    if "train" in parts:
        out["train"] = _jax_train(jm, jp)
    if "b1" in parts:
        out["b1"] = _jax_b1(jm, jp)
    if "serve" not in parts:
        return out
    tokens = jnp.asarray(_tokens(jc.vocab).astype(np.int32))
    mem = _memory(jc)
    jmem = None if mem is None else jnp.asarray(mem)
    cap = S + STEPS
    fwd, _ = jm.forward(jp, tokens, jmem)
    log, cache = jm.prefill(jp, tokens, jmem)
    pre = interop.cache_to_numpy(jax.tree.map(np.asarray, cache))
    full = cache if jc.family == "hybrid" else _jax_widen(
        jm, cache, B, cap, mem.shape[1])
    step = jax.jit(jax_server.make_serve_step(
        jm, JaxInputShape("serve", seq_len=cap, global_batch=B,
                          kind="decode")))
    tok = jnp.argmax(log[:, -1:, :], -1).astype(jnp.int32)
    toks, logs = [np.asarray(tok)], []
    for _ in range(STEPS):
        tok, lg, full = step(jp, full, tok)
        toks.append(np.asarray(tok))
        logs.append(np.asarray(lg, np.float32))
    out["serve"] = dict(params=params, fwd=np.asarray(fwd, np.float32),
                        pre=np.asarray(log, np.float32), pre_cache=pre,
                        steps=logs,
                        toks=np.concatenate(toks, 1).astype(np.int64),
                        final=interop.cache_to_numpy(jax.tree.map(
                            np.asarray, full)))
    return out


def _jax_widen(jm, cache, batch, cap, mem_len):
    """The prefill's KV in the first slots of a zero cache of ``cap``."""
    import jax

    full = jm.init_cache(batch, cap, mem_len)
    return full._replace(pos=cache.pos, cross_kv=cache.cross_kv, **{
        f: jax.tree.map(lambda dst, src: jax.lax.dynamic_update_slice(
            dst, src, (0,) * dst.ndim), getattr(full, f), getattr(cache, f))
        for f in KV_FIELDS if getattr(cache, f) is not None})


def _jax_b1(jm, jp):
    """JAX's unsharded batch-1 serve (:func:`_b1_inputs`): the prefill's
    logits and cache, each step's logits and greedy token fed the fixed
    tokens, the final cache; the hybrid decodes from a zero cache."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import InputShape as JaxInputShape
    from repro.train import server as jax_server

    prompt, fed, mem = _b1_inputs(jm.cfg)
    cap = B1_S + B1_STEPS
    log, cache = jm.prefill(jp, jnp.asarray(prompt.astype(np.int32)),
                            None if mem is None else jnp.asarray(mem))
    out = {"pre": np.asarray(log, np.float32),
           "pre_cache": interop.cache_to_numpy(jax.tree.map(np.asarray,
                                                            cache)),
           "steps": [], "next": []}
    full = jm.init_cache(1, cap) if jm.cfg.family == "hybrid" else \
        _jax_widen(jm, cache, 1, cap, mem.shape[1])
    step = jax.jit(jax_server.make_serve_step(
        jm, JaxInputShape("serve", seq_len=cap, global_batch=1,
                          kind="decode")))
    for i in range(B1_STEPS):
        tok, lg, full = step(jp, full, jnp.asarray(
            fed[:, i:i + 1].astype(np.int32)))
        out["steps"].append(np.asarray(lg, np.float32))
        out["next"].append(np.asarray(tok).astype(np.int64))
    out["final"] = interop.cache_to_numpy(jax.tree.map(np.asarray, full))
    return out


def _jax_train(jm, jp):
    """One step of JAX's ``make_train_step`` from ``jp``: its start state,
    batch, draws, end state and metrics (numpy)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import InputShape as JaxInputShape
    from repro.core import ota as jax_ota
    from repro.data.pipeline import make_batch as jax_make_batch
    from repro.train import trainer as jax_trainer

    tj = jax_trainer.TrainConfig(ota_backend="pallas", n_agents=N_AGENTS,
                                 **TCFG)
    state = jax_trainer.TrainState(
        params=jp, opt_state=jax_trainer.make_optimizer(tj).init(jp),
        step=jnp.zeros((), jnp.int32))
    b = jax_make_batch(jm.cfg, JaxInputShape(
        "t", seq_len=SEQ, global_batch=BATCH, kind="train"), 0)
    key = jax.random.key(0)
    kh, kn = jax.random.split(jax.random.fold_in(key, state.step))
    draws = (np.asarray(jax_ota.sample_gains(tj.ota_config(), kh, N_AGENTS)),
             int(jax_ota._kernel_seed(kn)))
    start = _numpy_state(state)
    state, met = jax.jit(jax_trainer.make_train_step(jm, tj))(state, b, key)
    return dict(start=start,
                batch={k: np.asarray(v) if k == "memory"
                       else np.asarray(v).astype(np.int64)
                       for k, v in b.items()},
                draws=draws, end=_numpy_state(state),
                metrics={k: float(v) for k, v in met.items()})


# zamba2's serve and train step in processes of their own (XLA compiling
# its train step is this module's longest wait)
JOBS = ((ZAMBA, ("serve", "b1")), (ZAMBA, ("train",)),
        (VISION, ("serve", "b1", "train")),
        (SEAMLESS, ("serve", "b1", "train")))


@functools.lru_cache(maxsize=None)
def _references():
    """``{arch: {"serve": ..., "train": ...}}``, computed in spawned
    processes at once (``JOBS``)."""
    with ProcessPoolExecutor(
            len(JOBS), mp_context=multiprocessing.get_context("spawn")) as ex:
        done = [(a, ex.submit(_jax_job, a, parts)) for a, parts in JOBS]
        out = {}
        for a, f in done:
            out.setdefault(a, {}).update(f.result())
        return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _np(t):
    return interop.tensor_to_array(t).astype(np.float32)


def _inputs(cfg, s=S):
    mem = _memory(cfg, s)
    return (torch.from_numpy(_tokens(cfg.vocab, s)),
            None if mem is None else torch.from_numpy(mem).to(
                getattr(torch, cfg.dtype)))


def _widen(full, cache, s):
    """The prefill's KV copied into the first ``s`` slots of ``full``'s
    KV fields (local tensors), its ``cross_kv`` and position kept."""
    for f in KV_FIELDS:
        src = getattr(cache, f)
        if src is not None:
            for dst, part in zip(getattr(full, f), src):
                getattr(dst, "to_local", lambda: dst)()[..., :s, :, :] = \
                    getattr(part, "to_local", lambda: part)()
    return full._replace(pos=cache.pos, cross_kv=cache.cross_kv)


def _serve_on_mesh(srv, cfg, toks):
    """Forward, prefill and ``STEPS`` decode steps fed ``toks`` (B, STEPS)
    on ``srv``; gathered logits and caches."""
    tokens, mem = _inputs(cfg)
    fwd, _ = srv.forward(tokens, mem)
    out = {"fwd": _np(fwd.full_tensor())}
    pre, cache = srv.prefill(tokens, mem)
    out["pre"] = _np(pre.full_tensor())
    out["pre_cache"] = interop.cache_to_numpy(cache)
    if cfg.family == "hybrid":
        full = cache
    else:
        full = _widen(srv.init_cache(B, S + STEPS, mem.shape[1],
                                     device="cpu"), cache, S)
    step = srv.make_serve_step(InputShape("serve", seq_len=S + STEPS,
                                          global_batch=B, kind="decode"))
    out["steps"], out["next"], out["collectives"] = [], [], []
    for i in range(STEPS):
        c0 = shard_hints.counts()
        nxt, lg, full = step(full, toks[:, i:i + 1])
        out["collectives"].append(_since(c0))
        out["steps"].append(_np(lg.full_tensor()))
        out["next"].append(nxt.full_tensor().numpy())
    out["final"] = interop.cache_to_numpy(full)
    return out


def _since(c0):
    """(all-reduces, all-gathers) issued since the counts ``c0``."""
    c1 = shard_hints.counts()
    return (c1["all_reduce"] - c0["all_reduce"],
            c1["all_gather"] - c0["all_gather"])


def _widen_sharded(srv, full, cache, s, batch, cap):
    """The prefill's KV fields (DTensors) placed by global slot into the
    first ``s`` slots of ``full`` (``srv.init_cache``'s, ``cap`` slots),
    its ``cross_kv`` and position kept: each rank gathers the prompt's
    cache and keeps its block of the wide one."""
    specs = server.cache_specs(srv.cfg, InputShape("w", cap, batch,
                                                   "decode"), srv.mesh)
    for f in KV_FIELDS:
        if getattr(cache, f) is None:
            continue
        for dst, src, spec in zip(getattr(full, f), getattr(cache, f),
                                  getattr(specs, f)):
            whole = src.full_tensor()
            wide = whole.new_zeros(dst.shape)
            wide[..., :s, :, :] = whole
            dst.to_local().copy_(param.local_shard(wide, spec, srv.mesh))
    return full._replace(pos=cache.pos, cross_kv=cache.cross_kv)


def _b1_case(arch):
    """Batch 1 on ``B1_MESH[arch]`` (:func:`_jax_b1`'s serve): gathered
    logits, next tokens and caches, the collectives of each step, the
    rank's slots of the decode cache and the local ``kv`` shape."""
    m = model_lib.build(_port_cfg(arch))
    srv = server.shard_for_serving(m, m.init(
        torch.Generator().manual_seed(0), "cpu"), _mesh(B1_MESH[arch]))
    prompt, fed, mem = _b1_inputs(m.cfg)
    fed = torch.from_numpy(fed)
    cap = B1_S + B1_STEPS
    pre, cache = srv.prefill(torch.from_numpy(prompt), None if mem is None
                             else torch.from_numpy(mem))
    out = {"pre": _np(pre.full_tensor()),
           "pre_cache": interop.cache_to_numpy(cache),
           "span": srv.slot_span(1, cap), "steps": [], "next": [],
           "collectives": []}
    full = srv.init_cache(1, cap, device="cpu") if m.cfg.family == \
        "hybrid" else _widen_sharded(srv, srv.init_cache(
            1, cap, mem.shape[1], device="cpu"), cache, B1_S, 1, cap)
    kv = next(getattr(full, f) for f in KV_FIELDS
              if getattr(full, f) is not None)
    out["local_kv"] = tuple(kv.k.to_local().shape)
    step = srv.make_serve_step(InputShape("serve", cap, 1, "decode"))
    for i in range(B1_STEPS):
        c0 = shard_hints.counts()
        nxt, lg, full = step(full, fed[:, i:i + 1])
        out["collectives"].append(_since(c0))
        out["steps"].append(_np(lg.full_tensor()))
        out["next"].append(nxt.full_tensor().numpy())
    out["final"] = interop.cache_to_numpy(full)
    return out


def _serve_plain(m, params, toks):
    """The unsharded path of :func:`_serve_on_mesh` (local tensors)."""
    cfg = m.cfg
    tokens, mem = _inputs(cfg)
    out = {"fwd": m.forward(params, tokens, mem)[0]}
    out["pre"], cache = m.prefill(params, tokens, mem)
    out["pre_cache"] = interop.cache_to_numpy(cache)
    if cfg.family == "hybrid":
        full = cache
    else:
        full = _widen(m.init_cache(B, S + STEPS, mem.shape[1],
                                   device="cpu"), cache, S)
    step = server.make_serve_step(m, InputShape(
        "serve", seq_len=S + STEPS, global_batch=B, kind="decode"))
    out["steps"] = []
    for i in range(STEPS):
        _, lg, full = step(params, full, toks[:, i:i + 1])
        out["steps"].append(lg)
    out["final"] = interop.cache_to_numpy(full)
    return out


def _local_counts(tree):
    """(local numel, global numel / the spec's product, global numel) of
    every DTensor leaf of ``tree`` (a flat or nested dict)."""
    out = {}
    for k, v in flatten_paths(tree).items():
        n_shards = 1
        for axis, p in enumerate(v.placements):
            if p.is_shard():
                n_shards *= v.device_mesh.size(axis)
        out[k] = (v.to_local().numel(), v.numel() // n_shards, v.numel())
    return out


def _greedy_tokens(m, params):
    """The unsharded path's prefill token and greedy steps (B, STEPS)."""
    tokens, mem = _inputs(m.cfg)
    log, cache = m.prefill(params, tokens, mem)
    if m.cfg.family != "hybrid":
        cache = _widen(m.init_cache(B, S + STEPS, mem.shape[1],
                                    device="cpu"), cache, S)
    step = server.make_serve_step(m, InputShape(
        "serve", seq_len=S + STEPS, global_batch=B, kind="decode"))
    tok = torch.argmax(log[:, -1:, :], -1)
    toks = [tok]
    for _ in range(STEPS - 1):
        tok, _, cache = step(params, cache, tok)
        toks.append(tok)
    return torch.cat(toks, 1)


def _bf16_case(arch):
    """bf16 on (2, 2) against the unsharded path on the same weights, fed
    the same tokens: the largest |sharded - unsharded| over the max abs
    logit, of the forward, the prefill and each step."""
    m = model_lib.build(_port_cfg(arch, "bfloat16"))
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        toks = _greedy_tokens(m, params)
        plain = _serve_plain(m, params, toks)
        got = _serve_on_mesh(server.shard_for_serving(m, params,
                                                      _mesh((2, 2))),
                             m.cfg, toks)
    pairs = [(got["fwd"], plain["fwd"]), (got["pre"], plain["pre"])] + list(
        zip(got["steps"], plain["steps"]))
    return [float(np.abs(a - _np(b)).max() / np.abs(_np(b)).max())
            for a, b in pairs]


def _shared_grad_case():
    """zamba2's ``shared/*`` gradient through the sharded step's
    ``loss_and_grads`` on (2, 2), gathered, against autograd of the
    unsharded loss: max |got - want| / max |want| a leaf."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data import make_batch

    m = model_lib.build(_port_cfg(ZAMBA))
    mesh = _mesh((2, 2))
    tcfg = _tcfg()
    state = trainer.init_state(m, tcfg, device="cpu")
    batch = make_batch(m.cfg, InputShape("t", SEQ, BATCH, "train"), 0,
                       device="cpu")
    gains = torch.tensor([0.6, 1.1, 1.4, 0.9])
    # the unsharded gradient
    flat = {k: v.detach().clone().requires_grad_()
            for k, v in flatten_paths(state.params).items()}
    tree = replace_paths(state.params, flat)
    per = BATCH // N_AGENTS
    mb = {k: v.reshape((N_AGENTS, per) + v.shape[1:])
          for k, v in batch.items()}
    loss = trainer.make_loss_fn(m)(tree, mb, gains)
    keys = sorted(k for k in flat if k.startswith("shared/"))
    want = dict(zip(keys, torch.autograd.grad(loss, [flat[k]
                                                     for k in keys])))
    # the sharded one
    dstate, step = trainer.shard_for_training(m, tcfg, state, mesh)
    dflat = flatten_paths(dstate.params)
    _, grads = step.sharded.loss_and_grads(
        dstate.params, {k: v.to_local() for k, v in dflat.items()}, batch,
        gains)
    out = {}
    for k in keys:
        whole = DTensor.from_local(grads[k], mesh, dflat[k].placements,
                                   run_check=False).full_tensor()
        out[k] = float((whole - want[k]).abs().max() / want[k].abs().max())
    return out


def _cross_block_collectives():
    """(all-reduces, all-gathers) one vlm cross block issues, no grad, on
    (2, 2) and (1, 4)."""
    m = model_lib.build(_port_cfg(VISION))
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dims in ((2, 2), (1, 4)):
        srv = server.shard_for_serving(m, params, _mesh(dims))
        lay = srv.layout()
        cl = transformer.layer(srv.local["cross_layers"], 0)
        x = torch.randn(B // lay.n_batch, S, m.cfg.d_model)
        mem = torch.randn(B // lay.n_batch, 16, m.cfg.d_model)
        with torch.no_grad(), srv.hints("prefill"):
            kv = attention.project_memory(cl["cross"], mem, m.cfg)
            c0 = shard_hints.counts()
            transformer._cross_block(cl, x, kv, m.cfg, blockwise=False)
            c1 = shard_hints.counts()
        out[dims] = tuple(c1[k] - c0[k] for k in ("all_reduce", "all_gather",
                                                   "reduce_scatter"))
    return out


def _serve_case(arch, dims, ref):
    m = model_lib.build(_port_cfg(arch))
    srv = server.shard_for_serving(m, interop.params_from_jax(
        ref["params"], "cpu"), _mesh(dims))
    lay = srv.layout()
    out = _serve_on_mesh(srv, m.cfg, torch.from_numpy(ref["toks"][:, :STEPS]))
    out["counts"] = _local_counts(srv.params)
    out["layout"] = (lay.model, lay.heads, lay.kv_heads, lay.vocab,
                     lay.n_batch)
    return out


def _train_case(arch, dims, ref):
    m = model_lib.build(_port_cfg(arch))
    state, step = trainer.shard_for_training(
        m, _tcfg(), interop.train_state_from_jax(ref["start"], "cpu"),
        _mesh(dims))
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    draws = (torch.from_numpy(ref["draws"][0].copy()), ref["draws"][1])
    state, met = step(state, batch, draws)
    st = state.opt_state
    counts = _local_counts({"params": state.params, "mu": st.mu,
                            "nu": st.nu})
    full = interop.train_state_to_numpy(state)
    return {"metrics": {k: v.item() for k, v in met.items()},
            "state": full if torch.distributed.get_rank() == 0 else None,
            "counts": counts}


def _wait_for(path, timeout=600.0):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no inputs at {path} after {timeout} s")
        time.sleep(0.05)
    refs = pickle.loads(Path(path).read_bytes())
    if refs is None:
        raise RuntimeError("the JAX references failed in the parent")
    return refs


def _ranks(agent_mesh, path):
    """Every case of the four ranks: those that need nothing of JAX while
    the parent computes the references, then the rest."""
    out = {"bf16": {a: _bf16_case(a) for a in ARCHS},
           "shared_grad": _shared_grad_case(),
           "cross_collectives": _cross_block_collectives(),
           "b1": {a: _b1_case(a) for a in ARCHS}}
    refs = _wait_for(path)
    out["serve"] = {(a, d): _serve_case(a, d, refs[a]["serve"])
                    for a in ARCHS for d in MESHES}
    out["train"] = {(a, d): _train_case(a, d, refs[a]["train"])
                    for a in ARCHS for d in MESHES}
    return out


def _one_rank(agent_mesh):
    """On a (1, 1) mesh: the sharded serve and two sharded train steps
    against the unsharded path and the plain step on the same weights,
    batches and draws, compared here (bitwise)."""
    from repro_torch.data import make_batch

    mesh = mesh_lib.make_tiny_mesh(1, 1)
    out = {}
    for arch in ARCHS:
        m = model_lib.build(_port_cfg(arch))
        params = m.init(torch.Generator().manual_seed(0), "cpu")
        with torch.no_grad():
            toks = _greedy_tokens(m, params)
            plain = _serve_plain(m, params, toks)
            srv = server.shard_for_serving(m, params, mesh)
            got = _serve_on_mesh(srv, m.cfg, toks)
        same = [np.array_equal(got[k], _np(plain[k])) for k in ("fwd", "pre")]
        same += [np.array_equal(a, _np(b))
                 for a, b in zip(got["steps"], plain["steps"])]
        same += [_same_cache(got[k], plain[k]) for k in ("pre_cache",
                                                         "final")]
        tcfg = _tcfg()
        a = trainer.init_state(m, tcfg, device="cpu")
        b, step = trainer.shard_for_training(
            m, tcfg, trainer.init_state(m, tcfg, device="cpu"), mesh)
        plain_step = trainer.make_train_step(m, tcfg)
        for i in range(2):
            batch = make_batch(m.cfg, InputShape("t", SEQ, BATCH, "train"),
                               i, device="cpu")
            a, ma = plain_step(a, batch)
            b, mb = step(b, batch)
            na, nb = (interop.train_state_to_numpy(x) for x in (a, b))
            same.append(all(
                np.array_equal(na[g][k].view(np.uint8),
                               nb[g][k].view(np.uint8))
                for g in ("params", "mu", "nu") for k in na[g])
                and all(ma[k].item() == mb[k].item() for k in ma))
        out[arch] = same
    return out


def _same_cache(a, b):
    return all(a[f] == b[f] if f == "pos" or a[f] is None else
               all(np.array_equal(a[f][k], b[f][k]) for k in a[f])
               for f in a)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """(the four ranks' results, the one rank's).  Both groups start
    while the JAX references are computed; the four ranks take theirs from
    one file, written when they are ready (None if they failed)."""
    path = tmp_path_factory.mktemp("sharded_families") / "refs.pkl"
    with ThreadPoolExecutor(2) as ex:
        one = ex.submit(mesh_lib.run_local, _one_rank, 1, device="cpu")
        four = ex.submit(mesh_lib.run_local, _ranks, 4, str(path),
                         device="cpu", timeout=600)
        refs = None
        try:
            refs = _references()
        finally:
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(pickle.dumps(refs))
            os.replace(tmp, path)
        return four.result(), one.result()[0]


@pytest.fixture(scope="module")
def ranks(groups):
    return groups[0]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.max(np.abs(want))))


def _close_cache(got, want):
    for field, sub in want.items():
        if field == "pos":
            assert got["pos"] == sub
        elif sub is None:
            assert got[field] is None, field
        else:
            for k in sub:
                g, w = (np.asarray(x, np.float32) for x in (got[field][k],
                                                            sub[k]))
                assert g.shape == w.shape, (field, k)
                if np.abs(w).max() == 0:
                    assert np.abs(g).max() == 0, (field, k)
                else:
                    _close(g, w)


def _mesh_id(m):
    return f"{m[0]}x{m[1]}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_sharded_serve_matches_jax(ranks, mesh, arch):
    ref = _references()[arch]["serve"]
    for r in ranks:
        got = r["serve"][(arch, mesh)]
        _close(got["fwd"], ref["fwd"])
        _close(got["pre"], ref["pre"])
        _close_cache(got["pre_cache"], ref["pre_cache"])
        for a, b in zip(got["steps"], ref["steps"]):
            _close(a, b)
        _close_cache(got["final"], ref["final"])
        np.testing.assert_array_equal(np.concatenate(got["next"], 1),
                                      ref["toks"][:, 1:])


def _flat_np(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_paths(tree).items()}


def _lr1():
    from repro_torch.optim.optimizers import warmup_cosine

    return warmup_cosine(LR, TCFG["warmup"], TCFG["total_steps"])(
        torch.tensor(1, dtype=torch.int32)).item()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_sharded_train_step_matches_jax(ranks, mesh, arch):
    ref = _references()[arch]["train"]
    got = ranks[0]["train"][(arch, mesh)]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=RTOL,
                                   err_msg=k)
    have = got["state"]
    assert have["step"] == 1 and have["opt_step"] == 1
    # the params as test_torch_sharded_train.py holds them: AdamW moves an
    # element whose gradient cancels to rounding level by up to 2 lr_t
    lr_t, n_out, n_all = _lr1(), 0, 0
    for k, w in _flat_np(ref["end"].params).items():
        diff = np.abs(np.asarray(have["params"][k], np.float32) - w)
        n_out += int((diff > 1e-6 + RTOL * np.abs(w)).sum())
        n_all += w.size
        assert diff.max() <= 2 * lr_t * 1.01 + 1e-6, k
    assert n_out <= 5e-4 * n_all, (n_out, n_all)
    for name in ("mu", "nu"):
        want = _flat_np(getattr(ref["end"].opt_state, name))
        assert set(want) == set(have[name])
        for k, w in want.items():
            np.testing.assert_allclose(
                np.asarray(have[name][k], np.float32), w, rtol=RTOL,
                atol=1e-5 * float(np.abs(w).max()), err_msg=f"{name}/{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serve_on_2x2_matches_unsharded(ranks, arch):
    for r in ranks:
        errs = r["bf16"][arch]
        assert len(errs) == 2 + STEPS
        assert max(errs) < 2e-2, errs


def test_shared_block_gradient_sums_its_uses(ranks):
    """Both groups' uses of the shared block, gathered over ``data`` and
    cut over ``model``: the gradient of every ``shared/*`` leaf is the
    unsharded one (a missing or doubled sum would be 0.5 or 1 off)."""
    n_groups = transformer.hybrid_groups(_port_cfg(ZAMBA))[0]
    assert n_groups == 2
    for r in ranks:
        errs = r["shared_grad"]
        assert len(errs) == len(flatten_paths(
            transformer.dense_layer_plan(_port_cfg(ZAMBA))))
        assert max(errs.values()) < 1e-5, errs


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_every_rank_bitwise_the_others(ranks, mesh):
    for arch in ARCHS:
        s0, t0 = ranks[0]["serve"][(arch, mesh)], \
            ranks[0]["train"][(arch, mesh)]
        for r in ranks[1:]:
            got = r["serve"][(arch, mesh)]
            for name in ("fwd", "pre"):
                assert np.array_equal(got[name], s0[name]), (arch, name)
            for a, b in zip(got["steps"] + got["next"],
                            s0["steps"] + s0["next"]):
                assert np.array_equal(a, b), arch
            assert r["train"][(arch, mesh)]["metrics"] == t0["metrics"], arch


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_only_its_shards(ranks, arch):
    for r in ranks:
        for mesh in MESHES:
            for what in ("serve", "train"):
                counts = r[what][(arch, mesh)]["counts"]
                assert counts and all(a == b for a, b, _ in
                                      counts.values()), (what, mesh)
                local = sum(a for a, _, _ in counts.values())
                # FSDP (d_model over data) or the model axis cuts most
                # leaves in training; the model axis in serving
                if what == "train" or mesh[1] > 1:
                    assert local < sum(c for _, _, c in counts.values()) \
                        / 1.5, (what, mesh)


def test_layouts_on_the_meshes(ranks):
    """Vision's 2 kv heads on (1, 4): the q heads sharded, the kv heads
    replicated (its serve above then reads them from a whole cache); on
    (2, 2) both sharded; the vocabulary (512 at smoke) sharded; the batch
    over the data axis."""
    for r in ranks:
        lay = {k: v["layout"] for k, v in r["serve"].items()}
        assert lay[(VISION, (1, 4))] == (4, True, False, True, 1)
        assert lay[(VISION, (2, 2))] == (2, True, True, True, 2)
        for arch in (ZAMBA, SEAMLESS):
            assert lay[(arch, (2, 2))] == (2, True, True, True, 2)
            assert lay[(arch, (4, 1))][4] == 4


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=_mesh_id)
def test_cross_block_collectives(ranks, mesh):
    """One all-reduce after self attention's ``wo``, one after cross
    attention's, one after ``down``; nothing gathered."""
    for r in ranks:
        assert r["cross_collectives"][mesh] == (3, 0, 0)


def _attention_layers(cfg):
    """The self-attention layers one decode step runs."""
    if cfg.family == "hybrid":
        return transformer.hybrid_groups(cfg)[0]
    return cfg.n_layers


def test_sequence_sharded_cache_raises_for_each_family(ranks):
    """Each family's batch-1 cache is sequence-sharded (it raised before
    the combine existed): the rank holds slots ``[r cap/n, (r+1) cap/n)``,
    and a decode step issues the batch-4 serve's collectives on the same
    mesh plus, a self-attention layer, one all-reduce max and one sum a
    sequence axis and a gather of q where that axis is ``model``."""
    cap = B1_S + B1_STEPS
    for rank, r in enumerate(ranks):
        for arch in ARCHS:
            dims = B1_MESH[arch]
            got, cfg = r["b1"][arch], _port_cfg(arch)
            span = got["span"]
            assert span is not None, arch
            axes = ("model",) if cfg.n_kv_heads % dims[1] else ("data",)
            idx = rank if axes == ("model",) else rank // dims[1]
            per = cap // (dims[1] if axes == ("model",) else dims[0])
            assert span == (idx * per, (idx + 1) * per, cap, axes), arch
            assert got["local_kv"][-3] == per and \
                got["local_kv"][-4] == 1, arch
            n = _attention_layers(cfg)
            base = r["serve"][(arch, dims)]["collectives"][0]
            want = (base[0] + 2 * n, base[1] + n * (axes == ("model",)))
            assert got["collectives"] == [want] * B1_STEPS, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_1_sequence_sharded_serve_matches_jax(ranks, arch):
    """Batch 1 with the cache's sequence sharded (``B1_MESH``): the
    prefill and its cache, each step's logits and greedy token and the
    final cache against JAX's unsharded path (rtol 1e-5), every rank
    bitwise the others."""
    ref = _references()[arch]["b1"]
    r0 = ranks[0]["b1"][arch]
    for r in ranks:
        got = r["b1"][arch]
        _close(got["pre"], ref["pre"])
        _close_cache(got["pre_cache"], ref["pre_cache"])
        for a, b in zip(got["steps"], ref["steps"]):
            _close(a, b)
        _close_cache(got["final"], ref["final"])
        np.testing.assert_array_equal(np.concatenate(got["next"], 1),
                                      np.concatenate(ref["next"], 1))
        for a, b in zip(got["steps"] + got["next"],
                        r0["steps"] + r0["next"]):
            assert np.array_equal(a, b), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_bitwise_unsharded(groups, arch):
    # forward, prefill, the steps, both caches, two train steps
    assert groups[1][arch] == [True] * (2 + STEPS + 2 + 2)


class FakeMesh:
    """Rank 0 of a ``("data", "model")`` mesh, for the layout alone."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model_):
        self.shape = {"data": data, "model": model_}

    @staticmethod
    def get_coordinate():
        return [0, 0]


HELD = ("heads", "kv_heads", "d_ff", "d_inner", "ssm_heads", "vocab")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_weights_layout_agrees_with_hints(mesh, arch):
    """Leaf by leaf (the cross blocks', the encoder's and the hybrid's
    shared block's included): each logical axis the hints' layout runs
    sharded is sharded over ``model`` in the weights' serve spec, and
    each it runs whole is whole."""
    fake = FakeMesh(*mesh)
    cfg = _port_cfg(arch)
    with shard_hints.hints(fake, **shard_hints.attn_hints(cfg, fake,
                                                          "prefill")):
        lay = shard_hints.layout(cfg)
    decls = flatten_paths(model_lib.build(cfg).plan)
    seen = set()
    for k, d in decls.items():
        spec = param.spec_for(d, param.serve_rules(), fake)
        for dim, axis in enumerate(d.axes):
            if axis in HELD:
                sharded = dim < len(spec) and spec[dim] == "model"
                assert sharded == getattr(lay, axis), (k, axis)
                seen.add(k.split("/")[0])
    want = {"embed", {ZAMBA: "shared", VISION: "cross_layers",
                      SEAMLESS: "enc_layers"}[arch]}
    assert want <= seen, seen


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=_mesh_id)
def test_published_seamless_vocabulary_layout(mesh):
    """seamless-m4t-large-v2's vocabulary (256206 = 2 x 128103) divides
    2 and not 4: on (1, 4) its embedding is replicated over ``model`` and
    the layout reads that from the weights while the heads are sharded;
    on (2, 2) both are sharded."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import embed_plan

    fake = FakeMesh(*mesh)
    cfg = get_config(SEAMLESS)
    assert cfg.vocab == 256206
    with shard_hints.hints(fake, **shard_hints.attn_hints(cfg, fake,
                                                          "prefill")):
        lay = shard_hints.layout(cfg)
    split = mesh[1] == 2
    assert (lay.vocab, lay.heads, lay.kv_heads, lay.d_ff) == (
        split, True, True, True)
    assert ("model" in param.spec_for(embed_plan(cfg)["tok"],
                                      param.serve_rules(), fake)) == split


def test_counter_map_wraps_past_2_32_as_jax():
    """zamba2-7b at full depth has 6.75e9 parameters: a rank's leaf blocks
    past 2^32 in the whole gradient take counters past 2^32, which wrap
    modulo 2^32 as the JAX package's uint32 counter does
    (``_counter_noise``'s ``start.astype(uint32) + pos``): the port's
    mapped counters and their two 24-bit streams equal JAX's, bit for
    bit, and the normals within rtol 1e-6 (torch's and XLA's log and cos
    part by an ulp)."""
    import jax.numpy as jnp

    from repro.kernels import ota_fused as jax_k1
    from repro_torch.kernels import ota_fused, ref

    seed, start, n = 987654, 2 ** 32 - 5, 12
    cmap = ota_fused.CounterMap([(0, start, [n], [1])])
    counters = cmap.counters("cpu")
    assert counters.tolist() == [(start + i) % 2 ** 32 for i in range(n)]
    b1, b2 = ref.counter_bits_at(seed, counters)
    counter = jnp.uint32(start) + jnp.arange(n, dtype=jnp.uint32)
    base = jax_k1._mix(counter, jnp.uint32(seed) * jnp.uint32(0x9E3779B9))
    want1 = np.asarray(jax_k1._mix(base, jnp.uint32(0xA511E9B3)) >> 8)
    want2 = np.asarray(jax_k1._mix(base, jnp.uint32(0x63D83595)) >> 8)
    np.testing.assert_array_equal(b1.numpy(), want1.astype(np.int64))
    np.testing.assert_array_equal(b2.numpy(), want2.astype(np.int64))
    noise = ota_fused.fused_aggregate(torch.zeros(1, n), torch.ones(1),
                                      sigma=1.0, scale=1.0, seed=seed,
                                      counter_map=cmap)
    want = np.asarray(jax_k1._counter_noise(jnp.uint32(seed),
                                            jnp.uint32(start), (1, n)))[0]
    np.testing.assert_allclose(noise.numpy(), want, rtol=1e-6, atol=1e-6)
