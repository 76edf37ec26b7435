"""The port's tensor-parallel serve path (``train.server.shard_for_serving``)
on ``torch.distributed`` ranks against the JAX package's unsharded model.

One group of four ``gloo`` ranks (``launch.mesh.run_local``) runs every
case of this module once (the module-scoped fixture); the tests read its
results.  The JAX references (smoke llama3.2-3b, granite-moe-1b-a400m and
mamba2-130m: forward, prefill with its cache, greedy decode steps) are
computed once per arch and dtype in this process, and their parameters
(numpy) go to the ranks, which lay them out as DTensors under
``serve_rules`` (``interop.params_to_mesh``):

* on ``("data", "model")`` meshes (2, 2) and (4, 1), batch 4, prompt 16,
  3 decode steps (the ranks feed the JAX package's greedy tokens):
  forward, prefill (logits and every cache field) and each step's logits
  against JAX, float32 at rtol 1e-5 with atol 1e-5 max|want| (the
  row-parallel all-reduces sum in another order than one product) and the
  same greedy tokens, bfloat16 within 2e-2 of the max abs logit (the JAX
  package's own bound; on these inputs its compiled MoE routes as the
  port does on every mesh);
* every rank's gathered logits and next tokens bitwise the others';
* one all-reduce per row-parallel block, counted (``shard_hints``), and
  the embedding's and the MoE routing's collectives;
* the mixed GQA case, smoke llama (H = 4, Hkv = 2) forward on (1, 4): each
  rank's one q head reads the replicated kv head it belongs to;
* on (1, 4), float32, a prompt of 15 (a capacity 4 does not divide, so
  the cache of replicated kv heads is replicated, not sequence-sharded):
  the whole serve against JAX of smoke llama, of smoke llama with H = 12,
  Hkv = 3 (each rank's 3 q heads read kv heads 0-2 of 3 one by one) and
  of smoke granite with 6 experts (4 does not divide them, so the
  experts' ``d_ff`` is sharded and the combine all-reduced);
* the hints decide what runs: a hint map that shards what the weights do
  not raises; MoE under the ``moe_cap`` hint (serving) runs a buffer of
  its batch shard's slots, without it (training's hints) one of the whole
  batch's capacity, both equal to JAX;
* MoE dispatch (granite's first layer, T = 32, capacity factor 1.0, which
  drops, and 4.0, which does not) on (2, 2) and (4, 1): the routing
  bitwise across the ranks of a ``model`` group, and the dispatch integers
  (``keep``, ``dest``) of the batch shards, joined, equal to JAX's global
  dispatch (read through a spy on its ``jnp.where``);
* the sequence-sharded cache (``SEQ_CASES``; params from the port's
  init, the same numpy weights in both packages, fixed tokens fed, the
  JAX references computed here while the ranks run): smoke llama at
  batch 1 on (2, 2) and (4, 1) (the sequence over ``data``) and on (1, 4)
  (over ``model``, a capacity 4 divides, every q head gathered), the
  ``gqa-12-3`` variant at batch 1 on (2, 2) (over ``("data", "model")``),
  a ``serve_window = 8`` ring decoding 12 tokens from an empty cache (the
  slots wrap; early on a shard sees no valid slot), granite at batch 1
  (MoE on a replicated batch), mamba2 at batch 1 (a replicated state),
  ``long_500k`` lowered as JAX lowers it (``init_cache_for_shape`` at
  ``pos = S - 1``, one ``serve_step``) and a batch of 3 on (2, 2)
  (replicated batch and cache): the prefill and its cache, each step's
  logits and greedy token and the final cache against JAX's unsharded
  path, float32 at rtol 1e-5 (atol 1e-5 max|want|), bf16 within 2e-2 of
  the max abs logit; every rank bitwise the others; the combine's
  collectives a layer (one all-reduce max and one sum a sequence axis,
  one gather of q over ``model`` where it is a sequence axis), and none
  added where the cache is not sequence-sharded;
* the layouts that raised before this path existed (a sequence-sharded
  prefill and cache, batch 1, batch 3) now run; a production mesh on a
  group of another size raises; ``n_data_shards``;
* outside a hints context no collective is issued and the model is
  bitwise this process's, which never entered one;
* a one-rank (1, 1) mesh, the card's layout: forward, prefill and decode
  bitwise the unsharded path on the same weights, float32 and bfloat16.
"""
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.data import make_batch_specs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model, moe, param
from repro_torch.train import server
from repro_torch.utils import shard_hints

ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "mamba2-130m")
DTYPES = ("float32", "bfloat16")
MESHES = ((2, 2), (4, 1))
B, S, STEPS = 4, 16, 3
RTOL = 1e-5
MOE_CF = {"drops": 1.0, "no-drops": 4.0}
S_ODD = 15          # a (1, 4) prompt: 4 divides neither it nor S_ODD + STEPS
VARIANTS = {        # the (1, 4) cases: (arch, overrides of its smoke config)
    "llama": ("llama3.2-3b", {}),
    "gqa-12-3": ("llama3.2-3b", {"n_heads": 12, "n_kv_heads": 3,
                                 "d_head": 16}),
    "moe-6": ("granite-moe-1b-a400m", {"num_experts": 6}),
}


def _variant(cfg, over):
    """``cfg`` with ``over`` (``num_experts`` goes into its MoE config);
    the same for both packages' configs."""
    import dataclasses

    over = dict(over)
    if "num_experts" in over:
        over["moe"] = dataclasses.replace(cfg.moe,
                                          num_experts=over.pop("num_experts"))
    return cfg.with_(**over)


def _tokens(vocab, s=S):
    return np.random.default_rng(13).integers(0, vocab, (B, S)).astype(
        np.int64)[:, :s]


class SeqCase(NamedTuple):
    """A sequence-sharded (or replicated-batch) serve case: ``arch`` with
    ``over`` (``VARIANTS``' form), a batch of ``batch``; ``how``: "prefill"
    (a prompt of ``prompt``, its cache widened to ``prompt + steps``
    slots, the SSM decoding from its prefill's), "empty" (decode from a
    zero cache of ``serve_capacity(cfg, SEQ_RING_LEN)`` slots at 0) or
    "long_500k" (its shape's cache at ``pos = S - 1``); ``steps`` tokens
    fed; on ``meshes``."""

    arch: str
    over: dict
    dtype: str
    batch: int
    prompt: int
    steps: int
    how: str
    meshes: tuple


SEQ_RING_LEN = 16          # the ring case's shape: 8 slots, 16 positions
SEQ_CASES = {
    "llama": SeqCase("llama3.2-3b", {}, "float32", 1, 16, 4, "prefill",
                     ((2, 2), (4, 1), (1, 4))),
    "llama-bf16": SeqCase("llama3.2-3b", {}, "bfloat16", 1, 16, 4,
                          "prefill", ((2, 2), (4, 1))),
    "gqa-12-3": SeqCase("llama3.2-3b", VARIANTS["gqa-12-3"][1], "float32",
                        1, 16, 4, "prefill", ((2, 2),)),
    "ring": SeqCase("llama3.2-3b", {"serve_window": 8}, "float32", 1, 0, 12,
                    "empty", ((2, 2), (4, 1))),
    "granite": SeqCase("granite-moe-1b-a400m", {}, "float32", 1, 16, 4,
                       "prefill", ((2, 2),)),
    "mamba2": SeqCase("mamba2-130m", {}, "float32", 1, 16, 4, "prefill",
                      ((4, 1),)),
    "long_500k": SeqCase("llama3.2-3b", {}, "float32", 1, 0, 1,
                         "long_500k", ((2, 2), (4, 1))),
    "batch-3": SeqCase("llama3.2-3b", {}, "float32", 3, 15, 4, "prefill",
                       ((2, 2),)),
}


def _seq_cfg(get_config, name):
    case = SEQ_CASES[name]
    return _variant(get_config(case.arch).with_(dtype=case.dtype),
                    case.over)


def _seq_inputs(name, vocab):
    """(prompt (batch, prompt), fed tokens (batch, steps)), int64."""
    case = SEQ_CASES[name]
    rng = np.random.default_rng(29)
    return (rng.integers(0, vocab, (case.batch, case.prompt)),
            rng.integers(0, vocab, (case.batch, case.steps)))


def _seq_shape(name, cls):
    """The serve step's input shape (``cls``: either package's
    ``InputShape``) and the cache's capacity."""
    case = SEQ_CASES[name]
    if case.how == "long_500k":
        return cls("long_500k", 524_288, case.batch, "decode"), 8192
    if case.how == "empty":
        return cls("ring", SEQ_RING_LEN, case.batch, "decode"), 8
    cap = case.prompt + case.steps
    return cls("serve", cap, case.batch, "decode"), cap


def _moe_x():
    return np.random.default_rng(7).standard_normal((4, 8, 128)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the JAX references (this process)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_serve(arch, dtype, variant=None, s=S):
    """The JAX package's smoke params (numpy), forward logits, prefill
    logits and cache, and its greedy serve: ``STEPS`` steps' logits, the
    tokens fed (the prefill's greedy token first) and the final cache.
    ``variant``: a key of ``VARIANTS`` (its arch), ``s`` the prompt."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import InputShape as JaxInputShape
    from repro.models import model as jax_model
    from repro.train import server as jax_server

    jc = jax_smoke_config(arch).with_(dtype=dtype)
    if variant is not None:
        jc = _variant(jc, VARIANTS[variant][1])
    jm = jax_model.build(jc)
    jp = jax.jit(jm.init)(jax.random.key(0))
    tokens = jnp.asarray(_tokens(jm.cfg.vocab, s).astype(np.int32))
    cap = s + STEPS
    fwd, _ = jm.forward(jp, tokens)
    log, cache = jm.prefill(jp, tokens)
    pre = interop.cache_to_numpy(jax.tree.map(np.asarray, cache))
    if jm.cfg.family == "ssm":
        full = cache
    else:
        full = jm.init_cache(B, cap)
        full = full._replace(pos=cache.pos, kv=jax.tree.map(
            lambda dst, src: jax.lax.dynamic_update_slice(
                dst, src, (0,) * dst.ndim), full.kv, cache.kv))
    step = jax.jit(jax_server.make_serve_step(
        jm, JaxInputShape("serve", seq_len=cap, global_batch=B,
                          kind="decode")))
    tok = jnp.argmax(log[:, -1:, :], -1).astype(jnp.int32)
    toks, logs = [np.asarray(tok)], []
    for _ in range(STEPS):
        tok, lg, full = step(jp, full, tok)
        toks.append(np.asarray(tok))
        logs.append(np.asarray(lg, np.float32))
    return dict(params=jax.tree.map(np.asarray, jp),
                fwd=np.asarray(fwd, np.float32),
                pre=np.asarray(log, np.float32), pre_cache=pre,
                steps=logs, toks=np.concatenate(toks, 1).astype(np.int64),
                final=interop.cache_to_numpy(jax.tree.map(np.asarray, full)))


@functools.lru_cache(maxsize=None)
def _jax_moe(cf):
    """Granite's first MoE layer (numpy params), its output on
    ``_moe_x()`` and the global dispatch integers, read from the JAX
    function through a spy on its ``jnp.where`` (its first call is
    ``dest = jnp.where(keep, ...)``)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import moe as jax_moe

    jc = jax_smoke_config("granite-moe-1b-a400m")
    jc = jc.with_(moe=dataclasses.replace(jc.moe, capacity_factor=cf))
    params = jax.tree.map(lambda x: np.asarray(x[0]), _jax_serve(
        "granite-moe-1b-a400m", "float32")["params"]["layers"]["moe"])
    calls = []

    class Spy:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def where(self, *args):
            out = jnp.where(*args)
            calls.append((args, out))
            return out

    real = jax_moe.jnp
    jax_moe.jnp = Spy()
    try:
        out, _ = jax_moe.moe_ffn(jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(_moe_x()), jc)
    finally:
        jax_moe.jnp = real
    (keep, _, _), dest = calls[0]
    return dict(params=params, out=np.asarray(out), keep=np.asarray(keep),
                dest=np.asarray(dest))


@functools.lru_cache(maxsize=None)
def _seq_params(name):
    """The port's init of a ``SEQ_CASES`` config (seed 0), as numpy."""
    cfg = _seq_cfg(get_smoke_config, name)
    return interop.params_to_jax(model.build(cfg).init(
        torch.Generator().manual_seed(0), "cpu"))


def _seq_reference(name):
    """The JAX package's unsharded serve of a ``SEQ_CASES`` case: the
    prefill's logits and cache (None for "empty" and "long_500k"), each
    step's logits and greedy token, the final cache."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.configs.base import InputShape as JaxInputShape
    from repro.models import model as jax_model
    from repro.train import server as jax_server

    case = SEQ_CASES[name]
    jm = jax_model.build(_seq_cfg(jax_smoke_config, name))
    jp = jax.tree.map(jnp.asarray, _seq_params(name))
    prompt, fed = _seq_inputs(name, jm.cfg.vocab)
    shape, cap = _seq_shape(name, JaxInputShape)
    out = {"pre": None, "pre_cache": None}
    if case.how == "long_500k":
        full = jax_server.init_cache_for_shape(jm, shape)
    elif case.how == "empty":
        full = jm.init_cache(case.batch, cap)
    else:
        log, cache = jm.prefill(jp, jnp.asarray(prompt.astype(np.int32)))
        out["pre"] = np.asarray(log, np.float32)
        out["pre_cache"] = interop.cache_to_numpy(jax.tree.map(np.asarray,
                                                               cache))
        full = cache if jm.cfg.family == "ssm" else jm.init_cache(
            case.batch, cap)._replace(pos=cache.pos, kv=jax.tree.map(
                lambda dst, src: jax.lax.dynamic_update_slice(
                    dst, src, (0,) * dst.ndim), jm.init_cache(
                        case.batch, cap).kv, cache.kv))
    step = jax.jit(jax_server.make_serve_step(jm, shape))
    out["steps"], out["next"] = [], []
    for i in range(case.steps):
        tok, lg, full = step(jp, full, jnp.asarray(
            fed[:, i:i + 1].astype(np.int32)))
        out["steps"].append(np.asarray(lg, np.float32))
        out["next"].append(np.asarray(tok).astype(np.int64))
    out["final"] = interop.cache_to_numpy(jax.tree.map(np.asarray, full))
    if case.how == "long_500k":
        # XLA's compiled rope frequencies are an ulp off the eager ones
        # (the port's): at position 524287 the K written there turns by up
        # to 0.02 rad, so that cache is held to the port's unsharded step
        cfg = _seq_cfg(get_smoke_config, name)
        tm, tshape = model.build(cfg), _seq_shape(name, InputShape)[0]
        cache = server.init_cache_for_shape(tm, tshape, device="cpu")
        _, _, cache = server.make_serve_step(tm, tshape)(
            interop.params_from_jax(_seq_params(name), "cpu"), cache,
            torch.from_numpy(fed))
        out["final"] = interop.cache_to_numpy(cache)
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _counts():
    return shard_hints.ALL_REDUCES, shard_hints.ALL_GATHERS


def _np(t):
    return interop.tensor_to_array(t).astype(np.float32)


def _serve_on_mesh(srv, ref, cfg, s=S):
    """Forward, prefill, the widened cache and ``STEPS`` decode steps fed
    the JAX package's tokens, on ``srv`` (a prompt of ``s``); gathered
    results."""
    tokens = torch.from_numpy(_tokens(cfg.vocab, s))
    c0 = _counts()
    fwd, _ = srv.forward(tokens)
    c1 = _counts()
    out = {"collectives": (c1[0] - c0[0], c1[1] - c0[1]),
           "fwd_local": fwd.to_local().clone(), "fwd": _np(fwd.full_tensor())}
    pre, cache = srv.prefill(tokens)
    out["pre"] = _np(pre.full_tensor())
    out["pre_cache"] = interop.cache_to_numpy(cache)
    cap = s + STEPS
    if cfg.family == "ssm":
        full = cache
    else:
        full = srv.init_cache(B, cap, device="cpu")
        for dst, src in zip(full.kv, cache.kv):
            dst.to_local()[:, :, :s] = src.to_local()
        full = full._replace(pos=cache.pos)
    step = srv.make_serve_step(InputShape("serve", seq_len=cap,
                                          global_batch=B, kind="decode"))
    toks = torch.from_numpy(ref["toks"])
    out["steps"], out["next"] = [], []
    for i in range(STEPS):
        nxt, lg, full = step(full, toks[:, i:i + 1])
        out["steps"].append(_np(lg.full_tensor()))
        out["next"].append(nxt.full_tensor().numpy())
    out["final"] = interop.cache_to_numpy(full)
    out["local_kv"] = None if cfg.family == "ssm" else tuple(
        full.kv.k.to_local().shape)
    return out


def _widen_sharded(srv, full, cache, s, batch, cap):
    """The prefill's KV fields (DTensors) placed by global slot into the
    first ``s`` slots of ``full`` (``srv.init_cache``'s, ``cap`` slots):
    each rank gathers the prompt's cache and keeps its block of the wide
    one (its slots, batch rows and kv heads)."""
    specs = server.cache_specs(srv.cfg, InputShape("w", cap, batch,
                                                   "decode"), srv.mesh)
    for f in ("kv", "groups_kv", "cross_self_kv"):
        if getattr(cache, f) is None:
            continue
        for dst, src, spec in zip(getattr(full, f), getattr(cache, f),
                                  getattr(specs, f)):
            whole = src.full_tensor()
            wide = whole.new_zeros(dst.shape)
            wide[..., :s, :, :] = whole
            dst.to_local().copy_(param.local_shard(wide, spec, srv.mesh))
    return full._replace(pos=cache.pos, cross_kv=cache.cross_kv)


def _seq_on_mesh(name, dims):
    """A ``SEQ_CASES`` case on a ``dims`` mesh: the gathered prefill,
    each step's logits and next token, the caches, the collectives of
    each step and the rank's slot span of the decode cache."""
    case = SEQ_CASES[name]
    cfg = _seq_cfg(get_smoke_config, name)
    srv = server.shard_for_serving(model.build(cfg), interop.params_from_jax(
        _seq_params(name), "cpu"), mesh_lib.make_tiny_mesh(*dims))
    prompt, fed = (torch.from_numpy(x) for x in _seq_inputs(name,
                                                            cfg.vocab))
    shape, cap = _seq_shape(name, InputShape)
    out = {"pre": None, "pre_cache": None, "span": srv.slot_span(
        case.batch, cap), "layout": srv.layout(case.batch)}
    if case.how == "long_500k":
        full = srv.init_cache(case.batch, cap, device="cpu")._replace(
            pos=shape.seq_len - 1)
    elif case.how == "empty":
        full = srv.init_cache(case.batch, cap, device="cpu")
    else:
        pre, cache = srv.prefill(prompt)
        out["pre"] = _np(pre.full_tensor())
        out["pre_cache"] = interop.cache_to_numpy(cache)
        out["pre_span"] = srv.slot_span(case.batch, case.prompt)
        full = cache if cfg.family == "ssm" else _widen_sharded(
            srv, srv.init_cache(case.batch, cap, device="cpu"), cache,
            case.prompt, case.batch, cap)
    step = srv.make_serve_step(shape)
    out["steps"], out["next"], out["collectives"] = [], [], []
    for i in range(case.steps):
        c0 = _counts()
        nxt, lg, full = step(full, fed[:, i:i + 1])
        c1 = _counts()
        out["collectives"].append((c1[0] - c0[0], c1[1] - c0[1]))
        out["steps"].append(_np(lg.full_tensor()))
        out["next"].append(nxt.full_tensor().numpy())
    out["final"] = interop.cache_to_numpy(full)
    if cfg.family != "ssm":
        out["local_kv"] = tuple(full.kv.k.to_local().shape)
    return out


def _moe_on_mesh(mesh, cf, ref, kind="prefill"):
    """Granite's first MoE layer on ``mesh`` over ``_moe_x()``'s batch
    shards under ``kind``'s hints; the dispatch integers of this rank's
    tokens (a spy on ``moe.dispatch``), the shape of the buffer the
    experts ran (a spy on ``torch.bmm``) and the gathered output."""
    import dataclasses

    cfg = get_smoke_config("granite-moe-1b-a400m").with_(dtype="float32")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    local = param.local_params(interop.params_to_mesh(
        ref["params"], moe.moe_plan(cfg), param.serve_rules(), mesh, "cpu"))
    seen, bufs = [], []
    real, real_bmm = moe.dispatch, torch.bmm

    def spy(*args, **kw):
        res = real(*args, **kw)
        seen.append(res)
        return res

    def bmm_spy(a, b):
        bufs.append(tuple(a.shape))
        return real_bmm(a, b)

    moe.dispatch, torch.bmm = spy, bmm_spy
    try:
        with shard_hints.hints(mesh, **shard_hints.attn_hints(
                cfg, mesh, kind)):
            lay = shard_hints.layout(cfg)
            x = torch.from_numpy(_moe_x()).chunk(lay.n_batch)[lay.batch_rank]
            out, _ = moe.moe_ffn(local, x, cfg)
            whole = shard_hints.all_gather(out, 0, lay.batch_axes)
    finally:
        moe.dispatch, torch.bmm = real, real_bmm
    (_, keep, dest), = seen
    return dict(batch_rank=lay.batch_rank, model_rank=lay.model_rank,
                keep=keep.numpy(), dest=dest.numpy(), out=whole.numpy(),
                moe_cap=lay.moe_cap, buf=bufs[0], tokens=x.shape[0] *
                x.shape[1], cap=moe._capacity(_moe_x().shape[0]
                                             * _moe_x().shape[1], cfg))


def _rank_cases(am, refs, moe_refs, odd_refs):
    """Every case of this module on one rank of four."""
    res = {"rank": am.rank, "serve": {}, "moe": {}, "n_data": {}}
    for data, model_ in MESHES:
        mesh = mesh_lib.make_tiny_mesh(data, model_)
        res["n_data"][(data, model_)] = mesh_lib.n_data_shards(mesh)
        for (arch, dtype), ref in refs.items():
            tm = model.build(get_smoke_config(arch).with_(dtype=dtype))
            srv = server.shard_for_serving(tm, interop.params_from_jax(
                ref["params"], "cpu"), mesh)
            res["serve"][(data, model_, arch, dtype)] = _serve_on_mesh(
                srv, ref, tm.cfg)
            res.setdefault("layout", {})[(data, model_, arch)] = srv.layout()
        for name, cf in MOE_CF.items():
            res["moe"][(data, model_, name)] = _moe_on_mesh(
                mesh, cf, moe_refs[name])
            res["moe"][(data, model_, name, "train")] = _moe_on_mesh(
                mesh, cf, moe_refs[name], "train")
        # a hint map that shards the heads the weights replicate
        arch = "llama3.2-3b"
        tm = model.build(get_smoke_config(arch).with_(dtype="float32"))
        hint_map = shard_hints.attn_hints(tm.cfg, mesh, "prefill")
        hint_map.pop("heads")
        try:
            with shard_hints.hints(mesh, **hint_map):
                shard_hints.layout(tm.cfg)
            res.setdefault("bad_hints", {})[(data, model_)] = None
        except ValueError as exc:
            res.setdefault("bad_hints", {})[(data, model_)] = str(exc)
        # the same forward with the tokens as a DTensor of make_batch_specs
        arch = "llama3.2-3b"
        tm = model.build(get_smoke_config(arch).with_(dtype="float32"))
        srv = server.shard_for_serving(tm, interop.params_from_jax(
            refs[(arch, "float32")]["params"], "cpu"), mesh)
        tok = param.distribute_tensor(
            torch.from_numpy(_tokens(tm.cfg.vocab)),
            make_batch_specs(tm.cfg, InputShape("p", S, B, "prefill"),
                             mesh)["tokens"])
        res.setdefault("dtensor_tokens", {})[(data, model_)] = _np(
            srv.forward(tok)[0].full_tensor())

    # the mixed GQA case: q heads over 4 ranks, the 2 kv heads replicated
    mesh = mesh_lib.make_tiny_mesh(1, 4)
    arch = "llama3.2-3b"
    tm = model.build(get_smoke_config(arch).with_(dtype="float32"))
    params = interop.params_from_jax(refs[(arch, "float32")]["params"], "cpu")
    srv = server.shard_for_serving(tm, params, mesh)
    res["gqa_layout"] = srv.layout()
    res["gqa_local_wk"] = tuple(srv.local["layers"]["attn"]["wk"].shape)
    res["gqa_fwd"] = _np(srv.forward(torch.from_numpy(
        _tokens(tm.cfg.vocab)))[0].full_tensor())
    # the whole serve on (1, 4) with a replicated cache
    for name, ref in odd_refs.items():
        arch, over = VARIANTS[name]
        cfg = _variant(get_smoke_config(arch).with_(dtype="float32"), over)
        vm = model.build(cfg)
        vsrv = server.shard_for_serving(vm, interop.params_from_jax(
            ref["params"], "cpu"), mesh)
        res.setdefault("odd", {})[name] = dict(
            _serve_on_mesh(vsrv, ref, cfg, S_ODD), layout=vsrv.layout())
    # what raised before the sequence-sharded cache: a prefill and a cache
    # sequence-sharded over model, batch 1 and batch 3 over four data ranks
    errors = {}
    mesh4 = mesh_lib.make_tiny_mesh(4, 1)
    srv4 = server.shard_for_serving(tm, params, mesh4)
    for what, fn in (
            ("prefill", lambda: srv.prefill(torch.from_numpy(
                _tokens(tm.cfg.vocab)))),
            ("init_cache", lambda: srv.init_cache(B, 64, device="cpu")),
            ("batch_1", lambda: srv4.prefill(torch.from_numpy(
                _tokens(tm.cfg.vocab)[:1]))),
            ("batch_3", lambda: srv4.forward(torch.from_numpy(
                _tokens(tm.cfg.vocab)[:3])))):
        try:
            fn()
            errors[what] = None
        except (NotImplementedError, ValueError) as exc:
            errors[what] = str(exc)
    for multi_pod in (False, True):
        try:
            mesh_lib.make_production_mesh(multi_pod=multi_pod)
            errors[f"production_{multi_pod}"] = None
        except ValueError as exc:
            errors[f"production_{multi_pod}"] = str(exc)
    res["errors"] = errors

    res["seq"] = {(name, dims): _seq_on_mesh(name, dims)
                  for name, case in SEQ_CASES.items() for dims in case.meshes}

    # outside a hints context: no collective, the plain path
    c0 = _counts()
    res["plain_layout"] = shard_hints.layout(tm.cfg)
    res["plain_fwd"] = tm.forward(params, torch.from_numpy(
        _tokens(tm.cfg.vocab)))[0]
    res["plain_collectives"] = (_counts()[0] - c0[0], _counts()[1] - c0[1])
    return res


def _one_rank_bitwise(am, refs):
    """On a (1, 1) mesh: the sharded serve against the unsharded path on
    the same weights, compared here (bitwise)."""
    mesh = mesh_lib.make_tiny_mesh(1, 1)
    ok = {}
    for (arch, dtype), ref in refs.items():
        tm = model.build(get_smoke_config(arch).with_(dtype=dtype))
        params = interop.params_from_jax(ref["params"], "cpu")
        srv = server.shard_for_serving(tm, params, mesh)
        tokens = torch.from_numpy(_tokens(tm.cfg.vocab))
        same = [torch.equal(srv.forward(tokens)[0].to_local(),
                            tm.forward(params, tokens)[0])]
        slog, scache = srv.prefill(tokens)
        plog, pcache = tm.prefill(params, tokens)
        same.append(torch.equal(slog.to_local(), plog))
        sc, pc = interop.cache_to_numpy(scache), interop.cache_to_numpy(
            pcache)
        same.append(_same_cache(sc, pc))
        tok = torch.from_numpy(ref["toks"][:, :1])
        shape = InputShape("serve", seq_len=S + 1, global_batch=B,
                           kind="decode")
        _, slg, scache = srv.make_serve_step(shape)(scache, tok)
        _, plg, pcache = server.make_serve_step(tm, shape)(params, pcache,
                                                             tok)
        same.append(torch.equal(slg.to_local(), plg))
        same.append(_same_cache(interop.cache_to_numpy(scache),
                                interop.cache_to_numpy(pcache)))
        ok[(arch, dtype)] = same
    return ok


def _same_cache(a, b):
    return all(a[f] == b[f] if f == "pos" or a[f] is None else
               all(np.array_equal(a[f][k], b[f][k], equal_nan=True)
                   for k in a[f]) for f in a)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def refs():
    return {(a, d): _jax_serve(a, d) for a in ARCHS for d in DTYPES}


@pytest.fixture(scope="module")
def moe_refs():
    return {name: _jax_moe(cf) for name, cf in MOE_CF.items()}


@pytest.fixture(scope="module")
def odd_refs():
    return {name: _jax_serve(arch, "float32", name, S_ODD)
            for name, (arch, _) in VARIANTS.items()}


@functools.lru_cache(maxsize=None)
def _seq_refs():
    return {name: _seq_reference(name) for name in SEQ_CASES}


@pytest.fixture(scope="module")
def ranks(refs, moe_refs, odd_refs):
    """The four ranks' results; the ``SEQ_CASES`` references, which the
    ranks do not need, are computed here while they run."""
    with ThreadPoolExecutor(1) as ex:
        four = ex.submit(mesh_lib.run_local, _rank_cases, 4, refs, moe_refs,
                         odd_refs, device="cpu", timeout=600)
        try:
            _seq_refs()
        finally:
            out = four.result()
    return out


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


def _close(got, want, dtype):
    if dtype == "bfloat16":
        assert _rel(got, want) < 2e-2
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * float(np.max(np.abs(want))))


def _close_cache(got, want, dtype):
    for field, sub in want.items():
        if field == "pos":
            assert got["pos"] == sub
        elif sub is None:
            assert got[field] is None
        else:
            for k in sub:
                g, w = (np.asarray(x, np.float32) for x in (got[field][k],
                                                            sub[k]))
                assert g.shape == w.shape, (field, k)
                if np.abs(w).max() == 0:
                    assert np.abs(g).max() == 0, (field, k)
                else:
                    _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_serve_matches_jax(ranks, refs, mesh, arch, dtype):
    ref = refs[(arch, dtype)]
    for r in ranks:
        got = r["serve"][(*mesh, arch, dtype)]
        _close(got["fwd"], ref["fwd"], dtype)
        _close(got["pre"], ref["pre"], dtype)
        _close_cache(got["pre_cache"], ref["pre_cache"], dtype)
        for a, b in zip(got["steps"], ref["steps"]):
            _close(a, b, dtype)
        _close_cache(got["final"], ref["final"], dtype)
        if dtype == "float32":
            np.testing.assert_array_equal(
                np.concatenate(got["next"], 1), ref["toks"][:, 1:])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_every_rank_bitwise_the_others(ranks, mesh):
    for key in ranks[0]["serve"]:
        if key[:2] != mesh:
            continue
        r0 = ranks[0]["serve"][key]
        for r in ranks[1:]:
            got = r["serve"][key]
            for name in ("fwd", "pre"):
                assert np.array_equal(got[name], r0[name]), (key, name)
            for a, b in zip(got["steps"] + got["next"],
                            r0["steps"] + r0["next"]):
                assert np.array_equal(a, b), key
        # ranks holding the same batch shard computed the same local rows
        lay = [r["layout"][(*mesh, key[2])] for r in ranks]
        for r, lr in zip(ranks, lay):
            for q, lq in zip(ranks, lay):
                if lr.batch_rank == lq.batch_rank:
                    assert torch.equal(r["serve"][key]["fwd_local"],
                                       q["serve"][key]["fwd_local"])


def test_dtensor_tokens_match_whole_batch_tokens(ranks):
    for r in ranks:
        for mesh in MESHES:
            assert np.array_equal(
                r["dtensor_tokens"][mesh],
                r["serve"][(*mesh, "llama3.2-3b", "float32")]["fwd"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_one_all_reduce_per_row_parallel_block(ranks, mesh):
    """A forward issues one all-reduce for the vocabulary-parallel
    embedding and one per row-parallel block (``wo``, ``down``, the
    experts' combine, ``w_out``); the SSM adds its ``gate_norm``, the MoE
    its routing statistics over the batch axes (one all-reduce, one
    gather of the counts a layer); the unembedding gathers once."""
    n = get_smoke_config("llama3.2-3b").n_layers
    want = {"llama3.2-3b": (1 + 2 * n, 1),
            "granite-moe-1b-a400m": (1 + 3 * n, 1 + n),
            "mamba2-130m": (1 + 2 * n, 1)}
    for r in ranks:
        for arch in ARCHS:
            assert get_smoke_config(arch).n_layers == n
            lay = r["layout"][(*mesh, arch)]
            assert lay.vocab
            for dtype in DTYPES:
                assert r["serve"][(*mesh, arch, dtype)]["collectives"] == \
                    want[arch], (arch, dtype)


def test_layouts(ranks):
    for r in ranks:
        lay = r["layout"][(2, 2, "llama3.2-3b")]
        assert (lay.model, lay.n_batch, lay.heads, lay.kv_heads, lay.d_ff) \
            == (2, 2, True, True, True)
        lay = r["layout"][(2, 2, "granite-moe-1b-a400m")]
        assert (lay.experts, lay.moe_d_ff) == (True, False)
        lay = r["layout"][(2, 2, "mamba2-130m")]
        assert (lay.d_inner, lay.ssm_heads) == (True, True)
        assert r["layout"][(4, 1, "llama3.2-3b")].n_batch == 4


def test_mixed_gqa_forward_on_1x4(ranks, refs):
    want = refs[("llama3.2-3b", "float32")]["fwd"]
    for r in ranks:
        lay = r["gqa_layout"]
        assert (lay.heads, lay.kv_heads, lay.model) == (True, False, 4)
        assert r["gqa_local_wk"][2] == 2       # the kv heads replicated
        _close(r["gqa_fwd"], want, "float32")
        assert np.array_equal(r["gqa_fwd"], ranks[0]["gqa_fwd"])


def test_sequence_sharded_cache_and_bad_batch_raise(ranks):
    """What raised before the sequence-sharded cache runs now (its parity
    is ``test_sequence_sharded_serve_matches_jax``'s); a production mesh
    on a group of another size still raises."""
    for r in ranks:
        err = r["errors"]
        for what in ("prefill", "init_cache", "batch_1", "batch_3"):
            assert err[what] is None, (what, err[what])
        assert "needs 256 ranks, the group has 4" in err["production_False"]
        assert "needs 512 ranks" in err["production_True"]
        assert r["n_data"] == {(2, 2): 2, (4, 1): 4}


SEQ_IDS = [(name, dims) for name, case in SEQ_CASES.items()
           for dims in case.meshes]


def _seq_id(key):
    return f"{key[0]}-{key[1][0]}x{key[1][1]}"


@pytest.mark.parametrize("key", SEQ_IDS, ids=_seq_id)
def test_sequence_sharded_serve_matches_jax(ranks, key):
    """Each ``SEQ_CASES`` case against JAX's unsharded path: the prefill
    and its cache, every step's logits and greedy token (float32) and the
    final cache, every rank bitwise the others."""
    name, _ = key
    case, ref = SEQ_CASES[name], _seq_refs()[name]
    for r in ranks:
        got = r["seq"][key]
        if ref["pre"] is not None:
            _close(got["pre"], ref["pre"], case.dtype)
            _close_cache(got["pre_cache"], ref["pre_cache"], case.dtype)
        assert len(got["steps"]) == case.steps
        for a, b in zip(got["steps"], ref["steps"]):
            _close(a, b, case.dtype)
        _close_cache(got["final"], ref["final"], case.dtype)
        if case.dtype == "float32":
            np.testing.assert_array_equal(np.concatenate(got["next"], 1),
                                          np.concatenate(ref["next"], 1))
        r0 = ranks[0]["seq"][key]
        for a, b in zip(got["steps"] + got["next"], r0["steps"] + r0["next"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("key", SEQ_IDS, ids=_seq_id)
def test_sequence_sharded_slots_and_combine_collectives(ranks, key):
    """Each rank holds slots ``[r cap/n, (r+1) cap/n)`` in mesh order
    (``data`` the outer axis) and the batch's rows (all of them where the
    batch does not divide ``data``); a decode step issues the unsharded
    path's collectives (the embedding's all-reduce, one after ``wo`` and
    one after the MLP or MoE combine a layer, the unembedding's gather)
    plus, a layer, one all-reduce max and one sum a sequence axis of more
    than one rank and one gather of q where ``model`` is one; nothing
    where the cache is not sequence-sharded."""
    name, dims = key
    case = SEQ_CASES[name]
    cfg = _seq_cfg(get_smoke_config, name)
    _, cap = _seq_shape(name, InputShape)
    n = cfg.n_layers
    # cache_specs' rule: the sequence takes data where the batch does not
    # divide it, model where the kv heads do not; if the capacity divides
    sizes = dict(zip(("data", "model"), dims))
    seq = [a for a, free in (
        ("data", dims[0] == 1 or case.batch % dims[0] != 0),
        ("model", dims[1] == 1 or cfg.n_kv_heads % dims[1] != 0)) if free]
    n_seq = int(np.prod([sizes[a] for a in seq]))
    sharded = cfg.family != "ssm" and n_seq > 1 and cap % n_seq == 0
    for rank, r in enumerate(ranks):
        got = r["seq"][key]
        coord = dict(zip(("data", "model"), divmod(rank, dims[1])))
        assert got["layout"].n_batch == (
            dims[0] if case.batch % dims[0] == 0 else 1)
        if cfg.family != "ssm":
            assert got["local_kv"][1] == case.batch // got["layout"].n_batch
        axes = ()
        if not sharded:
            assert got["span"] is None
        else:
            idx = 0
            for a in seq:
                idx = idx * sizes[a] + coord[a]
            per = cap // n_seq
            axes = tuple(a for a in seq if sizes[a] > 1)
            assert got["span"] == (idx * per, (idx + 1) * per, cap, axes)
            assert got["local_kv"][2] == per
        base = (1 + 2 * n, 1)
        want = (base[0] + 2 * len(axes) * n,
                base[1] + int("model" in axes) * n)
        assert got["collectives"] == [want] * case.steps, (rank, want)


@pytest.mark.parametrize("case", sorted(MOE_CF))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_dispatch_global_and_bitwise_across_ranks(ranks, moe_refs,
                                                      mesh, case):
    ref = moe_refs[case]
    rows = [r["moe"][(*mesh, case)] for r in ranks]
    n_batch = 4 // mesh[1]
    by_shard = {}
    for row in rows:
        first = by_shard.setdefault(row["batch_rank"], row)
        assert np.array_equal(row["keep"], first["keep"])
        assert np.array_equal(row["dest"], first["dest"])
        assert np.array_equal(row["out"], rows[0]["out"])
    assert sorted(by_shard) == list(range(n_batch))
    keep = np.concatenate([by_shard[i]["keep"] for i in range(n_batch)])
    dest = np.concatenate([by_shard[i]["dest"] for i in range(n_batch)])
    np.testing.assert_array_equal(keep, ref["keep"])
    np.testing.assert_array_equal(dest, ref["dest"])
    assert (not keep.all()) == (case == "drops")
    np.testing.assert_allclose(rows[0]["out"], ref["out"], rtol=RTOL,
                               atol=1e-6)


def test_outside_hints_plain_and_no_collectives(ranks, refs):
    tm = model.build(get_smoke_config("llama3.2-3b").with_(dtype="float32"))
    params = interop.params_from_jax(refs[("llama3.2-3b", "float32")][
        "params"], "cpu")
    here = tm.forward(params, torch.from_numpy(_tokens(tm.cfg.vocab)))[0]
    for r in ranks:
        assert r["plain_layout"] is None
        assert r["plain_collectives"] == (0, 0)
        assert torch.equal(r["plain_fwd"], here)


def test_one_rank_mesh_bitwise_unsharded(refs):
    ok = mesh_lib.run_local(_one_rank_bitwise, 1, refs, device="cpu",
                            timeout=300)[0]
    assert ok == {k: [True] * 5 for k in refs}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_1x4_serve_with_a_replicated_cache_matches_jax(ranks, odd_refs,
                                                       name):
    """On (1, 4) with kv heads that 4 does not divide: each rank's q heads
    read their kv heads from a replicated cache, in prefill and decode."""
    ref = odd_refs[name]
    arch, over = VARIANTS[name]
    cfg = _variant(get_smoke_config(arch), over)
    for r in ranks:
        got = r["odd"][name]
        lay = got["layout"]
        assert (lay.model, lay.heads, lay.kv_heads) == (4, True, False)
        if cfg.moe is not None:
            assert (lay.experts, lay.moe_d_ff) == (False, True)
        assert got["local_kv"] == (cfg.n_layers, B, S_ODD + STEPS,
                                   cfg.n_kv_heads, cfg.head_dim)
        _close(got["fwd"], ref["fwd"], "float32")
        _close(got["pre"], ref["pre"], "float32")
        _close_cache(got["pre_cache"], ref["pre_cache"], "float32")
        for a, b in zip(got["steps"], ref["steps"]):
            _close(a, b, "float32")
        _close_cache(got["final"], ref["final"], "float32")
        np.testing.assert_array_equal(np.concatenate(got["next"], 1),
                                      ref["toks"][:, 1:])
        for a, b in zip(got["steps"], ranks[0]["odd"][name]["steps"]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", sorted(MOE_CF))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_cap_hint_keeps_the_shards_slots(ranks, moe_refs, mesh, case):
    """Serving's hints (``moe_cap``) run the experts over this batch
    shard's slots, at most its token count an expert; training's run the
    whole batch's capacity; both give JAX's output."""
    for r in ranks:
        serve, train = (r["moe"][(*mesh, case)],
                        r["moe"][(*mesh, case, "train")])
        assert serve["moe_cap"] and not train["moe_cap"]
        e_local = serve["buf"][0]
        assert serve["buf"][1] == min(serve["cap"], serve["tokens"])
        assert train["buf"] == (e_local, serve["cap"], serve["buf"][2])
        np.testing.assert_array_equal(train["keep"], serve["keep"])
        np.testing.assert_array_equal(train["dest"], serve["dest"])
        for got in (serve, train):
            np.testing.assert_allclose(got["out"], moe_refs[case]["out"],
                                       rtol=RTOL, atol=1e-6)


def test_hints_that_disagree_with_the_weights_raise(ranks):
    for r in ranks:
        for mesh in MESHES:
            err = r["bad_hints"][mesh]
            assert err is not None and "unlike the weights" in err, mesh
            assert "'heads'" in err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos,window", [(5, None), (21, 6)],
                         ids=["early", "ring-window"])
@pytest.mark.parametrize("n", (1, 2, 4))
def test_combine_partials_matches_attend(n, pos, window, dtype):
    """``decode_partials`` over ``n`` slot shards of a 16-slot ring,
    merged by ``combine_partials``, against ``attend`` over the whole
    cache (float32 rtol 1e-5, bf16 within 2e-2 of the max abs value).  At
    position 5 slots 6-15 are not written yet, and in the ring at 21 the
    window of 6 sees slots 0-5 only: at n = 2 and 4 some shards see no
    valid slot (their max is NEG_INF) and must add nothing."""
    from repro_torch.kernels import ref as kref
    from repro_torch.models import attention

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(41)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dt) for s in ((2, 1, 4, 16), (2, 16, 2, 16),
                                 (2, 16, 2, 16)))
    cap = 16
    q_pos = torch.tensor([pos], dtype=torch.int32)
    k_pos = attention.slot_positions(pos, 0, cap, cap)
    valid = k_pos >= 0
    want = attention.attend(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=True,
                            window=window, k_valid=valid).float().numpy()
    per = cap // n
    parts = [attention.decode_partials(
        q, k[:, i * per:(i + 1) * per], v[:, i * per:(i + 1) * per],
        q_pos=q_pos, k_pos=k_pos[i * per:(i + 1) * per], window=window,
        k_valid=valid[i * per:(i + 1) * per]) for i in range(n)]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    assert m.dtype == l.dtype == o.dtype == torch.float32
    blind = (m == kref.NEG_INF).flatten(1).all(1)
    assert bool(blind.any()) == (n > 1)
    got = attention.combine_partials(m, l, o, dt)
    assert got.dtype == dt
    _close(got.float().numpy(), want, dtype)
