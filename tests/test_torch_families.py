"""The hybrid (zamba2-7b), vlm (llama-3.2-vision-11b) and encdec
(seamless-m4t-large-v2) families of the port against the JAX package, at
their ``SMOKE_CONFIG`` (2 layers, d_model 128; zamba2 also at 5 layers, so
that its tail of mamba layers runs), in float32 on the CPU:
cross attention and the memory projection, the bidirectional encoder
through both of ``attend_blockwise``'s branches, decode against forward,
the frontend memory stub with the JAX package's projection, JAX caches
carried across by ``interop.cache_from_jax``, the trainer's unbinding of
stacked leaves (and a step's gradients freed without the garbage
collector) and the training forward's bypass of K3 and K4.  The serve
loop (forward, prefill, every cache field, decode steps) and the OTA train
step of each family are held to the JAX package in
``test_torch_models.py`` and ``test_torch_trainer.py``.

Tolerances: float32 at rtol 1e-5 with an atol of 1e-5 of the tensor's max
abs value (``test_torch_models.py``'s rule); decode against forward within
2e-2 of the max abs logit (``tests/test_models.py:57-88``); the memory
stub with the JAX projection injected, and the unbound leaves' gradients
against autograd over whole leaves, bitwise.
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models import transformer as jax_transformer
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.data import make_batch, memory_stub
from repro_torch.kernels import flash_attention, ssd_scan
from repro_torch.models import attention, model, transformer
from repro_torch.train import trainer
from repro_torch.utils.tree import flatten_paths, replace_paths

FAMILIES = ("zamba2-7b", "llama-3.2-vision-11b", "seamless-m4t-large-v2")
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _pair(arch, n_layers=None):
    """(jax model, jax params, port model, port params), float32 smoke
    config, ``n_layers`` if given."""
    extra = {} if n_layers is None else {"n_layers": n_layers}
    jm = jax_model.build(jax_smoke_config(arch).with_(dtype="float32",
                                                      **extra))
    jp = jax.jit(jm.init)(jax.random.key(0))
    tm = model.build(get_smoke_config(arch).with_(dtype="float32", **extra))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _rng(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=RTOL * float(np.max(np.abs(want))))


def _tokens(cfg, b, s, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _memory(cfg, b, s):
    if not model.needs_memory(cfg):
        return None
    return _rng(5, b, transformer.cross_len(cfg, s), cfg.d_model, scale=0.5)


def _cross_stack(params):
    """The stacked cross layers of a vlm or encdec parameter tree (either
    package's)."""
    return params["cross_layers"] if "cross_layers" in params \
        else params["layers"]


@pytest.mark.parametrize("arch", FAMILIES[1:])
@pytest.mark.parametrize("sq", [16, 1], ids=["expanded", "grouped"])
def test_cross_attention_and_memory_projection_match_jax(arch, sq):
    """``project_memory``, then ``cross_attention`` (the expanded form for
    several queries, the grouped one for one) and
    ``decode_cross_attention``."""
    jm, jp, tm, tp = _pair(arch)
    jl = jax.tree.map(lambda x: x[0], _cross_stack(jp))
    tl = transformer.layer(_cross_stack(tp), 0)
    x, mem = _rng(1, 2, sq, 128), _rng(2, 2, 12, 128)
    jkv = jax_attn.project_memory(jl["cross"], jnp.asarray(mem))
    tkv = attention.project_memory(tl["cross"], torch.from_numpy(mem))
    for a, b in zip(tkv, jkv):
        _close(a, b)
    want = jax_attn.cross_attention(jl["cross"], jnp.asarray(x), jkv, jm.cfg)
    _close(attention.cross_attention(tl["cross"], torch.from_numpy(x), tkv,
                                     tm.cfg), want)
    _close(attention.decode_cross_attention(tl["cross"], torch.from_numpy(x),
                                            tkv, tm.cfg), want)


class _Spy:
    """Counts calls of K3's wrapper and passes them on."""

    def __init__(self, monkeypatch):
        self.calls = 0
        inner = flash_attention.attend_bshd

        def spy(*args, **kwargs):
            self.calls += 1
            return inner(*args, **kwargs)

        monkeypatch.setattr(flash_attention, "attend_bshd", spy)


@pytest.mark.parametrize("frames,flash", [(10, True), (1030, False)],
                         ids=["flash-branch", "fallback"])
def test_encoder_matches_jax_in_both_branches(monkeypatch, frames, flash):
    """The bidirectional encoder, blockwise and not: 10 frames take
    ``attend_blockwise``'s flash branch (K3's wrapper, its plain version
    here; the block is ``min(1024, 10)``), 1030 its materialised fallback
    (1030 is not a multiple of 1024)."""
    jm, jp, tm, tp = _pair("seamless-m4t-large-v2")
    mem = _rng(6, 1, frames, 128, scale=0.5)
    spy = _Spy(monkeypatch)
    for blockwise in (True, False):
        spy.calls = 0
        got = transformer.encode(tp, tm.cfg, torch.from_numpy(mem),
                                 blockwise=blockwise)
        want = jax_transformer.encode(jp, jm.cfg, jnp.asarray(mem),
                                      blockwise=blockwise)
        _close(got, want)
        assert spy.calls == (tm.cfg.encoder_layers if blockwise and flash
                             else 0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """Token-by-token decode from a zeroed cache (the vlm and encdec
    families' ``cross_kv`` from ``project_memory``, as
    ``tests/test_models.py:57-88``) reproduces the full-sequence logits, in
    the config's bf16."""
    cfg = get_smoke_config(arch)
    m = model.build(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 16
    tokens = torch.from_numpy(_tokens(cfg, b, s))
    mem = _memory(cfg, b, s)
    mem = None if mem is None else torch.from_numpy(mem)
    full, _ = m.forward(params, tokens, mem)
    cache = m.init_cache(b, s, 0 if mem is None else mem.shape[1],
                         device="cpu")
    if cfg.family == "encdec":
        enc = transformer.encode(params, cfg, mem)
        ckv = [attention.project_memory(
            transformer.layer(params["layers"], i)["cross"], enc)
            for i in range(cfg.n_layers)]
    elif cfg.family == "vlm":
        ckv = [attention.project_memory(
            transformer.layer(params["cross_layers"], g)["cross"],
            mem.to(torch.bfloat16))
            for g in range(transformer.vlm_groups(cfg)[0])]
    if mem is not None:
        cache = cache._replace(cross_kv=tuple(torch.stack(t)
                                              for t in zip(*ckv)))
    outs = []
    for t in range(s):
        lg, cache = m.decode(params, cache, tokens[:, t:t + 1])
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1).float()
    err = (got - full.float()).abs().max() / full.float().abs().max()
    assert float(err) < 2e-2, float(err)


def test_hybrid_with_a_tail_matches_jax():
    """zamba2 at 5 layers (two groups of 2, the shared block applied twice,
    a tail of 1): forward, and 8 decode steps from a zeroed cache (logits
    and every cache field, ``tail_ssm`` included)."""
    jm, jp, tm, tp = _pair("zamba2-7b", 5)
    b, s = 2, 8
    tokens = _tokens(tm.cfg, b, s)
    want, _ = jm.forward(jp, jnp.asarray(tokens))
    got, _ = tm.forward(tp, torch.from_numpy(tokens))
    _close(got, want)
    jc = jm.init_cache(b, s)
    tc = tm.init_cache(b, s, device="cpu")
    assert tc.tail_ssm.ssm.shape[0] == 1
    dec = jax.jit(jm.decode)
    for t in range(s):
        jl, jc = dec(jp, jc, jnp.asarray(tokens[:, t:t + 1]))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(tokens[:, t:t + 1]))
        _close(tl, jl)
    jn = interop.cache_to_numpy(jax.tree.map(np.asarray, jc))
    for field, parts in interop.cache_to_numpy(tc).items():
        if field == "pos":
            assert parts == jn["pos"] == s
        elif parts is None:
            assert jn[field] is None, field
        else:
            for k, v in parts.items():
                _close(v, jn[field][k])


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_from_jax_carries_every_field(arch):
    """A JAX prefill's cache (the hybrid's zeroed one, at 5 layers so that
    ``tail_ssm`` is there, the model ``test_hybrid_with_a_tail_matches_jax``
    builds; the vlm's two-axis ``groups_kv``, ``cross_self_kv`` and
    ``cross_kv``; the encdec's ``kv`` and ``cross_kv``) through
    ``interop.cache_from_jax``: field for field the same arrays, and one
    decode step in both packages from it."""
    jm, jp, tm, tp = _pair(arch, 5 if arch == "zamba2-7b" else None)
    b, s = 2, 8
    tokens, mem = _tokens(tm.cfg, b, s), _memory(tm.cfg, b, s)
    jmem = None if mem is None else jnp.asarray(mem)
    _, jc = jm.prefill(jp, jnp.asarray(tokens), jmem)
    jn = jax.tree.map(np.asarray, jc)
    tc = interop.cache_from_jax(jn, "cpu")
    if mem is not None:
        assert isinstance(tc.cross_kv, tuple) and len(tc.cross_kv) == 2
    want = interop.cache_to_numpy(jn)
    for field, parts in interop.cache_to_numpy(tc).items():
        if field != "pos" and parts is not None:
            for k, v in parts.items():
                np.testing.assert_array_equal(v, want[field][k])
    assert tc.pos == want["pos"]
    if arch == "llama-3.2-vision-11b":
        assert tc.groups_kv.k.shape[:2] == (1, 1)       # (G, per - 1)
    if arch == "zamba2-7b":
        assert tc.tail_ssm.ssm.shape[0] == 1
    tok = _tokens(tm.cfg, b, 1, seed=9)
    jl, _ = jm.decode(jp, jc, jnp.asarray(tok))
    tl, _ = tm.decode(tp, tc, torch.from_numpy(tok))
    _close(tl, jl)


def test_memory_stub_matches_jax_with_its_projection():
    """``memory_stub`` with the JAX package's projection injected is the
    JAX stub bitwise (float32 and bf16; vlm 16 patches, encdec S/4
    frames); its own projection is drawn from a seeded generator, the
    same twice, N(0, 0.02^2) in distribution; ``make_batch`` adds it for
    these families only."""
    b, s = 4, 40
    for arch in FAMILIES[1:]:
        for dtype in ("float32", "bfloat16"):
            jcfg = jax_smoke_config(arch).with_(dtype=dtype)
            cfg = get_smoke_config(arch).with_(dtype=dtype)
            tokens = _tokens(cfg, b, s)
            want = jax_pipeline.memory_stub(jcfg, jnp.asarray(tokens), s)
            mem_len = transformer.cross_len(cfg, s)
            proj = np.asarray(jax.random.normal(
                jax.random.key(7), (mem_len, cfg.d_model), jnp.float32)
                * 0.02)
            got = memory_stub(cfg, torch.from_numpy(tokens), s, proj=proj)
            assert tuple(got.shape) == (b, mem_len, cfg.d_model)
            assert str(got.dtype)[6:] == dtype
            np.testing.assert_array_equal(
                interop.tensor_to_array(got).astype(np.float32),
                np.asarray(want, np.float32))
        own = [memory_stub(cfg, torch.zeros(b, s, dtype=torch.long), s)
               for _ in range(2)]
        assert torch.equal(own[0], own[1])
        assert abs(float(own[0].float().std()) - 0.02) < 0.002
    shape = InputShape("t", s, b, "train")
    batch = make_batch(get_smoke_config("seamless-m4t-large-v2"), shape, 0,
                       device="cpu")
    assert tuple(batch["memory"].shape) == (b, 10, 128)
    assert "memory" not in make_batch(get_smoke_config("zamba2-7b"), shape,
                                      0, device="cpu")


STACKED = {"zamba2-7b": ("mamba_groups", "mamba_tail"),
           "llama-3.2-vision-11b": ("plain_groups", "cross_layers"),
           "seamless-m4t-large-v2": ("enc_layers", "layers")}


@pytest.mark.parametrize("arch", FAMILIES)
def test_stacked_leaves_are_unbound_per_layer(arch):
    """The trainer's autograd leaves, read from the plan's axes: every
    stacked leaf a list of its layers (the two-axis groups a list of lists,
    group then sublayer), the shared block and the embeddings whole
    tensors; the gradients stacked back equal autograd over whole leaves
    bitwise (zamba2 at 5 layers: two groups and a tail)."""
    tm = model.build(get_smoke_config(arch).with_(
        dtype="float32", **({"n_layers": 5} if arch == "zamba2-7b" else {})))
    params = tm.init(torch.Generator().manual_seed(1), "cpu")
    batch = make_batch(tm.cfg, InputShape("t", 16, 4, "train"), 0,
                       device="cpu")
    mb = {k: v[None] for k, v in batch.items()}
    loss_fn = trainer.make_loss_fn(tm)
    flat = flatten_paths(params)
    leaves = trainer._autograd_leaves(flat, tm.plan)
    for k, v in leaves.items():
        top = k.split("/")[0]
        if top in STACKED[arch]:
            assert isinstance(v, list) and len(v) == flat[k].shape[0], k
            two = top in ("mamba_groups", "plain_groups")
            assert all(isinstance(y, list) == two for y in v), k
        else:
            assert isinstance(v, torch.Tensor), k
    assert any(k.startswith("shared/") for k in leaves) == (
        arch == "zamba2-7b")
    got = trainer._grads(loss_fn(replace_paths(params, leaves), mb, None),
                         leaves)
    whole = {k: v.detach().requires_grad_() for k, v in flat.items()}
    loss_fn(replace_paths(params, whole), mb, None).backward()
    for k, v in whole.items():
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k], v.grad), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_training_forward_takes_no_forward_only_kernel(monkeypatch, arch):
    """A train step of each family (OTA, 4 agents) reaches neither K3's nor
    K4's wrapper, the encoder's and the hybrid's shared attention
    included; the serving prefill reaches them (K3 through the encoder and
    the decoders' self attention, K4 through the hybrid's mamba layers;
    the hybrid's shared attention runs ``attend``, as JAX's prefill)."""
    calls = {"K3": 0, "K4": 0}

    def count(name, inner):
        def fn(*args, **kwargs):
            calls[name] += 1
            return inner(*args, **kwargs)
        return fn

    monkeypatch.setattr(flash_attention, "attend_bshd",
                        count("K3", flash_attention.attend_bshd))
    monkeypatch.setattr(ssd_scan, "ssd_scan", count("K4", ssd_scan.ssd_scan))
    cfg = get_smoke_config(arch).with_(dtype="float32")
    tm = model.build(cfg)
    tcfg = trainer.TrainConfig(n_agents=4, total_steps=4)
    state = trainer.init_state(tm, tcfg, device="cpu")
    batch = make_batch(cfg, InputShape("t", 16, 8, "train"), 0, device="cpu")
    _, metrics = trainer.make_train_step(tm, tcfg)(state, batch)
    assert np.isfinite(metrics["loss"].item())
    assert calls == {"K3": 0, "K4": 0}
    tm.prefill(state.params, batch["tokens"], batch.get("memory"))
    expect = {"zamba2-7b": {"K3": 0, "K4": 2},
              "llama-3.2-vision-11b": {"K3": 2, "K4": 0},
              "seamless-m4t-large-v2": {"K3": 4, "K4": 0}}[arch]
    assert calls == expect


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_leaves_no_tensor_in_a_reference_cycle(arch):
    """A train step frees its gradients when it returns: no tensor is left
    in a reference cycle, which would hold it (on the card, up to the whole
    gradient) until the garbage collector runs."""
    cfg = get_smoke_config(arch).with_(dtype="float32")
    tm = model.build(cfg)
    tcfg = trainer.TrainConfig(n_agents=4, total_steps=4)
    state = trainer.init_state(tm, tcfg, device="cpu")
    batch = make_batch(cfg, InputShape("t", 16, 8, "train"), 0, device="cpu")
    step = trainer.make_train_step(tm, tcfg)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        step(state, batch)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.garbage.clear()
        gc.set_debug(0)
        gc.enable()
    assert cyclic == []
