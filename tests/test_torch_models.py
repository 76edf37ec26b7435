"""The port's model substrate (every family, serving) against the JAX
package, at ``SMOKE_CONFIG`` of llama3.2-3b, mamba2-130m,
granite-moe-1b-a400m, mixtral-8x22b, zamba2-7b, llama-3.2-vision-11b and
seamless-m4t-large-v2 (the vlm and encdec families with a numpy-made
frontend memory).

Both packages run on the same numpy-made inputs with the JAX package's
parameters carried across by ``repro_torch.interop``.  On the CPU the port's
attention prefill runs K3's plain version and its SSM mixer K4's plain
version.  Tolerances: float32 building blocks at rtol 1e-5, with an atol of
1e-5 of the tensor's max-abs value for elements near zero (sums of O(1)
terms round differently in the two packages); float32 model outputs at a max-abs error below 1e-5 of
max|logits|, with identical greedy tokens; bfloat16 model outputs below
2e-2 of max|logits| (the JAX package's own bound, ``tests/test_models.py:103``).
The MoE family's bf16 reference is the JAX package run op by op
(``jax.disable_jit()``): its compiled scan rounds bf16 intermediates
otherwise, which can move a token's top-k choice (``test_torch_moe.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import InputShape as JaxInputShape
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.train import server as jax_server
from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import flash_attention, ssd_scan
from repro_torch.models import attention, layers, model, ssm, transformer
from repro_torch.train import server

ARCHS = ("llama3.2-3b", "mamba2-130m", "granite-moe-1b-a400m",
         "mixtral-8x22b", "zamba2-7b", "llama-3.2-vision-11b",
         "seamless-m4t-large-v2")
KV_FIELDS = ("kv", "groups_kv", "cross_self_kv")   # caches with a capacity
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    """(jax model, jax params, port model, port params) for one smoke
    config in ``dtype``."""
    jcfg = jax_smoke_config(arch).with_(dtype=dtype)
    jm = jax_model.build(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    tm = model.build(get_smoke_config(arch).with_(dtype=dtype))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _layer0(params, key):
    return jax.tree.map(lambda x: x[0], params["layers"][key]) \
        if key else jax.tree.map(lambda x: x[0], params["layers"])


def _rng_f32(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=RTOL,
                               atol=RTOL * float(np.max(np.abs(want))))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


def _f32(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_plans_match_jax(arch):
    from repro.configs import get_config as jax_config

    for full, jfull in ((get_config(arch), jax_config(arch)),
                        (get_smoke_config(arch), jax_smoke_config(arch))):
        assert repr(full) == repr(jfull)
        assert full.param_counts() == jfull.param_counts()
    jm, jp, tm, tp = _pair(arch, "float32")
    shapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)), jp)
    tshapes = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)[6:]),
                           tp)
    assert tshapes == shapes
    init = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)[6:]),
                        init) == shapes


def test_init_distributions():
    """The port's own draws follow the JAX package's distributions."""
    tm = model.build(get_smoke_config("mamba2-130m"))
    p = tm.init(torch.Generator().manual_seed(1), "cpu")["layers"]
    a = torch.exp(p["A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert torch.equal(p["D"], torch.ones_like(p["D"]))
    w = p["w_x"].float()
    assert abs(float(w.std()) - 128 ** -0.5) < 0.01
    assert p["D"].dtype == torch.float32
    assert p["w_x"].dtype == torch.bfloat16


def test_interop_round_trip_keeps_bf16_exactly():
    _, jp, _, _ = _pair("llama3.2-3b", "bfloat16")
    arrays = jax.tree.map(np.asarray, jp)
    back = interop.params_to_jax(interop.params_from_jax(arrays, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(arrays)
    for a, b in zip(jax.tree.leaves(arrays), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.astype(np.float32),
                                      b.astype(np.float32))


# ---------------------------------------------------------------------------
# building blocks, float32
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_mlp():
    jm, jp, tm, tp = _pair("llama3.2-3b", "float32")
    x = _rng_f32(1, 2, 16, 128)
    scale = {"scale": 1.0 + _rng_f32(2, 128, scale=0.1)}
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale["scale"])},
                          torch.from_numpy(x), 1e-5),
           jax_layers.rmsnorm(scale, jnp.asarray(x), 1e-5))
    q = _rng_f32(3, 2, 16, 4, 32)
    for pos in (np.arange(16), np.arange(16) + 1000):
        _close(layers.apply_rope(torch.from_numpy(q),
                                 torch.from_numpy(pos.astype(np.int32)),
                                 500000.0),
               jax_layers.apply_rope(jnp.asarray(q), jnp.asarray(pos),
                                     500000.0))
    jl = _layer0(jp, "mlp")
    tl = transformer.layer(tp["layers"], 0)["mlp"]
    _close(layers.mlp(tl, torch.from_numpy(x), 1e-5),
           jax_layers.mlp(jl, jnp.asarray(x), 1e-5))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None)])
def test_attend_both_forms(causal, window):
    q, k, v = (_rng_f32(i, 2, 24, h, 32) for i, h in ((4, 4), (5, 2), (6, 2)))
    pos = np.arange(24)
    valid = pos < 20
    kw = dict(causal=causal, window=window)
    for expand in (True, False):
        got = attention.attend(
            *(torch.from_numpy(a) for a in (q, k, v)),
            q_pos=torch.from_numpy(pos), k_pos=torch.from_numpy(pos),
            k_valid=torch.from_numpy(valid), expand_kv=expand, **kw)
        want = jax_attn.attend(
            *(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(pos),
            k_pos=jnp.asarray(pos), k_valid=jnp.asarray(valid),
            expand_kv=expand, **kw)
        _close(got, want)


@pytest.mark.parametrize("s,block_k,flash", [(64, 1024, True),
                                             (128, 64, True),
                                             (48, 32, False)])
@pytest.mark.parametrize("window", [None, 16])
def test_attend_blockwise_flash_branch_and_fallback(s, block_k, flash,
                                                     window):
    q, k, v = (_rng_f32(i, 2, s, h, 32) for i, h in ((7, 4), (8, 2), (9, 2)))
    pos = np.arange(s, dtype=np.int32)
    before = flash_attention.LAUNCHES
    got = attention.attend_blockwise(
        *(torch.from_numpy(a) for a in (q, k, v)),
        q_pos=torch.from_numpy(pos), k_pos=torch.from_numpy(pos),
        window=window, block_k=block_k)
    want = jax_attn.attend_blockwise(
        *(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(pos),
        k_pos=jnp.asarray(pos), window=window, block_k=block_k)
    _close(got, want)
    assert flash_attention.LAUNCHES == before   # the CPU runs no kernel
    assert (s % min(block_k, s) == 0) == flash


@pytest.mark.parametrize("shift,stride,window", [(20, 1, None), (0, 2, 1)])
def test_attend_blockwise_rows_that_see_no_key(shift, stride, window):
    """Queries that see no key (keys after the first 20 queries; keys on
    even positions with a window of 1) get the mean of V in both
    packages."""
    q, k, v = (_rng_f32(i, 2, 64, h, 32) for i, h in ((14, 4), (15, 2),
                                                      (16, 2)))
    q_pos = np.arange(64, dtype=np.int32)
    k_pos = (np.arange(64) * stride + shift).astype(np.int32)
    got = attention.attend_blockwise(
        *(torch.from_numpy(a) for a in (q, k, v)),
        q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
        window=window)
    want = jax_attn.attend_blockwise(
        *(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(q_pos),
        k_pos=jnp.asarray(k_pos), window=window)
    _close(got, want)
    blind = q_pos < shift if stride == 1 else q_pos % 2 == 1
    _close(got[:, blind], np.broadcast_to(
        np.repeat(v.mean(axis=1), 2, axis=1)[:, None],
        (2, int(blind.sum()), 4, 32)))


def test_decode_self_attention_ring_wrap():
    """Capacity-8 ring cache over 20 steps (it wraps twice), windowed, and
    a full cache: outputs and cache contents equal the JAX package's."""
    jm, jp, tm, tp = _pair("llama3.2-3b", "float32")
    jcfg, cfg = jm.cfg, tm.cfg
    jl = _layer0(jp, "attn")
    tl = transformer.layer(tp["layers"], 0)["attn"]
    xs = _rng_f32(10, 20, 2, 1, 128)
    for cap, window in ((8, 8), (24, None)):
        jc = jax_attn.init_cache(jcfg, 2, cap, jnp.float32)
        tc = attention.init_cache(cfg, 2, cap, torch.float32)
        jdec = jax.jit(functools.partial(jax_attn.decode_self_attention,
                                         cfg=jcfg, window=window))
        for t in range(20):
            jo, jc = jdec(jl, jnp.asarray(xs[t]), jc,
                          jnp.asarray(t, jnp.int32))
            to, tc = attention.decode_self_attention(
                tl, torch.from_numpy(xs[t]), tc, t, cfg, window=window)
            _close(to, jo)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)


@pytest.mark.parametrize("s", [64, 40])
def test_ssm_mixer_and_step(s):
    jm, jp, tm, tp = _pair("mamba2-130m", "float32")
    cfg, jcfg = tm.cfg, jm.cfg
    jl = _layer0(jp, None)
    tl = transformer.layer(tp["layers"], 0)
    x = _rng_f32(12 + s, 2, s, 128, scale=0.5)
    before = ssd_scan.LAUNCHES
    _close(ssm.ssm_mixer(tl, torch.from_numpy(x), cfg),
           jax.jit(functools.partial(jax_ssm.ssm_mixer, cfg=jcfg))(
               jl, jnp.asarray(x)))
    assert ssd_scan.LAUNCHES == before
    js = jax_ssm.init_state(jcfg, 2, jnp.float32)
    ts = ssm.init_state(cfg, 2, torch.float32)
    jstep = jax.jit(functools.partial(jax_ssm.ssm_step, cfg=jcfg))
    for t in range(8):
        jy, js = jstep(jl, jnp.asarray(x[:, t:t + 1]), js)
        ty, ts = ssm.ssm_step(tl, torch.from_numpy(x[:, t:t + 1]), ts, cfg)
        _close(ty, jy)
    for a, b in zip(ts, js):
        _close(a, b)


# ---------------------------------------------------------------------------
# the model and the serve loop
# ---------------------------------------------------------------------------

def _serve(arch, dtype, b=2, s=16, steps=8):
    """Prefill ``s`` tokens then ``steps`` greedy serve steps, in both
    packages, as examples/serve_smoke.py does.  Returns per-package
    (forward logits, prefill logits, prefill cache, step logits, tokens,
    final cache)."""
    jm, jp, tm, tp = _pair(arch, dtype)
    op_by_op = tm.cfg.family == "moe" and dtype == "bfloat16"
    with jax.disable_jit(op_by_op):
        out = {"jax": _serve_jax(jm, jp, tm.cfg.vocab, b, s, steps)}
    out["port"] = _serve_port(tm, tp, b, s, steps)
    return out


def _tokens(vocab, b, s):
    return np.random.default_rng(13).integers(0, vocab, (b, s)).astype(
        np.int32)


def _memory(cfg, b, s):
    """The vlm/encdec frontend memory (B, cross_len, d_model), float32, or
    None for the other families."""
    if not model.needs_memory(cfg):
        return None
    return _rng_f32(17, b, transformer.cross_len(cfg, s), cfg.d_model,
                    scale=0.5)


def _serve_jax(jm, jp, vocab, b, s, steps):
    tokens = _tokens(vocab, b, s)
    mem = _memory(jm.cfg, b, s)
    jmem = None if mem is None else jnp.asarray(mem)
    cap = s + steps

    jfwd, _ = jm.forward(jp, jnp.asarray(tokens), jmem)
    jlog, jcache = jm.prefill(jp, jnp.asarray(tokens), jmem)
    jpre = interop.cache_to_numpy(jax.tree.map(np.asarray, jcache))
    if jm.cfg.family in ("ssm", "hybrid"):
        full = jcache
    else:
        # the prompt's KV into a cache of ``cap`` slots
        full = jm.init_cache(b, cap, 0 if mem is None else mem.shape[1])
        full = full._replace(pos=jcache.pos, cross_kv=jcache.cross_kv, **{
            f: jax.tree.map(lambda dst, src: jax.lax.dynamic_update_slice(
                dst, src, (0,) * dst.ndim), getattr(full, f),
                getattr(jcache, f))
            for f in KV_FIELDS if getattr(jcache, f) is not None})
    step = jax.jit(jax_server.make_serve_step(
        jm, JaxInputShape("serve", seq_len=cap, global_batch=b,
                          kind="decode")))
    tok = jnp.argmax(jlog[:, -1:, :], -1).astype(jnp.int32)
    toks, logs = [np.asarray(tok)], []
    for _ in range(steps):
        tok, lg, full = step(jp, full, tok)
        toks.append(np.asarray(tok))
        logs.append(np.asarray(lg, np.float32))
    return (np.asarray(jfwd, np.float32), np.asarray(jlog, np.float32),
            jpre, logs, np.concatenate(toks, 1),
            interop.cache_to_numpy(jax.tree.map(np.asarray, full)))


def _serve_port(tm, tp, b, s, steps):
    cap = s + steps
    ttok = torch.from_numpy(_tokens(tm.cfg.vocab, b, s)).long()
    mem = _memory(tm.cfg, b, s)
    tmem = None if mem is None else torch.from_numpy(mem)
    tfwd, _ = tm.forward(tp, ttok, tmem)
    tlog, tcache = tm.prefill(tp, ttok, tmem)
    tpre = interop.cache_to_numpy(tcache)
    if tm.cfg.family in ("ssm", "hybrid"):
        tfull = tcache
    else:
        tfull = tm.init_cache(b, cap, 0 if mem is None else mem.shape[1],
                              device="cpu")
        for f in KV_FIELDS:
            src = getattr(tcache, f)
            if src is not None:
                for dst, part in zip(getattr(tfull, f), src):
                    dst[..., :s, :, :] = part
        tfull = tfull._replace(pos=tcache.pos, cross_kv=tcache.cross_kv)
    tstep = server.make_serve_step(
        tm, InputShape("serve", seq_len=cap, global_batch=b, kind="decode"))
    tok = torch.argmax(tlog[:, -1:, :], -1)
    toks, logs = [tok.numpy()], []
    for _ in range(steps):
        tok, lg, tfull = tstep(tp, tfull, tok)
        toks.append(tok.numpy())
        logs.append(_f32(lg))
    return (_f32(tfwd), _f32(tlog), tpre, logs, np.concatenate(toks, 1),
            interop.cache_to_numpy(tfull))


def _cache_rel(a, b):
    errs = [0.0]
    for field, sub in a.items():
        if field == "pos":
            assert a["pos"] == b["pos"]
        elif sub is None:
            assert b[field] is None
        else:
            for k in sub:
                assert sub[k].shape == b[field][k].shape, (field, k)
                if np.abs(b[field][k]).max() > 0:
                    errs.append(_rel(sub[k], b[field][k]))
                else:
                    assert np.abs(sub[k]).max() == 0
    return max(errs)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_serve_float32(arch):
    r = _serve(arch, "float32")
    (jf, jl, jpre, jlogs, jtoks, jfin), (tf, tl, tpre, tlogs, ttoks, tfin) = \
        r["jax"], r["port"]
    assert tf.shape == jf.shape and tl.shape == jl.shape
    assert _rel(tf, jf) < 1e-5
    assert _rel(tl, jl) < 1e-5
    assert _cache_rel(tpre, jpre) < 1e-5
    for a, b in zip(tlogs, jlogs):
        assert _rel(a, b) < 1e-5
    np.testing.assert_array_equal(ttoks, jtoks)
    assert _cache_rel(tfin, jfin) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_serve_bfloat16(arch):
    r = _serve(arch, "bfloat16")
    (jf, jl, jpre, jlogs, jtoks, _), (tf, tl, tpre, tlogs, ttoks, _) = \
        r["jax"], r["port"]
    assert _rel(tf, jf) < 2e-2
    assert _rel(tl, jl) < 2e-2
    assert _cache_rel(tpre, jpre) < 2e-2
    # greedy tokens may part at a near tie in bf16, so a step's logits are
    # compared while both packages have fed the same tokens
    for i, (a, b) in enumerate(zip(tlogs, jlogs)):
        if not np.array_equal(ttoks[:, :i + 1], jtoks[:, :i + 1]):
            break
        assert _rel(a, b) < 2e-2


def test_init_cache_for_shape_is_full_to_the_last_slot():
    """``init_cache_for_shape`` (decode_32k semantics): the cache is full up
    to ``seq_len - 1``, its K/V sized by the frontend memory's length."""
    shape = InputShape("d", seq_len=32, global_batch=2, kind="decode")
    assert server.init_cache_for_shape(
        model.build(get_smoke_config("llama3.2-3b")), shape,
        device="cpu").pos == 31
    cache = server.init_cache_for_shape(
        model.build(get_smoke_config("seamless-m4t-large-v2")), shape,
        device="cpu")
    assert cache.pos == 31 and cache.cross_kv[0].shape == (2, 2, 8, 4, 32)
