"""The port's MoE family (``models/moe.py`` and the moe branches of
``models/transformer.py``) against the JAX package, at ``SMOKE_CONFIG`` of
granite-moe-1b-a400m and mixtral-8x22b.

Both packages run on the same numpy-made inputs, with the JAX package's
parameters carried across by ``repro_torch.interop``.  The dispatch
integers (the routed experts ``idx``, ``keep`` and the buffer rows
``dest``) are read from the JAX function itself, which is run with a spy on
its ``jnp.where``, and must be equal, at a token count whose assignments
overflow the capacity and at one whose do not.  Tolerances:

* float32: ``moe_ffn``'s output rtol 1e-5, atol 1e-6; the gates rtol 1e-6;
  ``aux`` rtol 1e-6 (JAX adds ``1/(t*k)`` once per assignment where the port
  multiplies the count, which rounds differently);
* bfloat16: the output within 1e-2 of its max abs value (the two
  packages' ``rmsnorm`` outputs part by one bf16 ulp on a few elements,
  which the expert products carry: 2.1e-3 on these inputs), the gates
  within one bf16 ulp, ``aux`` rtol 1e-6 (its arithmetic is float32);
* decode against forward, and mixtral's ring cache against the windowed
  forward: 2e-2 of the max abs logit (``tests/test_models.py:57-70,
  120-141``, the JAX package's own bound), in bf16.  The JAX package's
  bf16 forward is run op by op (``jax.disable_jit()``) where it is the
  reference: XLA's fused scan body rounds bf16 intermediates otherwise, and
  on these inputs that alone moves one token's top-k choice in granite's
  second layer (0.26 of the max logit between the JAX package's compiled
  and op-by-op forwards), while op by op the port's forward is bitwise the
  JAX package's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.models import model, moe, transformer


def _cfgs(arch, dtype, **moe_kw):
    jc = jax_smoke_config(arch).with_(dtype=dtype)
    tc = get_smoke_config(arch).with_(dtype=dtype)
    if moe_kw:
        jc = jc.with_(moe=dataclasses.replace(jc.moe, **moe_kw))
        tc = tc.with_(moe=dataclasses.replace(tc.moe, **moe_kw))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    """The JAX package's smoke parameters (numpy) in ``dtype``."""
    jm = jax_model.build(jax_smoke_config(arch).with_(dtype=dtype))
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(0)))


def _layer0_moe(arch, dtype):
    return jax.tree.map(lambda x: x[0], _params(arch, dtype)["layers"]["moe"])


class _WhereSpy:
    """Stands in for ``jnp`` inside the JAX moe module and keeps each
    ``jnp.where``'s arguments and result: its first call in ``moe_ffn`` is
    ``dest = jnp.where(keep, flat_e * cap + rank, E * cap)``."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, *args):
        out = jnp.where(*args)
        self.calls.append((args, out))
        return out


def _jax_moe(params, x, cfg, monkeypatch):
    spy = _WhereSpy()
    with monkeypatch.context() as mp:
        mp.setattr(jax_moe, "jnp", spy)
        out, aux = jax_moe.moe_ffn(params, x, cfg)
        h = jax_moe.rmsnorm(params["norm"], x, cfg.norm_eps)
        idx, gates, aux_r = jax_moe.route(
            params, h.reshape(-1, h.shape[-1]), cfg)
    (keep, _, _), dest = spy.calls[0]
    return dict(out=out, aux=aux, idx=idx, gates=gates, aux_route=aux_r,
                keep=keep, dest=dest)


def test_plan_and_capacity_match_jax():
    for arch in ("granite-moe-1b-a400m", "mixtral-8x22b"):
        jc, tc = _cfgs(arch, "float32")
        jp, tp = jax_moe.moe_plan(jc), moe.moe_plan(tc)
        assert set(jp) == set(tp)
        for k in jp:
            if k == "norm":
                continue
            assert (tp[k].shape, tp[k].axes, tp[k].scale, tp[k].fan_in_axes,
                    tp[k].init) == (jp[k].shape, jp[k].axes, jp[k].scale,
                                    jp[k].fan_in_axes, jp[k].init), k
        for n in (1, 4, 7, 8, 33, 64, 100, 1000, 8192):
            for cf in (0.5, 1.0, 1.25, 4.0):
                c = dataclasses.replace(jc.moe, capacity_factor=cf)
                assert moe._capacity(n, tc.with_(moe=c)) == \
                    jax_moe._capacity(n, jc.with_(moe=c)), (arch, n, cf)


@pytest.mark.parametrize("drops", [True, False], ids=["drops", "no-drops"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_and_moe_ffn_match_jax(dtype, drops, monkeypatch):
    """capacity 1.0 at T = 32 (16 slots for 64 assignments over 4 experts:
    the fullest experts drop some) and 4.0 (64 slots: nothing drops)."""
    arch = "granite-moe-1b-a400m"
    jc, tc = _cfgs(arch, dtype, capacity_factor=1.0 if drops else 4.0)
    jp = _layer0_moe(arch, dtype)
    tp = interop.params_from_jax(jp, "cpu")
    x = np.random.default_rng(7).standard_normal((2, 16, 128)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(jc.dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = _jax_moe(jax.tree.map(jnp.asarray, jp), xj, jc, monkeypatch)

    h = moe.rmsnorm(tp["norm"], xt, tc.norm_eps).reshape(32, 128)
    idx, gates, aux_r = moe.route(tp, h, tc)
    cap = moe._capacity(32, tc)
    rank, keep, dest = moe.dispatch(idx, tc.moe.num_experts, cap)
    out, aux = moe.moe_ffn(tp, xt, tc)

    np.testing.assert_array_equal(idx.numpy(), np.asarray(want["idx"]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want["keep"]))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(want["dest"]))
    assert bool(keep.all()) != drops
    assert out.dtype == xt.dtype and gates.dtype == xt.dtype
    np.testing.assert_allclose(aux.item(), float(want["aux"]), rtol=1e-6)
    np.testing.assert_allclose(aux_r.item(), float(want["aux_route"]),
                               rtol=1e-6)
    got_o, want_o = out.float().numpy(), np.asarray(want["out"], np.float32)
    got_g = gates.float().numpy()
    want_g = np.asarray(want["gates"], np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got_o, want_o, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_g, want_g, rtol=1e-6)
    else:
        err = np.abs(got_o - want_o).max() / np.abs(want_o).max()
        assert err < 1e-2, err
        np.testing.assert_allclose(got_g, want_g, rtol=2 ** -7, atol=0)
    # a dropped assignment contributes nothing: the output of a token whose
    # slots all dropped is zero
    dropped = ~keep.reshape(32, -1)
    assert bool((out.reshape(32, -1)[dropped.all(1)] == 0).all())


def test_dispatch_ranks_and_dump_row():
    """Ranks count each expert's assignments in token order; the dropped
    ones go to the dump row E * cap, which the buffer cuts off."""
    idx = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 3], [0, 1]])
    rank, keep, dest = moe.dispatch(idx, 4, 3)
    np.testing.assert_array_equal(rank.numpy(), [0, 0, 1, 0, 1, 2, 3, 0, 4, 2])
    np.testing.assert_array_equal(keep.numpy(), rank.numpy() < 3)
    np.testing.assert_array_equal(
        dest.numpy(), [0, 3, 1, 6, 4, 2, 12, 9, 12, 5])


def test_router_jitter_needs_a_generator():
    _, tc = _cfgs("granite-moe-1b-a400m", "float32")
    tc = tc.with_(moe=dataclasses.replace(tc.moe, router_jitter=0.5))
    tp = interop.params_from_jax(_layer0_moe("granite-moe-1b-a400m",
                                             "float32"), "cpu")
    h = torch.randn(32, 128, generator=torch.Generator().manual_seed(0))
    a = moe.route(tp, h, tc)
    b = moe.route(tp, h, tc.with_(moe=dataclasses.replace(
        tc.moe, router_jitter=0.0)))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = moe.route(tp, h, tc, generator=torch.Generator().manual_seed(1))
    d = moe.route(tp, h, tc, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    assert not torch.equal(a[1], c[1])


def _model_pair(arch, **moe_kw):
    jc, tc = _cfgs(arch, "bfloat16", **moe_kw)
    params = _params(arch, "bfloat16")
    return (jax_model.build(jc), jax.tree.map(jnp.asarray, params),
            model.build(tc), interop.params_from_jax(params, "cpu"))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b"])
def test_decode_matches_forward(arch):
    """Token-by-token decode against the full forward with a no-drop
    capacity factor (``tests/test_models.py:57-70``): the port's decode
    against its own forward and the JAX package's."""
    jm, jp, tm, tp = _model_pair(arch, capacity_factor=4.0)
    b, s = 2, 16
    tokens = np.random.default_rng(2).integers(0, tm.cfg.vocab, (b, s))
    with jax.disable_jit():
        want, _ = jm.forward(jp, jnp.asarray(tokens, jnp.int32))
    full, aux = tm.forward(tp, torch.from_numpy(tokens))
    assert aux.dtype == torch.float32 and float(aux) > 0
    cache = tm.init_cache(b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = tm.decode(tp, cache, torch.from_numpy(tokens[:, t:t + 1]))
        outs.append(lg[:, 0].float())
    got = torch.stack(outs, 1).numpy()
    assert _rel(got, full.float().numpy()) < 2e-2
    assert _rel(got, want) < 2e-2
    assert _rel(full.float().numpy(), want) < 2e-2


def test_mixtral_ring_cache_matches_windowed_forward():
    """Ring-buffered decode with capacity == window (8) against the windowed
    forward, capacity factor 4.0 (``tests/test_models.py:120-141``)."""
    arch = "mixtral-8x22b"
    jc, tc = _cfgs(arch, "bfloat16", capacity_factor=4.0)
    jc = jc.with_(window=8, serve_window=8)
    tc = tc.with_(window=8, serve_window=8)
    jm, tm = jax_model.build(jc), model.build(tc)
    params = _params(arch, "bfloat16")
    jp = jax.tree.map(jnp.asarray, params)
    tp = interop.params_from_jax(params, "cpu")
    tokens = np.random.default_rng(4).integers(0, tc.vocab, (1, 24))
    with jax.disable_jit():
        want, _ = jm.forward(jp, jnp.asarray(tokens, jnp.int32))
    full, _ = tm.forward(tp, torch.from_numpy(tokens))
    ring = tm.init_cache(1, 8, device="cpu")
    outs = []
    for t in range(24):
        lg, ring = tm.decode(tp, ring, torch.from_numpy(tokens[:, t:t + 1]),
                             window=8)
        outs.append(lg[:, 0].float())
    got = torch.stack(outs, 1).numpy()
    assert _rel(got, full.float().numpy()) < 2e-2
    assert _rel(got, want) < 2e-2


def test_moe_forward_aux_matches_jax():
    """float32 forward of the granite smoke model: logits and the summed
    aux of both layers against the JAX package's (rtol 1e-5 and 1e-6)."""
    arch = "granite-moe-1b-a400m"
    jc, tc = _cfgs(arch, "float32")
    params = _params(arch, "float32")
    tokens = np.random.default_rng(5).integers(0, tc.vocab, (2, 24))
    want, want_aux = jax_model.build(jc).forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens, jnp.int32))
    got, aux = transformer.forward(interop.params_from_jax(params, "cpu"),
                                   tc, torch.from_numpy(tokens))
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_decode_continues_a_jax_prefill_cache():
    """The JAX package's float32 prefill cache of the granite smoke model,
    carried across by ``interop.cache_from_jax``, then one decode step in
    each package: logits rtol 1e-5 of the max, the written caches too."""
    arch = "granite-moe-1b-a400m"
    jc, tc = _cfgs(arch, "float32")
    params = _params(arch, "float32")
    jm, tm = jax_model.build(jc), model.build(tc)
    jp = jax.tree.map(jnp.asarray, params)
    tp = interop.params_from_jax(params, "cpu")
    tokens = np.random.default_rng(6).integers(0, tc.vocab, (2, 17))
    _, jcache = jm.prefill(jp, jnp.asarray(tokens[:, :16], jnp.int32))
    big = jm.init_cache(2, 24)
    big = big._replace(kv=jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice(
            dst, src, (0,) * dst.ndim), big.kv, jcache.kv), pos=jcache.pos)
    tcache = interop.cache_from_jax(jax.tree.map(np.asarray, big), "cpu")
    assert tcache.pos == 16 and tcache.kv.k.shape == (2, 2, 24, 2, 32)
    want, jnext = jm.decode(jp, big, jnp.asarray(tokens[:, 16:], jnp.int32))
    got, tnext = tm.decode(tp, tcache, torch.from_numpy(tokens[:, 16:]))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    for a, b in zip(tnext.kv, jnext.kv):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))
