"""The port's LLM trainer slice against the JAX package, on the CPU:
``models.layers.lm_loss`` / ``chunked_lm_loss``, ``transformer.loss``,
``ota.example_weights`` / ``add_awgn``, ``train.trainer`` (train steps
from ``interop.train_state_from_jax``), ``data.pipeline`` and the resume of
``launch.train``'s loop.

Tolerances:

* losses and their gradients (float32): rtol 1e-5, atol 1e-7;
* ``add_awgn`` against JAX's Pallas form in interpret mode (float32 and
  through the bf16 wire): bitwise without noise; with noise rtol 1e-6,
  atol 1e-7, as the plain uplink (``test_torch_kernels.py``): the counter
  bits are JAX's, Box-Muller's ``log``/``cos`` part by an ulp;
* ``example_weights``: exact;
* a train step of SMOKE llama in float32, from the JAX state, with JAX's
  batch and injected gains and K1 seed: ``loss``, ``grad_norm``,
  ``gain_mean`` and ``update_norm`` at rtol 1e-5; parameters at rtol 1e-5,
  atol 1e-6 on all but 5e-4 of the elements.  AdamW divides each element's
  moment by its own RMS, so where a gradient element is at the level of
  float32 rounding (a sum that cancels) its update is rounding over
  rounding, and the two packages' steps can part there by up to the
  step's ``2 * lr_t``; those elements (about 1.6e-4 of them) are held to
  that bound.  The AdamW moments ``mu`` and ``nu`` are held to JAX's at
  rtol 1e-5, atol 1e-6 on every element (they are the clipped gradient's
  moving averages, before AdamW's normalisation).  Each step starts from
  the JAX package's state, so the comparison sees one step's rounding, not
  a compounded one;
* within the port (ideal channel = exact, microbatch equivalence): the JAX
  package's own ``tests/test_trainer.py`` tolerances (1e-5 and 1e-4);
* a resumed ``launch.train`` loop: bitwise the uninterrupted one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import InputShape as JaxInputShape
from repro.core import ota as jax_ota
from repro.core.channel import RayleighChannel as JaxRayleigh
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import transformer as jax_transformer
from repro.train import trainer as jax_trainer
from repro_torch import checkpoint, interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.core import ota
from repro_torch.core.channel import RayleighChannel
from repro_torch.data import DataConfig, SyntheticLM, make_batch
from repro_torch.launch import train as launch
from repro_torch.models import layers, model, transformer
from repro_torch.train import trainer
from repro_torch.utils.tree import flatten_paths

TOL = dict(rtol=1e-5, atol=1e-7)
N_AGENTS, BATCH, SEQ = 4, 8, 16


def _rng(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_lm_loss_and_grad_match_jax(weighted):
    logits, labels = _rng(0, 2, 8, 32), np.random.default_rng(1).integers(
        0, 32, (2, 8)).astype(np.int32)
    w = _rng(2, 2) ** 2 if weighted else None
    fj = jax.value_and_grad(lambda x: jax_layers.lm_loss(
        x, labels, None if w is None else jnp.asarray(w)))
    want, gwant = fj(jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    got = layers.lm_loss(x, _t(labels).long(), None if w is None else _t(w))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gwant), **TOL)


@pytest.mark.parametrize("chunk,tie", [(4, True), (4, False), (3, True)],
                         ids=["chunked-tied", "chunked-head", "whole"])
def test_chunked_lm_loss_and_grads_match_jax(chunk, tie):
    """chunk 4 divides S = 8 (recomputed chunks); 3 does not (one pass)."""
    b, s, d, v = 2, 8, 16, 32
    emb = {"tok": _rng(3, v, d, scale=0.1)}
    if not tie:
        emb["head"] = _rng(4, d, v, scale=0.1)
    hidden, w = _rng(5, b, s, d), _rng(6, b) ** 2
    labels = np.random.default_rng(7).integers(0, v, (b, s)).astype(np.int32)

    def jf(e, h):
        return jax_layers.chunked_lm_loss(e, h, labels, tie, jnp.asarray(w),
                                          chunk=chunk)

    want, (gej, ghj) = jax.value_and_grad(jf, argnums=(0, 1))(
        {k: jnp.asarray(x) for k, x in emb.items()}, jnp.asarray(hidden))
    et = {k: _t(x).requires_grad_() for k, x in emb.items()}
    h = _t(hidden).requires_grad_()
    got = layers.chunked_lm_loss(et, h, _t(labels).long(), tie, _t(w),
                                 chunk=chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(ghj), **TOL)
    for k in emb:   # an untied head leaves "tok" unused: JAX's zeros
        g = et[k].grad if et[k].grad is not None else torch.zeros_like(et[k])
        np.testing.assert_allclose(g.numpy(), np.asarray(gej[k]), **TOL)


@functools.lru_cache(maxsize=None)
def _models(arch="llama3.2-3b"):
    cj = jax_smoke_config(arch).with_(dtype="float32")
    cp = get_smoke_config(arch).with_(dtype="float32")
    return cj, jax_model.build(cj), cp, model.build(cp)


def _jax_batch(step, seq=SEQ, arch="llama3.2-3b"):
    cj = _models(arch)[0]
    return jax_make_batch(cj, JaxInputShape("t", seq_len=seq,
                                            global_batch=BATCH, kind="train"),
                          step)


def _port_batch(b):
    """The JAX batch as the port's: int64 tokens and labels; the vlm and
    encdec families' memory as it is."""
    return {k: _t(v) if k == "memory" else _t(v).long() for k, v in b.items()}


def test_transformer_loss_matches_jax():
    """``transformer.loss``: the materialised forward and the chunked CE
    (chunk 8 of S = 16), weighted by per-sequence gains."""
    cj, mj, _, mp = _models()
    params = mj.init(jax.random.key(0))
    b = _jax_batch(0)
    w = _rng(8, BATCH) ** 2
    want = jax_transformer.loss(params, cj, b, jnp.asarray(w), loss_chunk=8)
    got = transformer.loss(
        interop.params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
        mp.cfg, _port_batch(b), _t(w), loss_chunk=8)
    np.testing.assert_allclose(got.item(), float(want), **TOL)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-130m"])
def test_moe_and_ssm_loss_and_grads_match_jax(arch):
    """``transformer.loss`` (CE + the moe aux, weighted by per-sequence
    gains) at ``TOL`` and its gradient in every parameter at rtol 1e-5 with
    an atol of 1e-5 of the leaf's max abs gradient, for elements that are
    float32 sums which cancel (``test_torch_models.py``'s rule; mamba2's
    ``A_log`` needs 7.3e-6, llama3.2-3b's leaves 9.3e-7)."""
    cj, mj, _, mp = _models(arch)
    params = mj.init(jax.random.key(0))
    b = _jax_batch(0, arch=arch)
    w = _rng(8, BATCH) ** 2
    want, gwant = jax.value_and_grad(
        lambda p: jax_transformer.loss(p, cj, b, jnp.asarray(w),
                                       loss_chunk=8))(params)
    leaves = {k: v.requires_grad_() for k, v in _flat(params).items()}
    from repro_torch.utils.tree import replace_paths

    tree = replace_paths(interop.params_from_jax(
        jax.tree.map(np.asarray, params), "cpu"), leaves)
    got = transformer.loss(tree, mp.cfg, _port_batch(b), _t(w), loss_chunk=8)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for k, g in _flat(gwant).items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(leaves[k].grad.numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=k)


def test_ssm_plain_scan_gradients_at_full_width(monkeypatch):
    """At mamba2-130m's width (d_model 768, 24 heads, N 128) and S = 256 the
    chunked scan's above-diagonal decay exponent overflows float32; the
    plain scan masks it before the exp, so its gradient is finite and
    within rtol 1e-4 (atol 1e-4 of the leaf's max) of autograd through the
    sequential recurrence ``ref.ssd_sequential_ref``, the definition.  (The
    JAX package's ``ssd_ref`` exponentiates first; its ``jax.grad`` of
    mamba2-130m's loss at this width and length is not finite.)"""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import ssm
    from repro_torch.models.param import init_params

    cfg = get_config("mamba2-130m").with_(dtype="float32")
    lp = init_params(ssm.ssm_plan(cfg), "float32",
                     generator=torch.Generator().manual_seed(0), device="cpu")
    x = _t(_rng(21, 1, 256, cfg.d_model))
    r = _t(_rng(22, 1, 256, cfg.d_model))

    def grads():
        leaves = {k: v.detach().requires_grad_()
                  for k, v in flatten_paths(lp).items()}
        from repro_torch.utils.tree import replace_paths

        y = ssm.ssm_mixer(replace_paths(lp, leaves), x, cfg, plain_scan=True)
        (y * r).sum().backward()
        return {k: v.grad for k, v in leaves.items()}

    got = grads()
    with monkeypatch.context() as mp:
        mp.setattr(ref, "ssd_ref", lambda x, dt, A, B, C, chunk:
                   ref.ssd_sequential_ref(x, dt, A, B, C))
        want = grads()
    for k, g in want.items():
        assert bool(torch.isfinite(got[k]).all()), k
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()),
                                   err_msg=k)


def test_training_forward_takes_no_forward_only_kernel(monkeypatch):
    """The trainers' forward (``differentiable=True``) reaches neither K3's
    nor K4's wrapper, so it runs the same on the card; a blockwise
    (K3) differentiable forward is refused."""
    from repro_torch.kernels import flash_attention, ssd_scan

    def refuse(*args, **kwargs):
        raise AssertionError("a forward-only kernel's wrapper was called")

    monkeypatch.setattr(ssd_scan, "ssd_scan", refuse)
    monkeypatch.setattr(flash_attention, "attend_bshd", refuse)
    for arch in ("mamba2-130m", "granite-moe-1b-a400m"):
        _, _, cp, mp = _models(arch)
        batch = make_batch(cp, InputShape("t", SEQ, BATCH, "train"), 0,
                           device="cpu")
        state = trainer.init_state(mp, trainer.TrainConfig(
            n_agents=N_AGENTS, total_steps=4), device="cpu")
        _, m = trainer.make_train_step(mp, trainer.TrainConfig(
            n_agents=N_AGENTS, total_steps=4))(state, batch)
        assert np.isfinite(m["loss"].item())
        with pytest.raises(AssertionError, match="forward-only"):
            # the serving forward: K3 (blockwise) or K4
            transformer.forward(state.params, cp, batch["tokens"],
                                blockwise=cp.family != "ssm")
        with pytest.raises(ValueError, match="no backward"):
            transformer.forward(state.params, cp, batch["tokens"],
                                blockwise=True, differentiable=True)


# --------------------------------------------------------------------------
# the uplink of the channel-weighted loss
# --------------------------------------------------------------------------

def test_example_weights_exact():
    h = _rng(9, 4)
    want = jax_ota.example_weights(jnp.asarray(h), 12)
    np.testing.assert_array_equal(
        ota.example_weights(_t(h), 12).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="divisible"):
        ota.example_weights(_t(h), 10)


@pytest.mark.parametrize("sigma", [0.0, 0.3], ids=["quiet", "noisy"])
@pytest.mark.parametrize("kind", ["debias", "plain", "update_scale", "wire"])
def test_add_awgn_matches_jax_pallas(kind, sigma):
    """A nested float32 tree (the JAX package's leaf order) through the
    port's ``add_awgn`` (K1's plain version on the CPU) and JAX's
    ``add_awgn(backend="pallas")`` in interpret mode, the seed JAX's
    ``_kernel_seed`` of the same key.  Without noise: bitwise.  With noise:
    the counter bits are bitwise JAX's (``test_torch_kernels.py``), but
    torch's CPU ``log``/``cos`` and XLA's part by up to an ulp in
    Box-Muller, so the tolerance of ``test_plain_uplink_matches_jax_kernel``
    holds: rtol 1e-6, atol 1e-7."""
    tree = {"b": {"z": _rng(10, 3, 5), "a": _rng(11, 7)}, "a": _rng(12, 4, 2)}
    kw = dict(noise_sigma=sigma, debias=kind != "plain")
    if kind == "update_scale":
        kw["update_scale"] = 0.0625
    if kind == "wire":
        kw["wire_dtype"] = "bfloat16"
    cj = jax_ota.OTAConfig(JaxRayleigh(), **kw)
    cp = ota.OTAConfig(RayleighChannel(), **kw)
    key = jax.random.key(4)
    want = jax_ota.add_awgn(cj, key, jax.tree.map(jnp.asarray, tree),
                            N_AGENTS, backend="pallas")
    seed = int(jax_ota._kernel_seed(key))
    got = flatten_paths(ota.add_awgn(
        cp, seed, interop.params_from_jax(tree, "cpu"), N_AGENTS,
        backend="torch"))
    assert list(got) == ["a", "b/a", "b/z"]
    for k, v in flatten_paths(interop.params_from_jax(
            jax.tree.map(np.asarray, want), "cpu")).items():
        if sigma == 0.0:
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_add_awgn_backend_rules():
    cp = ota.OTAConfig(RayleighChannel(), noise_sigma=0.1, debias=True)
    g = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="CUDA tensors"):
        ota.add_awgn(cp, 0, g, 2, backend="cuda")
    out = ota.add_awgn(cp, 0, g, 2, backend="auto")
    np.testing.assert_array_equal(
        out["w"].numpy(), ota.add_awgn(cp, 0, g, 2, backend="torch")[
            "w"].numpy())


# --------------------------------------------------------------------------
# train steps against JAX
# --------------------------------------------------------------------------

def _tcfgs(aggregator, microbatch, **extra):
    kw = dict(aggregator=aggregator, n_agents=N_AGENTS, microbatch=microbatch,
              total_steps=10, lr=1e-2, warmup=2, **extra)
    return (jax_trainer.TrainConfig(ota_backend="pallas", **kw),
            trainer.TrainConfig(ota_backend="torch", **kw))


def _flat(params):
    return flatten_paths(interop.params_from_jax(
        jax.tree.map(np.asarray, params), "cpu"))


@pytest.mark.parametrize("aggregator,microbatch",
                         [("exact", 1), ("exact", 2), ("ota", 1), ("ota", 2)])
def test_train_steps_match_jax(aggregator, microbatch):
    _check_train_steps("llama3.2-3b", aggregator, microbatch)


@pytest.mark.parametrize("arch,aggregator,microbatch",
                         [("granite-moe-1b-a400m", "ota", 1),
                          ("granite-moe-1b-a400m", "exact", 2),
                          ("mamba2-130m", "ota", 1),
                          ("mamba2-130m", "exact", 2)])
def test_moe_and_ssm_train_steps_match_jax(arch, aggregator, microbatch):
    """The moe family (the aux loss in the gradient; the MoE capacity of
    one forward over a microbatch's every agent) and the ssm family
    (trained through the plain scan) at ``test_train_steps_match_jax``'s
    tolerances."""
    _check_train_steps(arch, aggregator, microbatch)


@pytest.mark.parametrize("arch,microbatch",
                         [("zamba2-7b", 1), ("llama-3.2-vision-11b", 1),
                          ("seamless-m4t-large-v2", 2)])
def test_hybrid_vlm_encdec_train_steps_match_jax(arch, microbatch):
    """OTA steps of the hybrid family (the shared block's gradient summed
    over its groups; the mamba layers through the plain scan), the vlm
    family (cross attention over the JAX batch's memory stub) and the
    encdec family (the bidirectional encoder through ``attend``; its
    memory split into microbatches with the tokens) at
    ``test_train_steps_match_jax``'s tolerances."""
    _check_train_steps(arch, "ota", microbatch)


def _check_train_steps(arch, aggregator, microbatch):
    _, mj, _, mp = _models(arch)
    tj, tp = _tcfgs(aggregator, microbatch)
    state = jax_trainer.init_state(mj, tj, jax.random.key(1))
    step_j = jax.jit(jax_trainer.make_train_step(mj, tj))
    step_p = trainer.make_train_step(mp, tp)
    key = jax.random.key(0)
    for i in range(2):
        start = interop.train_state_from_jax(jax.tree.map(np.asarray, state),
                                             "cpu")
        b = _jax_batch(i, arch=arch)
        draws = None
        if aggregator == "ota":
            kh, kn = jax.random.split(jax.random.fold_in(key, state.step))
            draws = (_t(jax_ota.sample_gains(tj.ota_config(), kh, N_AGENTS)),
                     int(jax_ota._kernel_seed(kn)))
        state, mj_ = step_j(state, b, key)
        got, mp_ = step_p(start, _port_batch(b), draws)
        assert int(got.step) == int(state.step) == i + 1
        for k in ("loss", "grad_norm", "gain_mean", "update_norm"):
            np.testing.assert_allclose(mp_[k].item(), float(mj_[k]),
                                       rtol=1e-5, err_msg=k)
        lr_t = _lr(tp, i + 1)
        want, have = _flat(state.params), flatten_paths(got.params)
        n_out = n_all = 0
        for k, w in want.items():
            diff = (have[k] - w).abs()
            out = diff > 1e-6 + 1e-5 * w.abs()
            n_out += int(out.sum())
            n_all += w.numel()
            assert float(diff.max()) <= 2 * lr_t * 1.01 + 1e-6, k
        assert n_out <= 5e-4 * n_all, (n_out, n_all)
        for name in ("mu", "nu"):
            mom = flatten_paths(interop.params_from_jax(jax.tree.map(
                np.asarray, getattr(state.opt_state, name)), "cpu"))
            have = getattr(got.opt_state, name)
            assert set(mom) == set(have)
            for k, w in mom.items():
                np.testing.assert_allclose(have[k].numpy(), w.numpy(),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name}/{k}")
        assert int(got.opt_state.step) == int(state.opt_state.step)


def _lr(tcfg, step):
    from repro_torch.optim.optimizers import warmup_cosine

    return warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.total_steps)(
        torch.tensor(step, dtype=torch.int32)).item()


def _port_step(tcfg, step=0, seq=32):
    _, _, _, mp = _models()
    state = trainer.init_state(mp, tcfg, device="cpu")
    batch = make_batch(mp.cfg, InputShape("t", seq, BATCH, "train"), step,
                       device="cpu")
    return trainer.make_train_step(mp, tcfg)(state, batch)


def test_ota_ideal_channel_equals_exact():
    """aggregator "ota" with a unit fixed gain and no noise is the exact
    step (``tests/test_trainer.py:28``; its tolerances)."""
    base = dict(n_agents=N_AGENTS, microbatch=2, total_steps=10, lr=1e-2)
    s1, m1 = _port_step(trainer.TrainConfig(aggregator="exact", **base))
    s2, m2 = _port_step(trainer.TrainConfig(
        aggregator="ota", channel="fixed", channel_kwargs=(("gain", 1.0),),
        noise_db=-1000.0, debias=False, **base))
    a, b = flatten_paths(s1.params), flatten_paths(s2.params)
    diff = torch.sqrt(sum(torch.sum((a[k] - b[k]) ** 2) for k in a))
    assert float(diff) < 1e-5
    assert m1["loss"].item() == pytest.approx(m2["loss"].item(), rel=1e-5)


def test_microbatch_equivalence():
    """microbatch 1 and 2 give the same step (exact aggregator,
    ``tests/test_trainer.py:48``'s 1e-4 relative)."""
    outs = [flatten_paths(_port_step(trainer.TrainConfig(
        aggregator="exact", n_agents=N_AGENTS, microbatch=mb, total_steps=10,
        lr=1e-2), step=1)[0].params) for mb in (1, 2)]
    num = torch.sqrt(sum(torch.sum((outs[0][k] - outs[1][k]) ** 2)
                         for k in outs[0]))
    den = torch.sqrt(sum(torch.sum(outs[0][k] ** 2) for k in outs[0]))
    assert float(num / den) < 1e-4


def test_agent_major_layout():
    out = trainer._agent_major({"x": torch.arange(8)}, n_agents=2,
                               n_micro=2)
    np.testing.assert_array_equal(out["x"].numpy(),
                                  [[[0, 1], [4, 5]], [[2, 3], [6, 7]]])


def test_train_step_writes_into_its_state():
    """The step consumes its state: the returned parameters and moments
    are the old state's tensors, holding the new values."""
    tcfg = trainer.TrainConfig(aggregator="ota", n_agents=N_AGENTS,
                               total_steps=10, lr=1e-2)
    _, _, _, mp = _models()
    batch = make_batch(mp.cfg, InputShape("t", SEQ, BATCH, "train"), 0,
                       device="cpu")
    state = trainer.init_state(mp, tcfg, device="cpu")
    before = {k: v.clone() for k, v in flatten_paths(state.params).items()}
    old = (flatten_paths(state.params), state.opt_state.mu,
           state.opt_state.nu)
    new, _ = trainer.make_train_step(mp, tcfg)(state, batch)
    for a, b in zip(old, (flatten_paths(new.params), new.opt_state.mu,
                          new.opt_state.nu)):
        assert set(a) == set(b) and all(a[k] is b[k] for k in a)
    assert any(not torch.equal(before[k], v) for k, v in old[0].items())
    assert int(new.step) == 1


def test_unported_families_and_backends_raise():
    """Every family trains (the hybrid one from an empty plan here, so the
    step is built without a weight); an uplink backend the port has not
    (JAX's ``"pallas"``) raises."""
    hybrid = get_smoke_config("zamba2-7b")
    trainer.make_loss_fn(model.Model(cfg=hybrid, plan={}))
    with pytest.raises(ValueError, match="unknown backend"):
        trainer.TrainConfig(ota_backend="pallas")


# --------------------------------------------------------------------------
# the launcher's loop and the data
# --------------------------------------------------------------------------

def test_launch_loop_resume_bitwise(tmp_path):
    """4 straight steps against 2, a checkpoint, a fresh restore and 2 more
    (``launch.train.train``): params, moments and steps bitwise."""
    cfg = _models()[2]
    tcfg = trainer.TrainConfig(aggregator="ota", n_agents=N_AGENTS,
                               total_steps=4, lr=1e-2, warmup=2)
    shape = InputShape("t", SEQ, BATCH, "train")
    kw = dict(device="cpu", verbose=False, log_every=1)
    straight, _ = launch.train(cfg, tcfg, shape, steps=4, **kw)
    launch.train(cfg, tcfg, shape, steps=2, ckpt_dir=str(tmp_path), **kw)
    assert checkpoint.latest_step(str(tmp_path)) == 2
    resumed, hist = launch.train(cfg, tcfg, shape, steps=4,
                                 ckpt_dir=str(tmp_path), **kw)
    assert [h["step"] for h in hist] == [2, 3]
    assert int(resumed.step) == int(straight.step) == 4
    for tree_a, tree_b in ((straight.params, resumed.params),
                           (straight.opt_state.mu, resumed.opt_state.mu),
                           (straight.opt_state.nu, resumed.opt_state.nu)):
        a, b = flatten_paths(tree_a), flatten_paths(tree_b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(straight.opt_state.step, resumed.opt_state.step)


def test_synthetic_lm_deterministic_and_shifted():
    """Per-step determinism, and with JAX's transition table: tokens in
    the active sub-vocabulary, labels the tokens shifted by one."""
    jcfg = JaxDataConfig(vocab=512, seq_len=24, global_batch=4, seed=3)
    table = np.asarray(JaxSyntheticLM(jcfg).trans_logits)
    ds = SyntheticLM(DataConfig(vocab=512, seq_len=24, global_batch=4,
                                seed=3), "cpu", trans_logits=table)
    a, b, c = ds.batch(5), ds.batch(5), ds.batch(6)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (4, 24)
    assert int(a["tokens"].min()) >= 0
    assert int(a["tokens"].max()) < table.shape[-1]
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    with pytest.raises(ValueError, match="trans_logits"):
        SyntheticLM(DataConfig(vocab=512, seq_len=8, global_batch=2), "cpu",
                    trans_logits=table[:, :10])


# --------------------------------------------------------------------------
# K1 at the trainer's row: d past 2^31
# --------------------------------------------------------------------------

LLAMA_D = 3_212_749_824     # llama3.2-3b's parameter count


@pytest.mark.parametrize("start", [0, 2 ** 20 + 3, 2 ** 31, 2 ** 32 - 4096])
def test_counter_window_is_the_slice_and_jax_stream(start):
    """``ref.counter_noise(..., start=)``: a window of the stream keyed on
    the absolute index is the same slice of a longer stream, its bits are
    JAX's ``_counter_noise`` counter at ``start`` bitwise, its normals
    JAX's within rtol 1e-6 (Box-Muller's ``log``/``cos``)."""
    from repro.kernels import ota_fused as jax_fused

    from repro_torch.kernels import ref

    n, seed = 4096, 123456789
    lo = max(start - 100, 0)
    whole = ref.counter_noise(seed, start - lo + n, start=lo)
    win = ref.counter_noise(seed, n, start=start)
    np.testing.assert_array_equal(win.numpy(), whole[start - lo:].numpy())
    counter = jnp.uint32(start) + jnp.arange(n, dtype=jnp.uint32)
    base = jax_fused._mix(counter, jnp.uint32(seed) * jnp.uint32(0x9E3779B9))
    b1, b2 = ref.counter_bits(seed, n, start=start)
    np.testing.assert_array_equal(
        b1.numpy(), np.asarray(jax_fused._mix(base, jnp.uint32(0xA511E9B3))
                               >> 8, np.int64))
    np.testing.assert_array_equal(
        b2.numpy(), np.asarray(jax_fused._mix(base, jnp.uint32(0x63D83595))
                               >> 8, np.int64))
    want = jax_fused._counter_noise(jnp.uint32(seed), jnp.uint32(start),
                                    (n,))
    np.testing.assert_allclose(win.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="2\\^32"):
        ref.counter_bits(seed, n, start=2 ** 32 - n + 1)


def test_k1_dispatch_at_llama_width():
    """The trainer's ``(1, d)`` row at llama3.2-3b's d (shapes only): the
    rule picks the wide body, whose index is 64-bit; forcing the tall body
    (an ``int`` index) is refused, not narrowed."""
    from repro_torch.kernels import ota_fused

    assert LLAMA_D > 2 ** 31
    for wire in (torch.float32, torch.bfloat16):
        assert ota_fused.k1_body(1, LLAMA_D, wire, data_ptr=0) == "wide"
        ota_fused.check_body("wide", 1, LLAMA_D, wire)
        with pytest.raises(ValueError, match="2\\^31"):
            ota_fused.check_body("tall", 1, LLAMA_D, wire)
    # a tall-shaped fleet at P >= 2^31 still goes wide
    assert ota_fused.k1_body(10 ** 9, 2 ** 31, torch.float32) == "wide"
