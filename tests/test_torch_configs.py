"""The port's configs (``repro_torch.configs``) and input shapes
(``configs/shapes.py``) against the JAX package's, field for field; the
declared parameter counts against the plans' shapes, counted without
allocating any weight (deepseek-67b and mixtral-8x22b do not fit one card
for serving at full width and stay shape-only); every id of the JAX
package resolves; the smoke forward of the three dense configs added with
the moe family against the JAX package's (float32, max-abs error below
1e-5 of max|logits|, as ``test_torch_models.py``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import shapes as jax_shapes
from repro.models import model as jax_model
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config, shapes
from repro_torch.models import model
from repro_torch.models.param import ParamDecl

NEW_IDS = ("deepseek-67b", "internlm2-20b", "starcoder2-15b",
           "granite-moe-1b-a400m", "mixtral-8x22b", "zamba2-7b",
           "llama-3.2-vision-11b", "seamless-m4t-large-v2")


def plan_count(plan):
    """Scalars a plan declares, from its shapes alone."""
    if isinstance(plan, ParamDecl):
        return math.prod(plan.shape)
    return sum(plan_count(v) for v in plan.values())


def test_shapes_match_jax():
    assert list(shapes.SHAPES) == list(jax_shapes.SHAPES)
    for name, s in shapes.SHAPES.items():
        assert repr(s) == repr(jax_shapes.SHAPES[name])
        assert shapes.get_shape(name) is s
        assert s.tokens_per_step == jax_shapes.get_shape(name).tokens_per_step
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert repr(getattr(shapes, name)) == repr(getattr(jax_shapes, name))
    with pytest.raises(ValueError, match="unknown shape"):
        shapes.get_shape("train_8k")


@pytest.mark.parametrize("arch", NEW_IDS)
def test_new_configs_equal_jax_field_for_field(arch):
    assert arch in ARCH_IDS
    for ours, theirs in ((get_config(arch), jax_config(arch)),
                         (get_smoke_config(arch), jax_smoke_config(arch))):
        assert repr(ours) == repr(theirs)
        assert ours.param_counts() == theirs.param_counts()
        assert ours.head_dim == theirs.head_dim
        assert ours.q_per_kv == theirs.q_per_kv
    assert get_config(arch).source


def _plan_and_jax_count(arch):
    """The port's plan's scalar count, asserted equal to the JAX plan's."""
    actual = plan_count(model.build(get_config(arch)).plan)
    jm = jax_model.build(jax_config(arch))
    assert actual == sum(int(np.prod(x.shape))
                         for x in jax.tree.leaves(jm.abstract()))
    return actual


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b",
                                  "deepseek-67b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_param_counts_match_the_plan(arch):
    """``param_counts()`` within 2 % of the plan's declared shapes (as
    ``tests/test_models.py:162-175`` with ``m.abstract()``), and the plan
    the JAX package's, without allocating.  The hybrid family applies its
    shared block once a group, so its active count exceeds its stored one
    (the JAX test's exception)."""
    cfg = get_config(arch)
    actual = _plan_and_jax_count(arch)
    declared, active = cfg.param_counts()
    assert abs(actual - declared) / actual < 0.02, (actual, declared)
    assert active <= declared or cfg.family == "hybrid"


def test_vlm_plan_is_the_jax_plan():
    """llama-3.2-vision-11b's plan is the JAX package's (32 dense layers in
    8 groups and 8 cross layers: 10,110,734,336 scalars).  Its
    ``param_counts()`` counts 40 dense layers beside the 8 cross blocks,
    11,520,249,856, in both packages; the JAX package's own test does not
    hold the vlm family to it."""
    assert _plan_and_jax_count("llama-3.2-vision-11b") == 10_110_734_336
    assert get_config("llama-3.2-vision-11b").param_counts() == \
        jax_config("llama-3.2-vision-11b").param_counts()


def test_every_jax_id_resolves():
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)
    for arch in JAX_ARCH_IDS:
        assert repr(get_config(arch)) == repr(jax_config(arch))
    for fn in (get_config, get_smoke_config):
        with pytest.raises(ValueError, match="unknown arch"):
            fn("llama3.2-1b")


@pytest.mark.parametrize("arch", ["deepseek-67b", "internlm2-20b",
                                  "starcoder2-15b"])
def test_dense_smoke_forward_matches_jax(arch):
    jm = jax_model.build(jax_smoke_config(arch).with_(dtype="float32"))
    jp = jax.jit(jm.init)(jax.random.key(0))
    tm = model.build(get_smoke_config(arch).with_(dtype="float32"))
    tp = interop.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(3).integers(0, tm.cfg.vocab, (2, 16))
    want, _ = jm.forward(jp, jnp.asarray(tokens, jnp.int32))
    got, _ = tm.forward(tp, torch.from_numpy(tokens))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(want).max()
