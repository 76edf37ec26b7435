"""The port's configs (``repro_torch.configs``) and input shapes
(``configs/shapes.py``) against the JAX package's, field for field; the
declared parameter counts against the plans' shapes, counted without
allocating any weight (deepseek-67b and mixtral-8x22b do not fit one card
for serving at full width and stay shape-only); the smoke forward of the
three dense configs added with the moe family against the JAX package's
(float32, max-abs error below 1e-5 of max|logits|, as
``test_torch_models.py``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import shapes as jax_shapes
from repro.models import model as jax_model
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config, shapes
from repro_torch.models import model
from repro_torch.models.param import ParamDecl

NEW_IDS = ("deepseek-67b", "internlm2-20b", "starcoder2-15b",
           "granite-moe-1b-a400m", "mixtral-8x22b")
UNPORTED = ("zamba2-7b", "llama-3.2-vision-11b", "seamless-m4t-large-v2")


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


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b",
                                  "deepseek-67b"])
def test_param_counts_match_the_plan(arch):
    """``param_counts()`` within 2 % of the plan's declared shapes (as
    ``tests/test_models.py:162-175`` with ``m.abstract()``), and the plan
    the JAX package's, without allocating."""
    cfg = get_config(arch)
    actual = plan_count(model.build(cfg).plan)
    jm = jax_model.build(jax_config(arch))
    assert actual == sum(int(np.prod(x.shape))
                         for x in jax.tree.leaves(jm.abstract()))
    declared, active = cfg.param_counts()
    assert abs(actual - declared) / actual < 0.02, (actual, declared)
    assert active <= declared


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_ids_raise(arch):
    assert arch not in ARCH_IDS
    for fn in (get_config, get_smoke_config):
        with pytest.raises(ValueError, match="ROADMAP"):
            fn(arch)


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
