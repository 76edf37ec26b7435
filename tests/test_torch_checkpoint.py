"""The port's checkpointing (``repro_torch.checkpoint``) against the JAX
package's file format (``repro.checkpoint``), on the CPU.

Every comparison is bitwise: a round trip of float32, int32 and bf16 leaves
in dicts and NamedTuples; a tree written by JAX's ``save`` read by the
port's ``restore`` and the other way round, bf16 included (its bits stored
as uint16 under the dtype name ``"bfloat16"``).  Mismatched shapes and
missing or extra keys raise, as in JAX; the save leaves no temp file.
"""
import json
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro_torch import checkpoint
from repro_torch.optim.optimizers import OptState


class Pair(NamedTuple):
    grads: dict
    age: torch.Tensor
    extra: Optional[torch.Tensor] = None


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn(3, 4, generator=g),
                   "emb": torch.randn(5, 2, generator=g).to(torch.bfloat16)},
        "opt": OptState(step=torch.tensor(7, dtype=torch.int32),
                        mu={"w": torch.randn(3, 4, generator=g)}, nu=None),
        "pair": Pair(grads={"b": torch.randn(6, generator=g)},
                     age=torch.arange(4, dtype=torch.int32)),
        "round": torch.tensor(12, dtype=torch.int64),
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}{f}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _bits(x):
    t = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
    return str(x.dtype), t.numpy().tobytes()


def test_round_trip_bitwise(tmp_path):
    tree = _tree()
    path = checkpoint.save(str(tmp_path), 3, tree)
    assert path.endswith("step_3.npz") and checkpoint.latest_step(
        str(tmp_path)) == 3
    like = _tree()
    like["params"]["w"] = torch.zeros(3, 4)
    got = checkpoint.restore(str(tmp_path), 3, like)
    assert isinstance(got["opt"], OptState) and isinstance(got["pair"], Pair)
    assert got["opt"].nu is None and got["pair"].extra is None
    want = dict(_leaves(tree))
    have = dict(_leaves(got))
    assert list(have) == list(want)
    for k in want:
        assert _bits(have[k]) == _bits(want[k]), k
    manifest = json.loads((tmp_path / "step_3.json").read_text())
    assert manifest["step"] == 3
    assert manifest["keys"] == sorted(want)
    assert manifest["dtypes"]["params/emb"] == "bfloat16"
    assert manifest["dtypes"]["opt/step"] == "int32"
    assert manifest["dtypes"]["round"] == "int64"
    assert manifest["shapes"]["pair/grads/b"] == [6]


def test_restore_casts_to_like(tmp_path):
    """Each leaf takes ``like``'s dtype (and device)."""
    checkpoint.save(str(tmp_path), 0, {"x": torch.tensor([1.5, -2.25])})
    got = checkpoint.restore(str(tmp_path), 0,
                             {"x": torch.zeros(2, dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16
    assert got["x"].tolist() == [1.5, -2.25]


def test_mismatches_raise(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"a": torch.zeros(3), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="shape mismatch for a"):
        checkpoint.restore(str(tmp_path), 1,
                           {"a": torch.zeros(4), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="missing=\\{'c'\\}"):
        checkpoint.restore(str(tmp_path), 1, {"a": torch.zeros(3),
                                               "b": torch.ones(2),
                                               "c": torch.ones(1)})
    with pytest.raises(ValueError, match="extra=\\{'b'\\}"):
        checkpoint.restore(str(tmp_path), 1, {"a": torch.zeros(3)})


def test_save_is_atomic_and_latest_step(tmp_path):
    assert checkpoint.latest_step(str(tmp_path / "absent")) is None
    for step in (2, 10, 4):
        checkpoint.save(str(tmp_path), step, {"x": torch.ones(2) * step})
    assert checkpoint.latest_step(str(tmp_path)) == 10
    names = sorted(os.listdir(tmp_path))
    assert not [n for n in names if n.endswith(".tmp")]
    assert names == sorted(f"step_{s}.{e}" for s in (2, 4, 10)
                           for e in ("json", "npz"))


def _jax_tree():
    k = jax.random.split(jax.random.key(3), 3)
    return {
        "params": {"w": jax.random.normal(k[0], (3, 4)),
                   "emb": jax.random.normal(k[1], (5, 2)).astype(
                       jnp.bfloat16)},
        "opt": {"step": jnp.asarray(7, jnp.int32),
                "mu": {"w": jax.random.normal(k[2], (3, 4))}},
        "age": jnp.arange(4, dtype=jnp.int32),
    }


def _port_like(tree):
    return jax.tree.map(lambda x: torch.zeros(
        x.shape, dtype=getattr(torch, str(x.dtype))), tree)


def test_jax_checkpoint_restored_by_port_bitwise(tmp_path):
    tree = _jax_tree()
    jax_ckpt.save(str(tmp_path), 5, tree)
    got = checkpoint.restore(str(tmp_path), checkpoint.latest_step(
        str(tmp_path)), _port_like(tree))
    for k, v in _leaves(got):
        want = _jax_leaf(tree, k)
        if v.dtype == torch.bfloat16:
            assert v.view(torch.int16).numpy().tobytes() == \
                want.view(np.int16).tobytes(), k
        else:
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)


def _jax_leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return np.asarray(tree)


def test_port_checkpoint_restored_by_jax_bitwise(tmp_path):
    tree = _jax_tree()
    port = jax.tree.map(lambda x: torch.from_numpy(
        np.array(x).view(np.int16)).view(torch.bfloat16)
        if x.dtype == jnp.bfloat16 else torch.from_numpy(np.array(x)), tree)
    checkpoint.save(str(tmp_path), 8, port)
    assert jax_ckpt.latest_step(str(tmp_path)) == 8
    like = jax.tree.map(jnp.zeros_like, tree)
    got = jax_ckpt.restore(str(tmp_path), 8, like)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(p.key) for p in path)
        have = np.asarray(_jax_leaf(got, key))
        assert have.dtype == np.asarray(leaf).dtype, key
        assert have.tobytes() == np.asarray(leaf).tobytes(), key
    assert np.asarray(got["params"]["emb"]).dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_state_crosses_packages(tmp_path, writer):
    """A trainer state (bf16 SMOKE llama, AdamW moments, steps) written by
    one package and read by the other, bitwise: the port's flat moments
    have JAX's key paths (``opt_state/mu/embed/tok``)."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import model as jax_model
    from repro.train import trainer as jax_trainer
    from repro_torch import interop
    from repro_torch.utils.tree import flatten_paths

    mj = jax_model.build(jax_smoke_config("llama3.2-3b"))
    tj = jax_trainer.TrainConfig()
    state = jax_trainer.init_state(mj, tj, jax.random.key(0))
    state = state._replace(
        opt_state=state.opt_state._replace(
            mu=jax.tree.map(lambda x: x + 0.5, state.opt_state.mu),
            step=jnp.asarray(3, jnp.int32)),
        step=jnp.asarray(3, jnp.int32))
    port = interop.train_state_from_jax(jax.tree.map(np.asarray, state),
                                        "cpu")
    if writer == "jax":
        jax_ckpt.save(str(tmp_path), 3, state)
        zero = jax.tree.map(torch.zeros_like, port)
        got = checkpoint.restore(str(tmp_path), 3, zero)
        assert int(got.step) == 3 and int(got.opt_state.step) == 3
        for a, b in ((got.params, port.params),
                     (got.opt_state.mu, port.opt_state.mu),
                     (got.opt_state.nu, port.opt_state.nu)):
            fa, fb = flatten_paths(a), flatten_paths(b)
            for k in fb:
                assert fa[k].dtype == fb[k].dtype
                assert torch.equal(fa[k], fb[k]), k
    else:
        checkpoint.save(str(tmp_path), 3, port)
        got = jax_ckpt.restore(str(tmp_path), 3,
                               jax.tree.map(jnp.zeros_like, state))
        for (pa, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(state)[0]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), pa
