"""The port's sharding rules, meshes and abstract shapes against the JAX
package's, with no ranks.

* ``spec_for`` / ``partition_specs`` entry for entry, for all ten configs
  under ``train_rules(True)``, ``train_rules(False)`` and ``serve_rules``,
  on fake meshes (a ``.shape`` dict, as ``tests/test_substrate.py:236``) of
  shape (1, 1), (2, 2), (1, 4), (16, 16) and (2, 16, 16);
* ``cache_specs`` for all ten configs and the four ``configs/shapes.py``
  shapes on the same meshes, and ``attn_hints`` for every config, mesh
  and kind;
* ``make_batch_specs`` on JAX's (1, 1) mesh, and its placements;
* ``abstract_params`` / ``abstract_inputs`` / ``abstract_cache`` /
  ``abstract_cache_for_shape``: JAX's shapes and dtypes (tokens int64, the
  port's index type, where JAX's are int32), every leaf on the ``meta``
  device;
* ``n_data_shards``, and ``NamedSharding.placements`` on a fake
  ``DeviceMesh``.
"""
import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_config
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.launch import mesh as jax_mesh
from repro.models import model as jax_model
from repro.models import param as jax_param
from repro.train import server as jax_server
from repro.utils import shard_hints as jax_hints
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.data import make_batch_specs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model, param
from repro_torch.train import server
from repro_torch.utils import shard_hints


class FakeMesh:
    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))


MESHES = {
    "1x1": FakeMesh((1, 1), ("data", "model")),
    "2x2": FakeMesh((2, 2), ("data", "model")),
    "1x4": FakeMesh((1, 4), ("data", "model")),
    "16x16": FakeMesh((16, 16), ("data", "model")),
    "2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model")),
}
RULES = {"train_fsdp": (param.train_rules(True), jax_param.train_rules(True)),
         "train": (param.train_rules(False), jax_param.train_rules(False)),
         "serve": (param.serve_rules(), jax_param.serve_rules())}


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict / named tuple, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif hasattr(tree, "_asdict"):
        for k, v in tree._asdict().items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, tuple) and not isinstance(tree, param.P):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _entries(spec):
    return None if spec is None else tuple(spec)


def test_arch_ids_and_rules_match_jax():
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)
    for ours, theirs in RULES.values():
        assert ours == theirs


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_specs_match_jax(arch, rules):
    ours, theirs = RULES[rules]
    tm = model.build(get_config(arch))
    jm = jax_model.build(jax_config(arch))
    for mname, mesh in MESHES.items():
        got = list(_leaves(tm.specs(ours, mesh)))
        want = list(_leaves(jm.specs(theirs, mesh)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert isinstance(g, param.P)
            assert tuple(g) == tuple(w), (mname, path, g, w)


def test_spec_for_divisibility_fallback_and_one_axis_once():
    fake = FakeMesh((4, 16), ("data", "model"))
    r = param.train_rules()
    assert param.spec_for(param.decl((64, 4096), ("d_model", "d_ff")), r,
                          fake) == param.P("data", "model")
    assert param.spec_for(param.decl((64, 100), ("d_model", "d_ff")), r,
                          fake) == param.P("data")
    # the experts take 'model', so the experts' d_ff cannot
    g = param.decl((32, 64, 512), ("experts", "d_model", "d_ff"))
    assert param.spec_for(g, param.serve_rules(), fake) == param.P("model")
    two = {"d_model": ("pod", "data")}
    pod = FakeMesh((2, 4, 16), ("pod", "data", "model"))
    assert param.spec_for(param.decl((64, 8), ("d_model", None)), two,
                          pod) == param.P(("pod", "data"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_and_attn_hints_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for mname, mesh in MESHES.items():
        for sname, shape in SHAPES.items():
            got = list(_leaves(server.cache_specs(cfg, shape, mesh)))
            want = list(_leaves(jax_server.cache_specs(
                jcfg, JAX_SHAPES[sname], mesh)))
            assert [p for p, _ in got] == [p for p, _ in want], (mname,
                                                                 sname)
            for (path, g), (_, w) in zip(got, want):
                assert _entries(g) == _entries(w), (mname, sname, path, g, w)
        for batch in (1, 2, 32, 128):
            assert server._batch_entry(mesh, batch) == \
                jax_server._batch_entry(mesh, batch)
        for kind in ("train", "prefill", "decode"):
            assert shard_hints.attn_hints(cfg, mesh, kind) == \
                jax_hints.attn_hints(jcfg, mesh, kind), (mname, kind)


def test_make_batch_specs_on_jax_mesh():
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    for arch in ("llama3.2-3b", "llama-3.2-vision-11b"):
        shape = SHAPES["train_4k"]
        got = make_batch_specs(get_config(arch), shape, jmesh)
        want = jax_model_batch_specs(arch, jmesh)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].spec) == tuple(want[k].spec), (arch, k)
    pod = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert tuple(make_batch_specs(get_config("llama3.2-3b"),
                                  SHAPES["train_4k"], pod)["tokens"].spec) \
        == (("pod", "data"), None)


def jax_model_batch_specs(arch, jmesh):
    from repro.data.pipeline import make_batch_specs as jax_batch_specs

    return jax_batch_specs(jax_config(arch), JAX_SHAPES["train_4k"], jmesh)


class _FakeDeviceMesh:
    """What ``NamedSharding.placements`` reads of a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


def test_placements():
    dm = _FakeDeviceMesh((2, 2), ("data", "model"))
    ns = param.NamedSharding(dm, param.P(None, "model"))
    assert ns.placements == (Replicate(), Shard(1))
    ns = param.NamedSharding(dm, param.P("data", None, "model"))
    assert ns.placements == (Shard(0), Shard(2))
    pod = _FakeDeviceMesh((2, 4, 4), ("pod", "data", "model"))
    ns = param.NamedSharding(pod, param.P(("pod", "data"), "model"))
    assert ns.placements == (Shard(0), Shard(0), Shard(1))
    assert param.mesh_shape(pod) == {"pod": 2, "data": 4, "model": 4}


def _jax_dtype(leaf):
    name = str(leaf.dtype)
    return "int64" if name == "int32" else name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_shapes_match_jax_and_allocate_nothing(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    tm, jm = model.build(cfg), jax_model.build(jcfg)
    got, want = list(_leaves(tm.abstract())), list(_leaves(jm.abstract()))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.is_meta, path
        assert (tuple(g.shape), str(g.dtype)[6:]) == (tuple(w.shape),
                                                      str(w.dtype)), path
    for sname, shape in SHAPES.items():
        gi = model.abstract_inputs(cfg, shape)
        wi = jax_model.abstract_inputs(jcfg, JAX_SHAPES[sname])
        assert sorted(gi) == sorted(wi)
        for k in wi:
            assert gi[k].is_meta
            assert (tuple(gi[k].shape), str(gi[k].dtype)[6:]) == (
                tuple(wi[k].shape), _jax_dtype(wi[k])), (sname, k)
        if shape.kind != "decode":
            continue
        for ours, theirs in (
                (model.abstract_cache(cfg, shape),
                 jax_model.abstract_cache(jcfg, JAX_SHAPES[sname])),
                (server.abstract_cache_for_shape(tm, shape),
                 jax_server.abstract_cache_for_shape(jm, JAX_SHAPES[sname]))):
            gc = [(p, x) for p, x in _leaves(ours) if p != ("pos",)]
            wc = [(p, x) for p, x in _leaves(theirs) if p != ("pos",)]
            assert [p for p, _ in gc] == [p for p, _ in wc]
            for (path, g), (_, w) in zip(gc, wc):
                if w is None:
                    assert g is None, (sname, path)
                    continue
                assert g.is_meta, (sname, path)
                assert (tuple(g.shape), str(g.dtype)[6:]) == (
                    tuple(w.shape), str(w.dtype)), (sname, path)
        assert server.abstract_cache_for_shape(tm, shape).pos == \
            shape.seq_len - 1


def test_n_data_shards_and_mesh_guards():
    for mesh in MESHES.values():
        assert mesh_lib.n_data_shards(mesh) == jax_mesh.n_data_shards(mesh)
    with pytest.raises(RuntimeError, match="initialised"):
        mesh_lib.make_tiny_mesh(2, 2)
    with pytest.raises(RuntimeError, match="initialised"):
        mesh_lib.make_production_mesh()


def test_outside_hints_no_layout():
    assert not shard_hints.active()
    assert shard_hints.layout(get_config("llama3.2-3b")) is None
    assert not shard_hints.has("heads")


def test_hints_context_maps_and_restores():
    """``hints`` keeps the names a caller maps (None dropped), as the JAX
    package's does, and restores the outer state on exit."""
    fake = MESHES["2x2"]
    with shard_hints.hints(fake, heads="model", q_seq=None, batch=("data",)):
        assert shard_hints.active()
        assert shard_hints.has("heads") and shard_hints.has("batch")
        assert not shard_hints.has("q_seq")
        with shard_hints.hints(fake, d_ff="model"):
            assert shard_hints.has("d_ff") and not shard_hints.has("heads")
        assert shard_hints.has("heads") and not shard_hints.has("d_ff")
    assert not shard_hints.active() and not shard_hints.has("heads")
