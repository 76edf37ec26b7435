"""The port's roofline, wire-byte and tree helpers, its policies' entropy,
the kernel wrappers' refusal of ``meta`` tensors, and the dry-run report,
held to the JAX package where it has a counterpart.

* ``utils.roofline``: ``ota_fused_cost`` (every key) and
  ``model_flops_per_step`` equal JAX's exactly over a grid of P, N, wire
  bytes, mode and noise, and ``RooflineReport.finalize`` equals JAX's
  field for field, with JAX's module constants monkeypatched to the
  port's H100 peaks (the formulas are the same; the constants differ);
  the kernels' formulas against brute-force counts;
* ``utils.collectives.wire_bytes`` equals ``hlo._wire_bytes`` for every
  kind and group (None, 1, 2, 4, 16); ``CollectiveStats`` its totals and
  summary;
* ``utils.tree``: ``tree_size``, ``tree_bytes``, ``tree_cast``,
  ``tree_dot`` and ``tree_map_with_path_names`` equal JAX's on the same
  tree (path names letter for letter, a named tuple included),
  ``human_bytes``, ``human_flops`` and ``round_up`` on a list of values
  (``tree_bytes`` of DTensors, the local shards, in
  ``test_torch_dryrun.py``);
* ``entropy`` of ``MLPPolicy`` and ``GaussianPolicy`` equals JAX's at rtol
  1e-6 on seeded inputs carried through ``interop``;
* a ``meta`` tensor raises in each kernel wrapper (K1 .. K4);
* ``_default_microbatch`` equals JAX's for every arch, shape and n_agents
  in (1, 16, 32) (JAX's function is read from its source: importing
  ``repro.launch.dryrun`` would set the host's device count);
* ``launch.report``: ``load`` skips a malformed record with a warning and
  both tables render from two records.
"""
import ast
import collections
import json
import math
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.kernels import flash_attention, ota_channel, ota_fused, ssd_scan
from repro_torch.utils import collectives, roofline
from repro_torch.utils import tree as ttree

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_roofline(monkeypatch):
    """JAX's roofline module on the port's constants."""
    from repro.utils import roofline as jr

    monkeypatch.setattr(jr, "PEAK_FLOPS_BF16", roofline.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jr, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jr, "ICI_LINK_BW", roofline.LINK_BW)
    return jr


def test_h100_constants():
    assert roofline.PEAK_FLOPS_BF16 == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9
    assert roofline.NVLINK_BW == 450e9


@pytest.mark.parametrize("mode", ["agg", "sgd", "adam"])
@pytest.mark.parametrize("noise", [True, False])
def test_ota_fused_cost_matches_jax(jax_roofline, mode, noise):
    for p in (1, 165, 3_212_749_824, 66_958_000_128):
        for n in (1, 4, 16, 10_000):
            for wire in (2, 4):
                want = jax_roofline.ota_fused_cost(
                    p, n, wire_bytes=wire, with_noise=noise, mode=mode)
                got = roofline.ota_fused_cost(
                    p, n, wire_bytes=wire, with_noise=noise, mode=mode)
                assert got == want, (p, n, wire)


def test_model_flops_matches_jax(jax_roofline):
    for active in (0, 130_000_000, 3_212_749_824):
        for tokens in (1, 128, 1_048_576):
            for training in (True, False):
                kw = dict(n_params_active=active, tokens=tokens,
                          training=training)
                assert roofline.model_flops_per_step(**kw) \
                    == jax_roofline.model_flops_per_step(**kw)


@pytest.mark.parametrize("terms", [
    (1e15, 1e9, 1e6, 6e14), (1e9, 1e12, 1e6, 1e8), (1e9, 1e6, 1e12, 0.0),
    (0.0, 0.0, 0.0, 0.0)])
def test_roofline_report_matches_jax(jax_roofline, terms):
    flops, nbytes, coll, model = terms
    kw = dict(arch="a", shape="s", mesh="pod16x16", n_chips=256,
              hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=coll,
              model_flops=model)
    got = roofline.RooflineReport(**kw).finalize().row()
    want = jax_roofline.RooflineReport(**kw).finalize().row()
    assert got == want


def test_visible_pairs_count_the_mask():
    from repro_torch.kernels import ref

    for sq, sk in ((7, 7), (5, 9), (16, 16)):
        for causal in (True, False):
            for window in (None, 1, 3, 8):
                q = torch.arange(sk - sq, sk)
                k = torch.arange(sk)
                want = int(ref.visible(q, k, causal, window).sum())
                assert roofline.visible_pairs(
                    sq, sk, causal=causal, window=window) == want


def test_kernel_formulas():
    f, b = roofline.k1_cost(100, 3, wire_bytes=2, with_noise=True,
                            mode="agg", lanes=4, shared_stack=True,
                            map_bytes=80)
    one = roofline.ota_fused_cost(100, 3, wire_bytes=2, mode="agg")
    assert f == 4 * one["flops"]
    assert b == 4 * one["fused_bytes"] + 80 - 3 * 100 * 3 * 2
    assert roofline.k2_cost(10, 4, with_noise=True) == (270.0, 80.0)
    assert roofline.k2_cost(10, 2, with_noise=False) == (10.0, 40.0)
    f3, b3 = roofline.k3_cost(2, 4, 2, 8, 8, 16, 2, causal=True)
    assert f3 == 4 * 2 * 4 * 16 * 36
    assert b3 == 2 * 16 * (2 * 2 * 4 * 8 + 2 * 2 * 2 * 8)
    # K4: one chunk of 16 steps, one tile; tensor cores split three ways
    f4, b4 = roofline.k4_cost(1, 16, 1, 16, 1, 8, 128, 2, tensor_cores=True)
    assert f4 == 2 * 256 * 8 + 3 * (2 * 256 * 16 + 4 * 16 * 8 * 16)
    assert b4 == 2 * (16 * 16 + 2 * 16 * 8) + 4 * (16 + 1) + 4 * 16 * 16
    f4p, _ = roofline.k4_cost(1, 20, 1, 16, 1, 8, 16, 4, tensor_cores=False)
    assert f4p == 2 * (2 * 256 * 8 + 2 * 256 * 16 + 4 * 16 * 8 * 16)


KINDS = ("all-reduce", "all-gather", "all-to-all", "ragged-all-to-all",
         "collective-broadcast", "reduce-scatter", "collective-permute")


@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_match_jax(kind):
    from repro.utils import hlo

    for g in (None, 1, 2, 4, 16):
        for result in (0, 4, 1_000_003, 2 ** 34):
            assert collectives.wire_bytes(kind, result, g) \
                == hlo._wire_bytes(kind, result, g), (g, result)


def test_collective_stats_match_jax():
    from repro.utils import hlo

    got, want = collectives.CollectiveStats(), hlo.CollectiveStats()
    for kind, n in (("all-reduce", 10.0), ("all-gather", 3.5),
                    ("all-reduce", 2.0)):
        got.add(kind, n)
        want.bytes_by_kind[kind] = want.bytes_by_kind.get(kind, 0.0) + n
        want.count_by_kind[kind] = want.count_by_kind.get(kind, 0) + 1
    assert (got.total_bytes, got.total_count, got.summary()) \
        == (want.total_bytes, want.total_count, want.summary())
    assert collectives.CollectiveStats().summary() \
        == hlo.CollectiveStats().summary()


Pair = collections.namedtuple("Pair", "k v")


def _trees():
    """The same tree for both packages: nested dicts, a list and a named
    tuple, float32 and bfloat16 leaves, from a seeded numpy draw."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    arrays = {name: rng.standard_normal(shape).astype(np.float32)
              for name, shape in (("a", (3, 4)), ("b", (5,)), ("c", (2, 2)),
                                  ("d", (6,)), ("e", (1, 3)))}

    def build(to, bf16):
        return {"w": {"a": to(arrays["a"]), "b": to(arrays["b"])},
                "cache": Pair(to(arrays["c"]), [bf16(arrays["d"]),
                                                to(arrays["e"])]),
                "none": None}

    port = build(torch.from_numpy,
                 lambda x: torch.from_numpy(x).to(torch.bfloat16))
    jaxt = build(jnp.asarray, lambda x: jnp.asarray(x, jnp.bfloat16))
    return port, jaxt


def test_tree_helpers_match_jax():
    import jax

    from repro.utils import tree as jtree

    port, jaxt = _trees()
    assert ttree.tree_size(port) == jtree.tree_size(jaxt)
    assert ttree.tree_bytes(port) == jtree.tree_bytes(jaxt)
    names = []
    ttree.tree_map_with_path_names(lambda p, x: names.append(p), port)
    jnames = []
    jtree.tree_map_with_path_names(lambda p, x: jnames.append(p), jaxt)
    assert names == jnames
    shapes = ttree.tree_map_with_path_names(lambda p, x: (p, x.shape), port)
    assert shapes["cache"].k == ("cache/.k", (2, 2))
    cast = ttree.tree_leaves(ttree.tree_cast(port, torch.bfloat16))
    jcast = jax.tree.leaves(jtree.tree_cast(jaxt, jax.numpy.bfloat16))
    for a, b in zip(cast, jcast, strict=True):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    other_p, other_j = _trees()
    np.testing.assert_allclose(
        float(ttree.tree_dot(port, other_p)),
        float(jtree.tree_dot(jaxt, other_j)), rtol=1e-6)
    zeros = ttree.tree_zeros_like(port)
    assert all(not x.any() for x in ttree.tree_leaves(zeros))
    assert ttree.tree_bytes(zeros) == ttree.tree_bytes(port)


def test_tree_normal_like_draws_every_leaf():
    port, _ = _trees()
    gen = torch.Generator().manual_seed(3)
    noise = ttree.tree_normal_like(gen, port, stddev=2.0)
    leaves, base = ttree.tree_leaves(noise), ttree.tree_leaves(port)
    assert [(x.shape, x.dtype) for x in leaves] \
        == [(x.shape, x.dtype) for x in base]
    again = ttree.tree_normal_like(torch.Generator().manual_seed(3), port,
                                   stddev=2.0)
    for a, b in zip(leaves, ttree.tree_leaves(again)):
        assert torch.equal(a, b)


def test_human_units_and_round_up_match_jax():
    from repro.utils import tree as jtree

    for n in (0, 1, 999.5, 1023, 1024, 5e6, 3.2e9, 7.5e12, 2e15, 9e18,
              -4096, 1e22):
        assert ttree.human_bytes(n) == jtree.human_bytes(n)
        assert ttree.human_flops(n) == jtree.human_flops(n)
    for a in (0, 1, 7, 8, 9, 1000):
        for b in (1, 8, 128):
            assert ttree.round_up(a, b) == jtree.round_up(a, b)


def test_entropy_matches_jax():
    import jax.numpy as jnp

    from repro.rl import policy as jpol
    from repro_torch.rl import policy as tpol

    rng = np.random.default_rng(5)
    obs = rng.standard_normal((3, 7, 4)).astype(np.float32)
    jp = jpol.MLPPolicy()
    params = {"w1": rng.standard_normal((4, 16)).astype(np.float32),
              "b1": rng.standard_normal(16).astype(np.float32) * 0.1,
              "w2": rng.standard_normal((16, 5)).astype(np.float32),
              "b2": rng.standard_normal(5).astype(np.float32) * 0.1}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want = float(jp.entropy(jparams, jnp.asarray(obs)))
    got = float(tpol.MLPPolicy().entropy(
        interop.params_from_jax(jparams, "cpu"), torch.from_numpy(obs)))
    np.testing.assert_allclose(got, want, rtol=1e-6)

    gp = {"w": rng.standard_normal((2, 2)).astype(np.float32),
          "b": rng.standard_normal(2).astype(np.float32),
          "log_std": rng.standard_normal(2).astype(np.float32)}
    jgp = {k: jnp.asarray(v) for k, v in gp.items()}
    want = float(jpol.GaussianPolicy().entropy(jgp, jnp.zeros((3, 2))))
    got = float(tpol.GaussianPolicy().entropy(interop.params_from_jax(jgp, "cpu"),
                                              torch.zeros(3, 2)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: ota_fused.fused_aggregate(_meta(2, 8), _meta(2)),
    lambda: ota_fused.fused_aggregate_sgd(_meta(2, 8), _meta(2), _meta(8),
                                          alpha=0.1),
    lambda: ota_fused.fused_aggregate_adam(_meta(2, 8), _meta(2), _meta(8),
                                           _meta(8), _meta(8), alpha=0.1,
                                           step=1),
    lambda: ota_fused.fused_aggregate_lanes(_meta(2, 8), _meta(2)),
    lambda: ota_fused.fused_aggregate_sgd_lanes(_meta(2, 8), _meta(2),
                                                _meta(8), alpha=0.1),
    lambda: ota_channel.ota_channel_apply(_meta(8), sigma=0.1, n_agents=2),
    lambda: flash_attention.flash_attention(_meta(1, 2, 4, 8),
                                            _meta(1, 2, 4, 8),
                                            _meta(1, 2, 4, 8)),
    lambda: flash_attention.attend_bshd(
        _meta(1, 4, 2, 8), _meta(1, 4, 2, 8), _meta(1, 4, 2, 8),
        q_pos=torch.arange(4), k_pos=torch.arange(4)),
    lambda: ssd_scan.ssd_scan(_meta(1, 4, 2, 8), _meta(1, 4, 2), _meta(2),
                              _meta(1, 4, 1, 8), _meta(1, 4, 1, 8)),
], ids=["K1", "K1-sgd", "K1-adam", "K1-lanes", "K1-sgd-lanes", "K2",
        "K3", "K3-bshd", "K4"])
def test_meta_tensor_raises_in_each_wrapper(call):
    with pytest.raises(ValueError, match="meta"):
        call()


def _jax_default_microbatch():
    """JAX's ``_default_microbatch``, compiled from its source alone."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "_default_microbatch")
    ns = {}
    exec(compile(ast.Module([fn], []), "repro/launch/dryrun.py", "exec"), ns)
    return ns["_default_microbatch"]


def test_default_microbatch_matches_jax():
    from repro.configs import get_config as jget
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun

    jfn = _jax_default_microbatch()
    for arch in ARCH_IDS:
        for name in SHAPES:
            for n in (1, 16, 32):
                assert dryrun._default_microbatch(
                    get_config(arch), SHAPES[name], n) \
                    == jfn(jget(arch), JSHAPES[name], n), (arch, name, n)


def _record(arch, shape, mesh, dominant="memory"):
    roof = roofline.RooflineReport(
        arch=arch, shape=shape, mesh=mesh, n_chips=256, hlo_flops=1e12,
        hlo_bytes=1e12 if dominant == "memory" else 1.0,
        collective_bytes=1e3, model_flops=5e11).finalize().row()
    return {"arch": arch, "shape": shape, "mesh": mesh, "roofline": roof,
            "collectives_rolled": {"bytes_by_kind": {"all-gather": 1e6}},
            "memory": {"total": 9e10}, "t_trace_s": 1.5}


def test_report_skips_malformed_and_renders(tmp_path):
    from repro_torch.launch import report

    (tmp_path / "a.json").write_text(json.dumps(
        _record("llama3.2-3b", "train_4k", "pod16x16")))
    (tmp_path / "b.json").write_text(json.dumps(
        _record("mamba2-130m", "decode_32k", "pod2x16x16", "compute")))
    (tmp_path / "bad.json").write_text("{not json")
    (tmp_path / "partial.json").write_text(json.dumps({"arch": "x"}))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        recs = report.load(str(tmp_path))
    assert len(recs) == 2
    assert sum("skipping" in str(w.message) for w in caught) == 2
    table = report.dryrun_table(recs)
    row = next(r for r in table if r.startswith("| llama3.2-3b | train_4k "
                                                "| pod16x16 "))
    assert "traced (1.5s)" in row and "90.00 (!)" in row
    assert "all-gather:1,000,000" in row
    assert any("| mamba2-130m | decode_32k | pod2x16x16 | traced" in r
               for r in table)
    assert any("MISSING" in r for r in table)
    roof = report.roofline_table(recs)
    assert len(roof) == 3          # header, rule, the one pod16x16 record
    assert "**memory**" in roof[2] and "fused AdamW" in roof[2]
    assert math.isclose(float(roof[2].split("|")[4]), 1e12 / 3.35e12 * 1e3,
                        rel_tol=1e-3)
