"""The port's agent-mesh forms against the JAX package's mesh forms.

The JAX side runs its ``shard_map`` forms on 4 CPU devices (2 for the
train step).  A JAX process fixes its device count when it starts, and
pytest's processes see one device unless ``REPRO_EMULATED_DEVICES`` is
set, so the JAX references come from one child process started with
``--xla_force_host_platform_device_count=8`` (:func:`main`); the port's
side runs on four spawned ``gloo`` ranks fed those references
(``test_torch_agent_mesh.parity_cases``, JAX-free).  Noise is off
throughout: JAX's axis forms draw their AWGN from threefry, which torch
cannot replay (the port's noisy mesh form is held to its own run off the
mesh, whose noise is K1's counter stream, in ``test_torch_agent_mesh.py``).

* ``fedpg`` rounds through ``make_round_fn(agent_mesh=)`` (N=8 stacked, the
  exact uplink, N=10 streamed in blocks of 2 with a phantom-padded last
  shard), K=4 chained rounds with ``RoundDraws`` replaying JAX's initial
  states, actions and ``fold_in`` gains (``_psum_axis_stacked``'s
  stream), Rayleigh with debias: metrics and theta_K at rtol 1e-5, atol
  1e-6, the stacked round's parity tolerance (``test_torch_fedpg.py``);
* ``ota.aggregate``'s axis and axis-stacked forms (unblocked, blocked with
  phantoms, exact, ``FixedGainChannel`` 1.3 with debias) at rtol 1e-6,
  atol 1e-7: one float32 reassociation of a 12-row sum;
* ``make_psum_train_step`` at SMOKE llama (float32) over 2 ranks, two
  steps each from JAX's state with JAX's batch and its per-shard gains:
  ``loss`` and ``grad_norm`` at rtol 1e-5, the parameters by
  ``test_torch_trainer.py``'s rule (:func:`params_close`).  Under jax
  0.9.0 the JAX package's ``make_psum_train_step`` does not run as
  written (its per-shard scalar loss has the out spec ``P("data")``); the
  reference runs it with ``shard_map`` patched to lift that loss to shape
  (1,), nothing else changed;
* ``agent_mesh_for``'s rule against JAX's.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import distribute
from repro_torch.launch import mesh as mesh_lib
from test_torch_agent_mesh import (
    PARITY_ROUNDS, RANKS, SEED, SMALL, params_close, parity_cases,
)

HERE = Path(__file__).resolve().parent
TOL = dict(rtol=1e-5, atol=1e-6)
AGG_TOL = dict(rtol=1e-6, atol=1e-7)
PSUM = dict(aggregator="ota", channel="rayleigh", noise_db=-1000.0,
            debias=True, n_agents=2, lr=1e-2, warmup=2, total_steps=10)
AGG_CASES = {  # name: (channel or None for exact, N, agent_blocks)
    "noisy": ("fixed", 12, None),
    "blocks": ("fixed", 10, 2),
    "exact": (None, 12, None),
    "exact_blocks": (None, 10, 2),
    "axis": ("fixed", None, None),
    "axis_exact": (None, None, None),
}


# ---------------------------------------------------------------------------
# The JAX side, in a child process with 8 emulated devices
# ---------------------------------------------------------------------------

def _jax_rounds(name):
    import jax
    import jax.numpy as jnp

    from repro.core import fedpg as jax_fedpg
    from repro.core import ota as jax_ota
    from repro.core.channel import RayleighChannel as JaxRayleigh
    from repro.launch.mesh import make_agent_mesh
    from repro.rl import sampler as jax_sampler
    from repro.rl.env import LandmarkNav as JaxLandmarkNav
    from repro.rl.policy import MLPPolicy as JaxMLPPolicy

    n, blocks, on_air = PARITY_ROUNDS[name]
    env, pol = JaxLandmarkNav(), JaxMLPPolicy()
    cfg = jax_fedpg.FedPGConfig(n_agents=n, **SMALL)
    ota_cfg = jax_ota.OTAConfig(JaxRayleigh(), noise_sigma=0.0,
                                debias=True) if on_air else None
    mesh = make_agent_mesh(RANKS, jax.devices()[:RANKS])
    round_fn = jax.jit(jax_fedpg.make_round_fn(
        env, pol, cfg, ota_cfg, agent_mesh=mesh, agent_blocks=blocks))
    rollouts = jax.jit(lambda th, keys: jax.vmap(
        lambda k: jax_sampler.rollout_batch(env, pol, th, k, cfg.horizon,
                                            cfg.batch_m))(keys))
    gains = jax.jit(lambda key_h: jax.vmap(
        lambda j: JaxRayleigh().sample(jax.random.fold_in(key_h, j), ()))(
            jnp.arange(n, dtype=jnp.int32)))
    key_init, key_scan = jax.random.split(jax.random.key(SEED))
    theta = pol.init(key_init)
    theta0 = {k: np.asarray(v) for k, v in theta.items()}
    draws, metrics = [], []
    for key in jax.random.split(key_scan, cfg.n_rounds):
        key_samp, key_chan = jax.random.split(key)
        trajs = rollouts(theta, jax.random.split(key_samp, n))
        draws.append({"s0": np.array(trajs.obs[:, :, 0]),
                      "actions": np.array(trajs.actions, np.int64),
                      "gains": np.array(gains(jax.random.split(key_chan)[0]))})
        theta, m = round_fn(theta, key)
        metrics.append([float(x) for x in m[:3]])
    return {"theta0": theta0, "draws": draws, "metrics": metrics,
            "theta": {k: np.asarray(v) for k, v in theta.items()}}


def _jax_aggregates():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.core import ota as jax_ota
    from repro.core.channel import FixedGainChannel

    from jax.experimental.shard_map import shard_map   # as the package
    rng = np.random.default_rng(5)
    stack = {"a": rng.standard_normal((12, 3, 4)).astype(np.float32),
             "b": rng.standard_normal((12, 5)).astype(np.float32)}
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("agents",))
    key = jax.random.key(0)
    out = {}
    for name, (chan, n, blocks) in AGG_CASES.items():
        cfg = None if chan is None else jax_ota.OTAConfig(
            FixedGainChannel(gain=1.3), noise_sigma=0.0, debias=True)
        if name.startswith("axis"):
            rows = {k: v[:RANKS] for k, v in stack.items()}

            def f(g, cfg=cfg):
                return jax_ota.aggregate(
                    jax.tree.map(lambda x: x[0], g), cfg, key=key,
                    axis=("agents",))[0]
        else:
            rows = stack

            def f(g, cfg=cfg, n=n, blocks=blocks):
                return jax_ota.aggregate(g, cfg, key=key, axis=("agents",),
                                         n_agents=n, local_stack=True,
                                         agent_blocks=blocks)[0]
        u = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("agents"),),
                              out_specs=P(), check_rep=False))(
            jax.tree.map(jnp.asarray, rows))
        out[name] = {k: np.asarray(v) for k, v in u.items()}
    return {"stack": stack, "n_local": 3, "cases": AGG_CASES, "want": out}


def _jax_psum_steps(n_steps=2):
    import jax
    import jax.experimental.shard_map as jsm
    from jax.sharding import Mesh

    from repro.configs import get_smoke_config
    from repro.configs.base import InputShape
    from repro.core.channel import RayleighChannel as JaxRayleigh
    from repro.data.pipeline import make_batch
    from repro.models import model as jax_model
    from repro.train import trainer as jax_trainer

    lift = jsm.shard_map

    def shard_map(f, mesh, in_specs, out_specs, **kw):
        def g(*args):
            loss, grads = f(*args)
            return loss[None], grads

        return lift(g, mesh=mesh, in_specs=in_specs, out_specs=out_specs, **kw)

    jsm.shard_map = shard_map
    cfg = get_smoke_config("llama3.2-3b").with_(dtype="float32")
    model = jax_model.build(cfg)
    tcfg = jax_trainer.TrainConfig(ota_backend="xla", **PSUM)
    state = jax_trainer.init_state(model, tcfg, jax.random.key(1))
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    step = jax.jit(jax_trainer.make_psum_train_step(model, tcfg, mesh))
    key = jax.random.key(0)
    tree = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    steps = []
    for i in range(n_steps):
        batch = make_batch(cfg, InputShape("t", seq_len=16, global_batch=8,
                                           kind="train"), i)
        key_h = jax.random.split(jax.random.fold_in(key, state.step))[0]
        gains = np.array([JaxRayleigh().sample(jax.random.fold_in(key_h, j),
                                               ()) for j in range(2)],
                         np.float32)
        before = {"params": tree(state.params), "step": int(state.step),
                  "opt_step": int(state.opt_state.step),
                  "mu": tree(state.opt_state.mu),
                  "nu": tree(state.opt_state.nu)}
        state, m = step(state, batch, key)
        steps.append({"state": before,
                      "batch": {k: np.asarray(v) for k, v in batch.items()},
                      "gains": gains,
                      "metrics": {k: float(v) for k, v in m.items()},
                      "params": tree(state.params)})
    config = dict(PSUM, ota_backend="torch")
    return {"config": config, "steps": steps}


JAX_PARTS = {  # one child process each, all started together
    **{f"round_{name}": lambda name=name: _jax_rounds(name)
       for name in PARITY_ROUNDS},
    "aggregates": _jax_aggregates, "psum": _jax_psum_steps}


def main(part, path):
    """A child process: write one part of the JAX references (numpy only)
    to ``path``."""
    with open(path, "wb") as f:
        pickle.dump(JAX_PARTS[part](), f)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Every JAX reference, from one child process per part, in parallel."""
    tmp = tmp_path_factory.mktemp("jax_mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {}
    for part in JAX_PARTS:
        code = (f"import sys; sys.path[:0] = [{str(HERE.parent / 'src')!r}, "
                f"{str(HERE)!r}]; import test_torch_agent_mesh_parity as m; "
                f"m.main({part!r}, {str(tmp / part)!r})")
        procs[part] = subprocess.Popen([sys.executable, "-c", code], env=env)
    try:
        for part, proc in procs.items():
            assert proc.wait(timeout=600) == 0, f"JAX reference {part} failed"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    out = {"rounds": {}}
    for part in JAX_PARTS:
        with open(tmp / part, "rb") as f:
            value = pickle.load(f)
        if part.startswith("round_"):
            out["rounds"][part[len("round_"):]] = value
        else:
            out[part] = value
    return out


@pytest.fixture(scope="module")
def ranks(refs):
    return mesh_lib.run_local(parity_cases, RANKS, refs, device="cpu",
                              timeout=600)


@pytest.mark.parametrize("name", list(PARITY_ROUNDS))
def test_mesh_rounds_match_jax_mesh_rounds(refs, ranks, name):
    want = refs["rounds"][name]
    for r in ranks:
        metrics, theta = r["rounds"][name]
        np.testing.assert_allclose(np.array(metrics),
                                   np.array(want["metrics"]), **TOL)
        for k, v in want["theta"].items():
            np.testing.assert_allclose(theta[k], v, err_msg=k, **TOL)
    if PARITY_ROUNDS[name][2]:
        assert not np.allclose(np.array(want["metrics"])[:, 2], 1.0)


@pytest.mark.parametrize("name", list(AGG_CASES))
def test_aggregate_axis_forms_match_jax(refs, ranks, name):
    want = refs["aggregates"]["want"][name]
    for r in ranks:
        got = r["aggregates"][name]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, err_msg=k, **AGG_TOL)


def _flat(tree):
    """A nested dict of numpy arrays -> flat tensors by parameter path."""
    import torch

    from repro_torch.utils.tree import flatten_paths

    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()}
        return torch.from_numpy(np.asarray(t))

    return flatten_paths(tensors(tree))


def test_psum_train_step_matches_jax(refs, ranks):
    import torch

    from repro_torch.optim.optimizers import warmup_cosine

    assert "psum" not in ranks[2] and "psum" not in ranks[3]
    for i, (want, (metrics, params)) in enumerate(zip(
            refs["psum"]["steps"], ranks[0]["psum"])):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(metrics[k], want["metrics"][k],
                                       rtol=1e-5, err_msg=k)
        lr_t = warmup_cosine(PSUM["lr"], PSUM["warmup"], PSUM["total_steps"])(
            torch.tensor(i + 1)).item()
        flat = _flat(params)
        params_close(flat, _flat(want["params"]), lr_t)
        for k, v in _flat(ranks[1]["psum"][i][1]).items():
            assert torch.equal(v, flat[k]), f"rank 1 {k}"


@pytest.mark.parametrize("n_agents,world", [(8, 4), (6, 4), (7, 4), (10, 4),
                                            (12, 8), (5, 1)])
def test_agent_mesh_for_rule_matches_jax(monkeypatch, n_agents, world):
    from repro.core import distribute as jax_distribute

    monkeypatch.setattr(jax_distribute, "make_agent_mesh",
                        lambda n, devices: n)
    assert distribute.agent_mesh_size(n_agents, world) == \
        jax_distribute.agent_mesh_for(n_agents, devices=list(range(world)))
