"""Boundaries of the PyTorch port: it never imports JAX or the JAX package,
it never falls back to the CPU silently, and it keeps no raw timers outside
its span tracer (``telemetry/trace.py``; the chip's timings live in
``chip_smoke.py``)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("name", ["test_torch_agent_mesh.py",
                                  "test_torch_cuda.py"])
def test_rank_side_test_modules_import_no_jax(name):
    """Spawned ranks import these modules to find their functions, and the
    card tests run without the JAX package: neither imports JAX or
    ``repro``."""
    path = ROOT / "tests" / name
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"tests/{name} imports {bad}"


def test_forbidden_matches_repro_not_repro_torch():
    assert _forbidden("repro") and _forbidden("repro.core.ota")
    assert _forbidden("jax.numpy") and not _forbidden("repro_torch.core")


def test_import_leaves_jax_unloaded():
    code = ("import sys; import repro_torch.core.fedpg, repro_torch.kernels."
            "ota_fused, repro_torch.kernels.ota_channel, "
            "repro_torch.core.power_control, repro_torch.core.theory, "
            "repro_torch.optim.optimizers, repro_torch.configs.ota_pg_particle, "
            "repro_torch.kernels.ops, repro_torch.models.model, "
            "repro_torch.train.server, repro_torch.interop, "
            "repro_torch.configs.llama3_2_3b, repro_torch.configs.mamba2_130m, "
            "repro_torch.service, repro_torch.service.stream, "
            "repro_torch.rl.envs, repro_torch.core.event_triggered, "
            "repro_torch.core.sweep, repro_torch.core.lanes, "
            "repro_torch.core.distribute, repro_torch.launch.mesh, "
            "repro_torch.telemetry, "
            "repro_torch.telemetry.probes, repro_torch.telemetry.trace, "
            "repro_torch.checkpoint, repro_torch.service.driver, "
            "repro_torch.telemetry.ledger, repro_torch.telemetry.report, "
            "repro_torch.data.pipeline, repro_torch.train.trainer, "
            "repro_torch.launch.train, repro_torch.utils.platform, "
            "repro_torch.analyze, repro_torch.analyze.contracts, "
            "repro_torch.analyze.budget, repro_torch.utils.optrace; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_raw_timers_in_package():
    """The span tracer (``telemetry/trace.py``) owns the package's clock;
    no other module reads one.  The checker's ``raw-timing`` rule
    (``analyze/rules/timing.py``) names the clocks it flags, and finds no
    call of one in the package either."""
    tracer = ROOT / "src" / "repro_torch" / "telemetry" / "trace.py"
    rule = ROOT / "src" / "repro_torch" / "analyze" / "rules" / "timing.py"
    assert tracer in PORT_FILES and rule in PORT_FILES
    for path in PORT_FILES[:-1]:
        if path not in (tracer, rule):
            assert "perf_counter" not in path.read_text(), path
    from repro_torch.analyze import get_rules, repo_root, scan

    report = scan(repo_root(), ["src/repro_torch"],
                  rules=get_rules(["raw-timing"]))
    assert report.findings == [] and report.suppressed == []


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from repro_torch import interop
    from repro_torch.core import fedpg
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    cfg = fedpg.FedPGConfig(n_agents=2, batch_m=1, horizon=2, n_rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 0, agent_blocks=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedpg.monte_carlo(LandmarkNav(), MLPPolicy(), cfg, 0, 2)
    from repro_torch.core import event_triggered
    from repro_torch.service import ParticipationConfig

    with pytest.raises(RuntimeError, match="CUDA"):
        fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 0,
                  participation=ParticipationConfig(rate=0.5))
    with pytest.raises(RuntimeError, match="CUDA"):
        event_triggered.run(LandmarkNav(), MLPPolicy(), cfg,
                            event_triggered.ETConfig(), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.from_numpy({})
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.params_from_jax({})
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib

    m = model_lib.build(get_smoke_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(torch.Generator())


def test_cuda_backend_on_cpu_tensor_raises():
    from repro_torch.core import ota
    from repro_torch.core.channel import RayleighChannel

    grads = {"w": torch.ones(3, 4)}
    cfg = ota.OTAConfig(RayleighChannel(), noise_sigma=0.1)
    with pytest.raises(ValueError, match="cuda"):
        ota.aggregate(grads, cfg, backend="cuda",
                      generator=torch.Generator())
    with pytest.raises(ValueError, match="cuda"):
        ota.aggregate_apply(grads, cfg, {"w": torch.ones(4)}, alpha=0.1,
                            backend="cuda", generator=torch.Generator())


def test_slice8_entry_points_raise_without_cuda():
    """The round-service driver, the trainer, the data pipeline and the
    launcher's loop run on the card unless given ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import fedpg
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train as launch
    from repro_torch.models import model as model_lib
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.service import ParticipationConfig, RoundService
    from repro_torch.train import trainer

    cfg = fedpg.FedPGConfig(n_agents=2, batch_m=1, horizon=2, n_rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        RoundService(LandmarkNav(), MLPPolicy(), cfg, 0,
                     participation=ParticipationConfig(rate=0.5))
    llama = get_smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.init_state(model_lib.build(llama), trainer.TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticLM(DataConfig(vocab=64, seq_len=4, global_batch=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.train(llama, trainer.TrainConfig(),
                     InputShape("t", 4, 2, "train"), steps=1)


@pytest.mark.parametrize("sub", ["service", "rl/envs", "checkpoint", "data",
                                 "launch", "train", "analyze",
                                 "analyze/rules"])
def test_new_subpackages_are_covered(sub):
    """The import check above walks every file of the port, the round
    service and the environment zoo included."""
    files = sorted((ROOT / "src" / "repro_torch" / sub).glob("*.py"))
    assert files and all(f in PORT_FILES for f in files)
