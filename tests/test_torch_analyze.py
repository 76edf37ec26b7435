"""``repro_torch.analyze`` (the port's static contract checker) against
``repro.analyze`` and on planted mutants.

* AST parity: the JAX package's own fixtures for ``raw-timing``,
  ``deprecated-aggregation``, the ``noqa`` parser and the exit codes go
  through both packages' ``scan_module``: equal ``(rule, line, col,
  severity)``, counts, exit codes and JSON keys (an owner-module fixture's
  path is each package's own owner).
* Per-rule fixtures: a tripping and a clean snippet for every port rule,
  and the ``noqa`` suppression of each; the CLI, ``--strict`` nonzero on a
  planted module and zero on ``src/repro_torch/``.
* Contracts on the CPU: each passes on the real code and fails on a planted
  mutant (JAX's ``tests/test_analyze.py`` mutants, in the port's terms);
  ``lane-contract``'s packed keys equal JAX's ``_pack_partition``'s on the
  same scenarios for every family, and ``wire-dtype``'s narrowing set
  equals JAX's ``narrowing_converts(uplink_jaxpr(...))`` for the plain
  chain (JAX's ``xla``), native and bf16.  The JAX side runs only its AST
  layer, cheap packing and one ``uplink_jaxpr`` trace a case.
* The deprecated uplink shims bitwise their ``ota.aggregate`` calls, with a
  ``DeprecationWarning``, and against JAX's shims on JAX's gains at
  ``tests/test_torch_ota.py``'s tolerance (the psum forms on a 2-rank
  ``gloo`` group against JAX's under ``jax.vmap`` with the axis name);
  ``fedpg.run_jit`` / ``event_triggered.run_jit`` bitwise ``run``.

The module imports no JAX at its top: the spawned ranks import it to find
their functions.  The ``host-sync`` contract runs on the card only
(``cuda`` marker).
"""
import ast
import dataclasses
import json
import pathlib
import warnings

import numpy as np
import pytest
import torch

from repro_torch.analyze import Report, get_rules, run, scan_source
from repro_torch.analyze import contracts
from repro_torch.analyze.__main__ import main as analyze_main
from repro_torch.analyze.astutils import ModuleContext
from repro_torch.analyze.engine import scan_module
from repro_torch.analyze.findings import Finding, noqa_rules
from repro_torch.core import event_triggered, fedpg, lanes, ota
from repro_torch.core.channel import RayleighChannel
from repro_torch.kernels import abstract
from repro_torch.launch import mesh as mesh_lib
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy
from repro_torch.service import ParticipationConfig
from repro_torch.utils.device import make_generator

CPU = "cpu"
RTOL, ATOL = 1e-6, 1e-7   # tests/test_torch_ota.py's


@pytest.fixture(autouse=True)
def _fresh_lane_programs():
    """No test leaves a lane program cached that a mutant built."""
    yield
    fedpg.clear_compilation_cache()


def _ids(findings):
    return sorted({f.rule for f in findings})


def _scan(source, rule_id, relpath="<string>"):
    return scan_source(source, relpath=relpath, rules=get_rules([rule_id]))


# ---------------------------------------------------------------------------
# AST parity with repro.analyze on its own fixtures
# ---------------------------------------------------------------------------

# (rule, source, relpath) from tests/test_analyze.py
JAX_FIXTURES = [
    ("deprecated-aggregation",
     "from repro.core.ota import exact_aggregate\n"
     "def f(g, key):\n"
     "    return exact_aggregate(g)\n", "<string>"),
    ("deprecated-aggregation",
     "from repro.core import ota\n"
     "def f(cfg, g, key):\n"
     "    return ota.aggregate(cfg, g, key)\n", "<string>"),
    ("deprecated-aggregation",
     "def exact_aggregate(g):\n"
     "    return g\n"
     "x = exact_aggregate(None)\n", "src/repro/core/ota.py"),
    ("raw-timing", "import time\nt0 = time.perf_counter()\n", "<string>"),
    ("raw-timing", "import time\nt0 = time.perf_counter_ns()\n",
     "<string>"),
    ("raw-timing", "import time\nt0 = time.monotonic()\n", "<string>"),
    ("raw-timing", "import time as t\nx = t.perf_counter()\n", "<string>"),
    ("raw-timing", "from time import perf_counter as pc\nx = pc()\n",
     "<string>"),
    ("raw-timing", "import time\n"
                   "from repro.telemetry import trace\n"
                   "ts = time.time()\n"
                   "with trace.span('work'):\n"
                   "    pass\n", "<string>"),
    ("raw-timing", "import time\n"
                   "t0 = time.perf_counter()  # repro: noqa[raw-timing]\n",
     "<string>"),
    ("raw-timing", "import time\nt0 = time.perf_counter()  # repro: noqa\n",
     "<string>"),
    ("raw-timing", "import time\n"
                   "t0 = time.perf_counter()  # repro: noqa[key-reuse]\n",
     "<string>"),
    ("raw-timing", "import time\nt0 = time.perf_counter()\n",
     "src/repro/telemetry/trace.py"),
]


def _own_path(relpath):
    """A JAX owner-module path as the port's owner of the same invariant."""
    return relpath.replace("src/repro/", "src/repro_torch/")


def _report(pkg, source, relpath, rule_id):
    analyze = __import__(f"{pkg}.analyze.engine", fromlist=["scan_module"])
    astutils = __import__(f"{pkg}.analyze.astutils",
                          fromlist=["ModuleContext"])
    findings = __import__(f"{pkg}.analyze.findings", fromlist=["Report"])
    rules = __import__(f"{pkg}.analyze.rules", fromlist=["get_rules"])
    report = findings.Report()
    ctx = astutils.ModuleContext(path=pathlib.Path(relpath), relpath=relpath,
                                 tree=ast.parse(source),
                                 source_lines=source.splitlines())
    analyze.scan_module(ctx, rules.get_rules([rule_id]), report)
    return report


@pytest.mark.parametrize("rule_id,source,relpath", JAX_FIXTURES)
def test_ast_findings_equal_jax_on_its_fixtures(rule_id, source, relpath):
    want = _report("repro", source, relpath, rule_id)
    got = _report("repro_torch", source, _own_path(relpath), rule_id)

    def key(r):
        return [(f.rule, f.line, f.col, f.severity) for f in r.findings]

    assert key(got) == key(want)
    assert got.counts == want.counts
    for strict in (False, True):
        assert got.exit_code(strict=strict) == want.exit_code(strict=strict)
    assert json.loads(got.to_json()).keys() == json.loads(
        want.to_json()).keys()


def test_noqa_parser_and_exit_codes_equal_jax():
    from repro.analyze import findings as jf

    lines = ["x = 1", "x = 1  # repro: noqa", "x = 1  # repro: noqa[a-b, c]",
             "x  #repro:noqa[device-env]", "# repro: noqa[]"]
    assert [noqa_rules(s) for s in lines] == [jf.noqa_rules(s) for s in lines]
    for sev in ("warning", "error", "info"):
        a = Report(findings=[Finding("r", sev, "x.py", 1, "m")])
        b = jf.Report(findings=[jf.Finding("r", sev, "x.py", 1, "m")])
        for strict in (False, True):
            assert a.exit_code(strict=strict) == b.exit_code(strict=strict)
    assert Report().exit_code(strict=True) == jf.Report().exit_code(
        strict=True) == 0


def test_suppressed_findings_still_counted():
    src = "import torch\nx = torch.randn(3)  # repro: noqa[global-rng]\n"
    report = Report()
    ctx = ModuleContext(path=pathlib.Path("<s>"), relpath="<s>",
                        tree=ast.parse(src), source_lines=src.splitlines())
    scan_module(ctx, get_rules(["global-rng"]), report)
    assert report.findings == [] and len(report.suppressed) == 1
    assert json.loads(report.to_json())["counts"]["suppressed"] == 1
    assert json.loads(report.to_json())["generated_by"] == \
        "repro_torch.analyze"


# ---------------------------------------------------------------------------
# the port's rules: a trip, a clean sibling and the noqa path each
# ---------------------------------------------------------------------------

TRIPS = [
    ("global-rng", "import torch\nx = torch.randn(3)\n"),
    ("global-rng", "import torch\nx = torch.rand_like(y)\n"),
    ("global-rng", "import torch\ny = torch.empty(3)\ny.normal_()\n"),
    ("global-rng", "import torch\ntorch.manual_seed(0)\n"),
    ("global-rng", "import torch\ntorch.cuda.manual_seed_all(0)\n"),
    ("global-rng", "import numpy as np\nx = np.random.rand(3)\n"),
    ("global-rng", "from torch import randint as ri\nx = ri(0, 4, (3,))\n"),
    ("numpy-on-device", "import numpy as np\nimport torch\n"
                        "def f(x: torch.Tensor):\n    return np.mean(x)\n"),
    ("numpy-on-device", "def f(x):\n    return x.numpy()\n"),
    ("host-sync", "def f(x):\n    return x.item()\n"),
    ("host-sync", "def f(x):\n    return x.cpu()\n"),
    ("host-sync", "import torch\n"
                  "def f(n):\n    return float(torch.zeros(n).sum())\n"),
    ("tensor-branch", "import torch\n"
                      "def f(x):\n    if torch.any(x):\n        return 1\n"),
    ("tensor-branch", "import torch\n"
                      "def f(x: torch.Tensor):\n    assert (x > 0).all()\n"),
    ("tensor-branch", "import torch\n"
                      "def f(x: torch.Tensor):\n    while x.sum() > 0:\n"
                      "        x = x - 1\n"),
    ("compile-in-loop", "import torch\ndef f(fns):\n"
                        "    return [torch.compile(g) for g in fns]\n"),
    ("compile-in-loop", "from repro_torch.kernels import build\n"
                        "def f(names):\n    for n in names:\n"
                        "        build.load(n)\n"),
    ("device-env", "import os\nos.environ['CUDA_VISIBLE_DEVICES'] = '0'\n"),
    ("device-env", "import os\nos.environ.setdefault('NCCL_DEBUG', 'INFO')\n"),
    ("device-env", "import os\nos.putenv('TORCH_LOGS', '+dynamo')\n"),
    ("device-env", "import torch\n"
                   "torch.backends.cuda.matmul.allow_tf32 = True\n"),
    ("raw-timing", "import time\nt0 = time.perf_counter()\n"),
    ("deprecated-aggregation",
     "from repro_torch.core import ota\nu = ota.exact_aggregate(g)\n"),
]

CLEAN = [
    ("global-rng", "import torch\nx = torch.randn(3, generator=g)\n"),
    # the generator on a continuation line: keywords, not lines
    ("global-rng", "import torch\nx = torch.randint(\n    0, 4, (3,),\n"
                   "    generator=g)\n"),
    ("global-rng", "import torch\ny.normal_(0.0, 1.0, generator=g)\n"),
    ("global-rng", "import numpy as np\nrng = np.random.default_rng(0)\n"
                   "s = np.random.SeedSequence(1)\n"),
    ("global-rng", "g = torch.Generator()\ng.manual_seed(3)\n"),
    ("numpy-on-device", "import numpy as np\n"
                        "def f(n):\n    return np.sqrt(2.0) * n\n"),
    ("host-sync", "import numpy as np\n"
                  "def f(x):\n    return np.asarray(x).item()\n"),
    ("host-sync", "def f(n: int):\n    return float(n)\n"),
    ("tensor-branch", "def f(x, n=3):\n    if n > 2 and x is not None:\n"
                      "        return x\n"),
    ("compile-in-loop", "import torch\nh = torch.compile(f)\n"
                        "def g(fns):\n    for f in fns:\n"
                        "        def mk(f=f):\n"
                        "            return torch.compile(f)\n"),
    ("device-env", "import os\na = os.environ.get('CUDA_VISIBLE_DEVICES')\n"
                   "os.environ['MY_FLAG'] = '1'\n"),
    ("raw-timing", "import time\nts = time.time()\n"),
    ("deprecated-aggregation",
     "from repro_torch.core import ota\nu = ota.aggregate(g, None)\n"),
]


@pytest.mark.parametrize("rule_id,source", TRIPS)
def test_rule_trips(rule_id, source):
    assert _ids(_scan(source, rule_id)) == [rule_id]
    # and the inline suppression silences it
    suppressed = "\n".join(
        line + f"  # repro: noqa[{rule_id}]" if line and not
        line.startswith(("import", "from", "def", "g =")) else line
        for line in source.splitlines())
    assert _scan(suppressed, rule_id) == []


@pytest.mark.parametrize("rule_id,source", CLEAN)
def test_rule_clean(rule_id, source):
    assert _scan(source, rule_id) == []


def test_round_path_rules_hold_their_modules_only():
    src = "def f(x):\n    return x.item()\n"
    assert _ids(_scan(src, "host-sync", "src/repro_torch/core/lanes.py")) \
        == ["host-sync"]
    assert _ids(_scan(src, "host-sync", "src/repro_torch/rl/envs/lqr.py")) \
        == ["host-sync"]
    assert _scan(src, "host-sync", "src/repro_torch/figures.py") == []
    assert _scan(src, "host-sync", "src/repro_torch/launch/dryrun.py") == []
    # owners: utils/device.py seeds and sets the device; telemetry times
    assert _scan("import torch\ntorch.manual_seed(0)\n", "global-rng",
                 "src/repro_torch/utils/device.py") == []
    assert _scan("import os\nos.environ['CUDA_X'] = '1'\n", "device-env",
                 "src/repro_torch/utils/device.py") == []
    assert _scan("import time\nt = time.perf_counter()\n", "raw-timing",
                 "src/repro_torch/telemetry/trace.py") == []


_PLANTED = '''\
import os
import time
import numpy as np
import torch
from repro_torch.core.ota import exact_aggregate

os.environ["CUDA_VISIBLE_DEVICES"] = "0"
t0 = time.perf_counter()
torch.manual_seed(0)

def round_fn(x: torch.Tensor, fns):
    if torch.any(x):
        return float(x.sum())
    compiled = [torch.compile(g) for g in fns]
    return np.mean(x) + exact_aggregate(x)
'''

_ALL_RULE_CLASSES = [
    "compile-in-loop", "deprecated-aggregation", "device-env", "global-rng",
    "host-sync", "numpy-on-device", "raw-timing", "tensor-branch",
]


def test_planted_module_trips_every_rule_class(tmp_path):
    p = tmp_path / "planted.py"
    p.write_text(_PLANTED)
    report = run([str(p)], ast_only=True)
    assert _ids(report.findings) == _ALL_RULE_CLASSES
    assert report.exit_code(strict=True) == 1


def test_cli_strict_nonzero_on_planted_zero_on_the_port(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(_PLANTED)
    out = tmp_path / "r.json"
    assert analyze_main([str(bad), "--ast-only", "--strict", "--json",
                         str(out)]) == 1
    data = json.loads(out.read_text())
    assert sorted({f["rule"] for f in data["findings"]}) == _ALL_RULE_CLASSES
    assert analyze_main(["src/repro_torch", "--ast-only", "--strict",
                         "--json", ""]) == 0
    assert analyze_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rid in _ALL_RULE_CLASSES + sorted(contracts.all_checks()):
        assert rid in listed


def test_contracts_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        contracts.run_contracts(Report(), checks=["wire-dtype"])
    with pytest.raises(RuntimeError, match="CUDA"):
        analyze_main(["--checks", "wire-dtype", "--json", "",
                      "src/repro_torch/analyze/findings.py"])


# ---------------------------------------------------------------------------
# lane-contract
# ---------------------------------------------------------------------------

def _msgs(report, rule):
    return [f.message for f in report.findings if f.rule == rule]


def test_lane_contract_passes_every_registered_family():
    from repro_torch.rl.envs import registered_envs

    report = Report()
    contracts.check_lane_contract(report, device=CPU)
    assert report.findings == [], "\n".join(f.render()
                                            for f in report.findings)
    assert report.skipped == []
    assert len(registered_envs()) >= 7


def test_lane_contract_fails_constant_promoted_mutant(monkeypatch):
    from repro_torch.core import sweep as sweep_mod

    orig = lanes.pack_lanes

    def mutant(specs, n_agents):
        packed = orig(specs, n_agents)
        if "alpha" in packed:
            packed["alpha"] = np.broadcast_to(packed["alpha"][:1],
                                              packed["alpha"].shape).copy()
        return packed

    monkeypatch.setattr(lanes, "pack_lanes", mutant)
    monkeypatch.setattr(sweep_mod.lanes, "pack_lanes", mutant)
    report = Report()
    contracts.check_lane_contract(report, device=CPU, families=["landmark"])
    assert any("identical across lanes" in m
               for m in _msgs(report, "lane-contract")), report.findings


def test_lane_contract_fails_extra_packed_axis_mutant(monkeypatch):
    orig = lanes.pack_lanes

    def mutant(specs, n_agents):
        packed = orig(specs, n_agents)
        if specs[0].ota is not None and "noise_sigma" not in packed:
            packed["noise_sigma"] = np.full((len(specs),), 1e-3, np.float32)
        return packed

    monkeypatch.setattr(lanes, "pack_lanes", mutant)
    report = Report()
    contracts.check_lane_contract(report, device=CPU, families=["landmark"])
    assert any("packed axes" in m for m in _msgs(report, "lane-contract"))


def test_lane_contract_fails_unread_leaf_mutant(monkeypatch):
    # the lanes take their step size from the specs, not the packed lanes:
    # the packed alpha leaf is dead
    orig = lanes._Lanes.__init__

    def mutant(self, *a, **k):
        orig(self, *a, **k)
        alphas = [s.alpha for s in self.specs]
        self.alpha_t = lanes._dev_f32(alphas, self.dev)
        self.alpha = alphas[0]
        self.lane_alpha = alphas

    monkeypatch.setattr(lanes._Lanes, "__init__", mutant)
    report = Report()
    contracts.check_lane_contract(report, device=CPU, families=["landmark"])
    assert any("packed leaf alpha is not read" in m
               for m in _msgs(report, "lane-contract")), report.findings


def _pack_keys(packed):
    return {k: (sorted(v) if isinstance(v, dict) else None)
            for k, v in packed.items()}


def _service_scenarios(pkg):
    sweep = __import__(f"{pkg}.core.sweep", fromlist=["Scenario"])
    channel = __import__(f"{pkg}.core.channel", fromlist=["x"])
    envs = __import__(f"{pkg}.rl.envs", fromlist=["make_env"])
    faults = __import__(f"{pkg}.service.faults", fromlist=["x"])
    svc = __import__(f"{pkg}.service.participation", fromlist=["x"])
    stale = __import__(f"{pkg}.service.staleness", fromlist=["x"])
    env = envs.make_env("landmark")
    tiny = dict(n_agents=6, batch_m=1, horizon=3, n_rounds=4)

    def scen(**kw):
        return sweep.Scenario(channel=channel.RayleighChannel(),
                              noise_sigma=1e-3, env=env, debias=True,
                              **tiny, **kw)

    P = svc.ParticipationConfig
    return [
        [scen(participation=P(rate=r)) for r in (0.3, 0.7)],
        [scen(participation=P(kind="full", faults=faults.FaultConfig(
            stragglers=faults.StragglerModel(mean=1.0), deadline=d)))
         for d in (0.5, 2.0)],
        [scen(participation=P(rate=0.5),
              staleness=stale.StalenessConfig(max_age=2, decay=dc))
         for dc in (0.5, 0.9)],
    ]


def _uplink_scenarios(pkg):
    sweep = __import__(f"{pkg}.core.sweep", fromlist=["Scenario"])
    channel = __import__(f"{pkg}.core.channel", fromlist=["x"])
    pc = __import__(f"{pkg}.core.power_control", fromlist=["x"])
    envs = __import__(f"{pkg}.rl.envs", fromlist=["make_env"])
    return [sweep.Scenario(
        channel=channel.NakagamiChannel(m=m, omega=om), noise_sigma=ns,
        alpha=1e-3, env=envs.make_env("landmark"), debias=True,
        power_control=pc.TruncatedInversion(c_min=c), **contracts._TINY)
        for m, om, ns, c in ((0.5, 1.0, 1e-3, 0.05), (1.5, 2.0, 1e-2, 0.1))]


def test_lane_contract_packed_keys_equal_jax():
    from repro.analyze import contracts as jc
    from repro.core import sweep as jsweep
    from repro.core.channel import RayleighChannel as JRayleigh
    from repro.rl.envs import registered_envs as jregistered

    from repro_torch.core import sweep as tsweep
    from repro_torch.rl.envs import registered_envs

    assert sorted(jregistered()) == sorted(registered_envs())

    def keys(mod, scens):
        (part,) = mod.partition_scenarios(scens)
        return _pack_keys(mod._pack_partition(part))

    for name in sorted(registered_envs()):
        j_envs, t_envs = jc.family_instances(name), \
            contracts.family_instances(name, CPU)
        assert (j_envs is None) == (t_envs is None)
        j = [jsweep.Scenario(channel=JRayleigh(), noise_sigma=1e-3, alpha=a,
                             env=e, **jc._TINY)
             for a, e in zip((1e-3, 2e-3), j_envs)]
        t = [tsweep.Scenario(channel=RayleighChannel(), noise_sigma=1e-3,
                             alpha=a, env=e, **contracts._TINY)
             for a, e in zip((1e-3, 2e-3), t_envs)]
        assert keys(tsweep, t) == keys(jsweep, j), name
    assert keys(tsweep, _uplink_scenarios("repro_torch")) == keys(
        jsweep, _uplink_scenarios("repro"))
    for t, j in zip(_service_scenarios("repro_torch"),
                    _service_scenarios("repro")):
        assert keys(tsweep, t) == keys(jsweep, j)


# ---------------------------------------------------------------------------
# wire-dtype
# ---------------------------------------------------------------------------

def test_wire_dtype_passes_real_uplink():
    report = Report()
    contracts.check_wire_dtype(report, device=CPU)
    assert report.findings == [], "\n".join(f.render()
                                            for f in report.findings)


def test_wire_dtype_flags_planted_narrowing(monkeypatch):
    from repro_torch.utils.optrace import AtenOp

    def narrowed(cfg, **kw):
        return ota.UplinkOps([AtenOp("aten._to_copy.default", ("float32",),
                                     "float16", (4, 8), False)], [])

    monkeypatch.setattr(ota, "uplink_ops", narrowed)
    report = Report()
    contracts.check_wire_dtype(report, device=CPU)
    assert any("unsanctioned float narrowing" in m
               for m in _msgs(report, "wire-dtype"))


def test_wire_dtype_flags_an_ignored_knob(monkeypatch):
    monkeypatch.setattr(ota, "_wire_dtype", lambda cfg: None)
    report = Report()
    contracts.check_wire_dtype(report, device=CPU)
    assert any("knob is being ignored" in m
               for m in _msgs(report, "wire-dtype"))


@pytest.mark.parametrize("apply", [False, True])
@pytest.mark.parametrize("wire", ["", "bfloat16", None])
def test_narrowing_set_equals_jax_xla(wire, apply, monkeypatch):
    import jax
    import jax.extend.core as jex

    from repro.analyze.contracts import narrowing_converts
    from repro.core import ota as jota
    from repro.core.channel import RayleighChannel as JRayleigh

    if wire is None:
        tcfg = jcfg = None
    else:
        tcfg = ota.OTAConfig(RayleighChannel(), noise_sigma=1e-3,
                             debias=True, wire_dtype=wire)
        jcfg = jota.OTAConfig(JRayleigh(), noise_sigma=1e-3, debias=True,
                              wire_dtype=wire)
    # JAX's walk names jax.core.ClosedJaxpr / Jaxpr, which newer jax
    # releases keep only under jax.extend.core
    for name in ("ClosedJaxpr", "Jaxpr", "Literal"):
        if not hasattr(jax.core, name):
            monkeypatch.setattr(jax.core, name, getattr(jex, name),
                                raising=False)
    want = narrowing_converts(jota.uplink_jaxpr(jcfg, apply=apply,
                                                backend="xla"))
    got = contracts.narrowing_ops(ota.uplink_ops(
        tcfg, apply=apply, backend="torch", device=CPU).ops)
    assert got == want


def test_uplink_ops_cuda_backend_on_the_fake_card():
    cfg = ota.OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True,
                        wire_dtype="bfloat16")
    for apply in (False, True):
        rec = ota.uplink_ops(cfg, apply=apply, backend="cuda", device=CPU)
        assert [(r.name, r.wire, r.shape, r.abstract)
                for r in rec.launches] == [
            ("ota_fused", "bfloat16", (4, 8), True)]
        assert contracts.narrowing_ops(rec.ops) == [("float32", "bfloat16")]
    # outside a log nothing is kept, but an abstract launch's wire dtype
    # is counted beside its cost
    assert abstract._LOGS == []
    abstract.reset()
    ota.uplink_ops(cfg, backend="cuda", device=CPU)
    assert abstract.WIRES == {"ota_fused": {"bfloat16": 1}}
    assert abstract.LAUNCHES == {"ota_fused": 1}
    abstract.reset()


def test_launch_logs_nest():
    cfg = ota.OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True)
    with abstract.launch_log() as outer:
        rec = ota.uplink_ops(cfg, backend="cuda", device=CPU)
        with abstract.launch_log() as inner:
            pass
    assert outer == rec.launches and len(outer) == 1 and inner == []
    assert abstract._LOGS == []


def test_narrowing_ops_unit():
    from repro_torch.utils.optrace import OpRecorder

    with OpRecorder() as rec:
        torch.zeros(3).to(torch.bfloat16)
        torch.zeros(3, dtype=torch.float16).float()
        torch.zeros(3).to(torch.int8)
    assert contracts.narrowing_ops(rec.ops) == [("float32", "bfloat16")]


# ---------------------------------------------------------------------------
# build-budget
# ---------------------------------------------------------------------------

def test_build_budget_passes_real_caches():
    report = Report()
    contracts.check_build_budget(report, device=CPU)
    assert report.findings == [], "\n".join(f.render()
                                            for f in report.findings)


def test_build_budget_flags_planted_cache_buster(monkeypatch):
    orig = fedpg.monte_carlo

    def cache_busting(*args, **kwargs):
        fedpg.clear_compilation_cache()   # the rebuild-per-call bug
        return orig(*args, **kwargs)

    monkeypatch.setattr(fedpg, "monte_carlo", cache_busting)
    report = Report()
    contracts.check_build_budget(report, device=CPU)
    assert any("made 1 lane" in m for m in _msgs(report, "build-budget"))


def test_build_budget_flags_a_second_load(monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.setitem(build.LOADED, "ota_fused", 2)
    report = Report()
    contracts.check_build_budget(report, device=CPU)
    assert any("loaded more than once" in m
               for m in _msgs(report, "build-budget"))


# ---------------------------------------------------------------------------
# collective-audit, the psum shims: one 2-rank gloo group
# ---------------------------------------------------------------------------

def _extra_all_reduce_audit(mesh):
    """The audit with a resharding planted in the mesh round: one more
    all_reduce a round."""
    orig = lanes._mesh_sums

    def mutant(lanes_, *sums):
        out = orig(lanes_, *sums)
        if lanes_.mesh is not None:
            lanes_.mesh.all_reduce(torch.zeros(1))
        return out

    lanes._mesh_sums = mutant
    try:
        return contracts.audit_rank(mesh)
    finally:
        lanes._mesh_sums = orig


def _shim_inputs(n=4):
    rng = np.random.default_rng(5)
    g = {"w": rng.standard_normal((n, 3, 5)).astype(np.float32),
         "b": rng.standard_normal((n, 5)).astype(np.float32)}
    h = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
    return g, h


def _jax_psum_refs():
    """JAX's psum shims under ``jax.vmap`` with the axis name, noiseless:
    the one-agent form over 2 members, the stacked form over 2 members of
    2 agents; each member's update and the gains JAX drew."""
    import jax
    import jax.numpy as jnp

    from repro.core import ota as jota
    from repro.core.channel import RayleighChannel as JRayleigh

    cfg = jota.OTAConfig(JRayleigh(), noise_sigma=0.0, debias=True)
    key = jax.random.key(0)
    g, _ = _shim_inputs()
    one = {k: jnp.asarray(v[:2]) for k, v in g.items()}
    stacked = {k: jnp.asarray(v.reshape((2, 2) + v.shape[1:]))
               for k, v in g.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        u1 = jax.vmap(lambda x: jota.psum_aggregate(cfg, key, x,
                                                    ("agents",)),
                      axis_name="agents")(one)
        u2, h2 = jax.vmap(lambda x: jota.psum_aggregate_stacked(
            cfg, key, x, ("agents",), n_agents=4), axis_name="agents")(
            stacked)
    h1 = jax.vmap(lambda x: jota._psum_axis(cfg, key, x, ("agents",))[1],
                  axis_name="agents")(one)
    host = {k: np.asarray(v) for k, v in u1.items()}
    return {"u1": host, "h1": np.asarray(h1),
            "u2": {k: np.asarray(v) for k, v in u2.items()},
            "h2": np.asarray(h2).reshape(-1)}


def _ranks_job(mesh, refs):
    """On each rank: the real audit, the planted one, and the psum shims
    against their ``ota.aggregate`` calls (one agent a rank; two agents a
    rank for the stacked form) with noise from a seed, then the axis forms
    noiseless on JAX's gains."""
    out = {"audit": contracts.audit_rank(mesh),
           "mutant": _extra_all_reduce_audit(mesh)}
    g, _ = _shim_inputs()
    cfg0 = ota.OTAConfig(RayleighChannel(), noise_sigma=0.0, debias=True)
    cfg = dataclasses.replace(cfg0, noise_sigma=0.3)
    r = mesh.rank
    mine = {k: torch.from_numpy(v[r]) for k, v in g.items()}
    stack = {k: torch.from_numpy(v[2 * r:2 * r + 2]) for k, v in g.items()}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out["psum"] = ota.psum_aggregate(cfg, 7, mine, mesh)
        out["psum_stacked"] = ota.psum_aggregate_stacked(cfg, 7, stack, mesh)
    out["warned"] = [x.category.__name__ for x in w]
    out["psum_ref"] = ota.aggregate(mine, cfg, generator=make_generator(
        7, mesh.device), mesh=mesh)[0]
    out["psum_stacked_ref"] = ota.aggregate(
        stack, cfg, generator=make_generator(7, mesh.device), mesh=mesh,
        local_stack=True)
    out["psum_jax_gains"] = ota.aggregate(
        mine, cfg0, mesh=mesh, gains=torch.from_numpy(refs["h1"]),
        seed=0)[0]
    out["psum_stacked_jax_gains"] = ota.aggregate(
        stack, cfg0, mesh=mesh, local_stack=True,
        gains=torch.from_numpy(refs["h2"]), seed=0)[0]
    return out


@pytest.fixture(scope="module")
def jax_psum():
    return _jax_psum_refs()


@pytest.fixture(scope="module")
def ranks(jax_psum):
    return mesh_lib.run_local(_ranks_job, 2, jax_psum, device=CPU,
                              timeout=300.0)


def test_collective_audit_passes_on_the_mesh(ranks):
    report = Report()
    contracts.judge_collectives(report, [r["audit"] for r in ranks])
    assert report.findings == [], "\n".join(f.render()
                                            for f in report.findings)
    assert ranks[0]["audit"]["agent-mesh"]["mesh.all_reduce"] == \
        contracts._TINY["n_rounds"]


def test_collective_audit_flags_planted_resharding(ranks):
    report = Report()
    contracts.judge_collectives(report, [r["mutant"] for r in ranks])
    msgs = _msgs(report, "collective-audit")
    assert len(msgs) == 4 and all("expected" in m for m in msgs), msgs


def test_collective_audit_check_spawns_its_group():
    report = Report()
    contracts.check_collectives(report, device=CPU)
    assert report.findings == [] and report.skipped == []


def test_psum_shims_bitwise_aggregate_and_warn(ranks):
    for r in ranks:
        assert r["warned"] == ["DeprecationWarning"] * 2
        for k in r["psum"]:
            assert torch.equal(r["psum"][k], r["psum_ref"][k])
            assert torch.equal(r["psum_stacked"][0][k],
                               r["psum_stacked_ref"][0][k])
        assert torch.equal(r["psum_stacked"][1], r["psum_stacked_ref"][1])
    for k in ranks[0]["psum"]:   # every rank holds the same update
        assert torch.equal(ranks[0]["psum"][k], ranks[1]["psum"][k])


def test_psum_shims_match_jax_on_its_gains(ranks, jax_psum):
    for rank, r in enumerate(ranks):
        for k in r["psum_jax_gains"]:
            np.testing.assert_allclose(
                r["psum_jax_gains"][k].numpy(), jax_psum["u1"][k][rank],
                rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(
                r["psum_stacked_jax_gains"][k].numpy(),
                jax_psum["u2"][k][rank], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the stacked shims, run_jit
# ---------------------------------------------------------------------------

def test_stacked_shims_bitwise_aggregate_and_warn():
    g, h = _shim_inputs()
    grads = {k: torch.from_numpy(v) for k, v in g.items()}
    cfg = ota.OTAConfig(RayleighChannel(), noise_sigma=0.3, debias=True)
    with pytest.warns(DeprecationWarning, match="aggregate_stacked"):
        u, hh = ota.aggregate_stacked(cfg, 9, grads)
    u_ref, h_ref = ota.aggregate(grads, cfg, generator=make_generator(9, CPU),
                                 backend="torch")
    assert torch.equal(hh, h_ref)
    assert all(torch.equal(u[k], u_ref[k]) for k in u)
    with pytest.warns(DeprecationWarning, match="exact_aggregate"):
        e = ota.exact_aggregate(grads)
    e_ref = ota.aggregate(grads, None)[0]
    assert all(torch.equal(e[k], e_ref[k]) for k in e)


def test_stacked_shims_match_jax_on_its_gains():
    import jax
    import jax.numpy as jnp

    from repro.core import ota as jota
    from repro.core.channel import RayleighChannel as JRayleigh

    g, h = _shim_inputs()
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jcfg = jota.OTAConfig(JRayleigh(), noise_sigma=0.0, debias=True)
    tcfg = ota.OTAConfig(RayleighChannel(), noise_sigma=0.0, debias=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, jh = jota.aggregate_stacked(jcfg, jax.random.key(3), jg,
                                          gains=jnp.asarray(h))
        want_e = jota.exact_aggregate(jg)
        got, th = ota.aggregate_stacked(tcfg, 3, tg,
                                        gains=torch.from_numpy(h))
        got_e = ota.exact_aggregate(tg)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_e[k].numpy(), np.asarray(want_e[k]),
                                   rtol=RTOL, atol=ATOL)


def test_deprecated_aggregation_flags_shim_callers():
    src = ("from repro_torch.core.ota import psum_aggregate\n"
           "from repro_torch.core import ota\n"
           "u = ota.aggregate_stacked(cfg, 0, g)\n"
           "v = psum_aggregate(cfg, 0, g, mesh)\n")
    fs = _scan(src, "deprecated-aggregation")
    assert [f.line for f in fs] == [1, 3, 4]
    assert _scan(src, "deprecated-aggregation",
                 "src/repro_torch/core/ota.py") == []


SMALL = dict(batch_m=2, horizon=6, n_rounds=4, alpha=0.05)


def _bitwise(a, b):
    ta, ha = a
    tb, hb = b
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    for x, y in zip(ha, hb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


def test_fedpg_run_jit_is_run():
    cfg = fedpg.FedPGConfig(n_agents=3, **SMALL)
    ocfg = ota.OTAConfig(RayleighChannel(), noise_sigma=1e-2, debias=True)
    env, pol = LandmarkNav(), MLPPolicy()
    fedpg.clear_compilation_cache()
    ref = fedpg.run(env, pol, cfg, 4, ota=ocfg, device=CPU)
    built = lanes.LANES_BUILT
    _bitwise(fedpg.run_jit(env, pol, cfg, 4, ota=ocfg, device=CPU), ref)
    # full participation is the same run, and the same cached lane program
    _bitwise(fedpg.run_jit(env, pol, cfg, 4, ota=ocfg, device=CPU,
                           participation=ParticipationConfig(rate=1.0)), ref)
    assert lanes.LANES_BUILT == built
    part = ParticipationConfig(rate=0.5)
    _bitwise(fedpg.run_jit(env, pol, cfg, 4, ota=ocfg, device=CPU,
                           participation=part, agent_blocks=2),
             fedpg.run(env, pol, cfg, 4, ota=ocfg, device=CPU,
                       participation=part, agent_blocks=2))


def test_event_triggered_run_jit_is_run():
    cfg = fedpg.FedPGConfig(n_agents=3, **SMALL)
    et = event_triggered.ETConfig(tau=0.1)
    env, pol = LandmarkNav(), MLPPolicy()
    ref = event_triggered.run(env, pol, cfg, et, 2, device=CPU)
    _bitwise(event_triggered.run_jit(env, pol, cfg, et, 2, device=CPU), ref)
    _bitwise(event_triggered.run_jit(
        env, pol, cfg, et, 2, device=CPU,
        participation=ParticipationConfig(kind="full")), ref)
    part = ParticipationConfig(rate=0.5)
    _bitwise(event_triggered.run_jit(env, pol, cfg, et, 2, device=CPU,
                                     participation=part),
             event_triggered.run(env, pol, cfg, et, 2, device=CPU,
                                 participation=part))


def test_clear_compilation_cache_clears_every_registered_cache():
    from repro_torch.core.power_control import TruncatedInversion
    from repro_torch.core.power_control import effective_moments
    from repro_torch.rl.envs import CliffWalk

    cfg = fedpg.FedPGConfig(n_agents=2, batch_m=1, horizon=3, n_rounds=1)
    fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 0, device=CPU)
    env = CliffWalk()
    fedpg.run(env, env.default_policy(), cfg, 0, device=CPU)
    effective_moments(RayleighChannel(), TruncatedInversion())
    caches = fedpg.compiled_caches()
    assert len(caches) >= 4 and lanes._cached_lanes in caches
    assert all(c.cache_info().currsize > 0 for c in caches)
    fedpg.clear_compilation_cache()
    assert all(c.cache_info().currsize == 0 for c in caches)


def test_lane_programs_of_tensor_settings_are_not_cached():
    from repro_torch.rl.envs import garnet

    env = garnet(make_generator(1, CPU))
    cfg = fedpg.FedPGConfig(n_agents=2, batch_m=1, horizon=3, n_rounds=1)
    fedpg.clear_compilation_cache()
    built = lanes.LANES_BUILT
    for _ in range(2):
        fedpg.run(env, env.default_policy(), cfg, 0, device=CPU)
    assert lanes.LANES_BUILT == built + 2
    assert lanes._cached_lanes.cache_info().currsize == 0


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6, 123456.789])
def test_rope_table_fill_is_the_host_copy_bitwise(theta):
    # the host-sync repair: theta filled on the device, not copied there,
    # rounds to the same float32
    from repro_torch.models.layers import rope_frequencies

    half = 32
    expo = torch.arange(0, half, dtype=torch.float32) / half
    want = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), expo)
    got = rope_frequencies(2 * half, theta, "cpu")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# stream-contract, participation-contract, host-sync
# ---------------------------------------------------------------------------

def test_stream_contract_passes_real_streaming():
    report = Report()
    contracts.check_stream_contract(report, device=CPU)
    assert report.findings == [], "\n".join(f.render()
                                            for f in report.findings)


def test_stream_contract_flags_unblocked_layout_mutant(monkeypatch):
    # one fleet-sized block: the round's gradient rows become (L, N, P)
    monkeypatch.setattr(ota, "blocked_layout", lambda n, b: (1, int(n), 0))
    report = Report()
    contracts.check_stream_contract(report, device=CPU)
    msgs = _msgs(report, "stream-contract")
    assert any("scales with the fleet" in m for m in msgs), msgs
    assert any("memory grows with the fleet" in m for m in msgs), msgs


def test_participation_contract_passes():
    report = Report()
    contracts.check_participation_contract(report, device=CPU)
    assert report.findings == [], "\n".join(f.render()
                                            for f in report.findings)


def test_participation_contract_flags_a_mask_blind_normaliser(monkeypatch):
    orig = fedpg._round_weights

    def expected_only(part, stale, mask, age, expected, decay=None):
        part = dataclasses.replace(part, debias="expected")
        return orig(part, stale, mask, age, expected, decay)

    monkeypatch.setattr(fedpg, "_round_weights", expected_only)
    report = Report()
    contracts.check_participation_contract(report, device=CPU)
    msgs = _msgs(report, "participation-contract")
    assert len(msgs) == 3 and all("does not read" in m for m in msgs), msgs


def test_host_sync_skips_on_the_cpu_and_judges_counts():
    report = Report()
    contracts.check_host_sync(report, device=CPU)
    assert report.findings == [] and len(report.skipped) == 1
    assert report.skipped[0].startswith("host-sync")
    ok = {"main cell": [9, 4, 4, 4], "batched R=1": [7, 3, 3],
          "batched R=20": [12, 3, 3]}
    report = Report()
    contracts.judge_syncs(report, ok)
    assert report.findings == []
    for bad in ({"main cell": [9, 4, 5, 4]},
                {"batched R=1": [7, 3, 3], "batched R=20": [7, 20, 20]}):
        report = Report()
        contracts.judge_syncs(report, bad)
        assert _ids(report.findings) == ["host-sync"]


def test_sync_counter_needs_the_card():
    from repro_torch.analyze import budget

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with budget.SyncCounter():
            pass


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU runs the plain versions")
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_sync_contract_on_the_card(cuda):
    report = Report()
    contracts.check_host_sync(report, device=cuda)
    assert report.findings == [] and report.skipped == []


@pytest.mark.cuda
def test_wire_dtype_launches_are_real_on_the_card(cuda):
    with abstract.launch_log() as launches:
        report = Report()
        contracts.check_wire_dtype(report, device=cuda)
    assert report.findings == []
    assert launches and not any(r.abstract for r in launches)
