"""Layer 2: trace-level contract checkers.

The port's form of ``repro/analyze/contracts.py``: the same check ids (and
``build-budget`` for JAX's ``compile-budget``, plus ``host-sync``), each in
PyTorch's meaning.  Where the AST rules read source, these checkers import
the real registries, run representative (env x channel x uplink) programs
at a tiny size through the hooks the core modules expose
(``sweep.lane_program``, ``ota.uplink_ops``, ``envs.registered_envs``), and
assert structural properties of what they did.  They run on ``device``:
the card by default, the CPU when asked (where the ``cuda`` backend's
uplink is traced on the fake card, ``launch/fake_card.py``).

``lane-contract``
    The sweep engine's bitwise-lane invariant, checked structurally: for
    every registered env family a two-lane partition must pack exactly the
    varying axes (set equality against a re-derivation from the scenario
    list), every packed leaf must differ across lanes, every packed leaf
    must be read by the lane program (perturb lane 1's leaf: lane 1's
    history moves and lane 0's stays bitwise the same), and a constant
    partition must pack to ``{}`` (the replicate path).

``wire-dtype``
    No aten float narrowing (a ``_to_copy`` to a smaller float) in the
    uplink (``ota.uplink_ops``) except the sanctioned
    ``OTAConfig.wire_dtype`` bf16 hop, which must appear when asked.
    JAX's rule for its backends holds each counterpart: the plain chain
    (``"torch"``, JAX's ``"xla"``) never narrows, bf16 asked or not; on the
    kernel path (``"cuda"``, JAX's ``"pallas"``) the hop is K1's wire, so
    K1's launch records must read the stack in bfloat16 and the only aten
    narrowing allowed is to bfloat16.

``build-budget`` (JAX ``compile-budget``)
    Each kernel library is built and loaded at most once a process; a sweep
    makes at most one lane program per structural partition; a second
    ``monte_carlo`` call with equal configs makes none.  Counting uses
    :mod:`repro_torch.analyze.budget`.

``collective-audit``
    The agent-mesh round issues only the expected collectives: one
    ``all_reduce`` (the uplink's sums) and one ``all_gather`` (the fleet's
    per-agent scalars) a round, counted by ``launch.mesh``'s counters and
    by every ``torch.distributed`` collective the round calls, for the
    stacked round and for the streamed round on a fleet the ranks do not
    divide.  It spawns its own 2-rank ``gloo`` group on the CPU
    (``launch.mesh.run_local``), so unlike JAX's it never skips.

``stream-contract``
    The streamed forms' memory invariant: the shapes of the gradient rows
    (every new tensor whose last dimension is the gradient's width) that
    the streamed uplink and the streamed round (``lanes._streamed_round``)
    make are the same at two fleet sizes at a fixed block.  The stacked
    inputs (the ``(N, d)`` stack handed in, and views of it) are no new
    tensors, and the per-agent draws and scalars have another width.

``participation-contract``
    The round service's normaliser (realized debias reads the round's
    mask, expected debias does not), the sweep packing of the continuous
    service knobs (rate / deadline / decay as live lanes, structural knobs
    as partition splits, never-dropping configs folded into the plain
    partition), and a ``global-rng`` scan of ``src/repro_torch/service``.

``host-sync`` (card only; the runtime twin of JAX's ``tracer-leak``)
    Host-device syncs PyTorch makes a round (``budget.SyncCounter``) must
    be the same every round after the first, and a batched round's count
    must not depend on its lanes (R = 1 and R = 20), for the main cell's
    round, the batched round and the streamed round in blocks of 4.
    Skipped, with a report note, under ``device="cpu"``.

Checkers emit the same :class:`~repro_torch.analyze.findings.Finding`
records as the AST layer; source anchors point at the module that owns the
violated invariant.  A check that cannot run is a finding with the reason:
nothing falls back.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.analyze.findings import Finding, Report

_CHECKS: Dict[str, Callable[..., None]] = {}


def register_check(name: str):
    def deco(fn):
        _CHECKS[name] = fn
        return fn
    return deco


def all_checks() -> Dict[str, Callable[..., None]]:
    return dict(_CHECKS)


def run_contracts(report: Report, checks: Optional[Sequence[str]] = None,
                  device=None) -> Report:
    """Run the named trace-level checks (default: all) into ``report`` on
    ``device`` (``None``: the card; raises without one)."""
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    names = list(checks) if checks is not None else sorted(_CHECKS)
    for name in names:
        if name not in _CHECKS:
            raise KeyError(
                f"unknown contract check {name!r}; known: {sorted(_CHECKS)}")
    for name in names:
        try:
            _CHECKS[name](report, device=dev)
        except Exception as exc:   # a check that cannot run fails
            report.findings.append(_finding(
                name, "<contract>",
                f"the check could not run: {type(exc).__name__}: {exc}\n"
                f"{traceback.format_exc(limit=4)}"))
    return report


def _finding(rule: str, path: str, message: str,
             severity: str = "error") -> Finding:
    return Finding(rule=rule, severity=severity, path=path, line=0,
                   message=message)


def _dev(device):
    """A check's device: the card unless the caller asks for the CPU."""
    from repro_torch.utils.device import resolve_device

    return resolve_device(device)


_SWEEP_PATH = "src/repro_torch/core/sweep.py"
_LANES_PATH = "src/repro_torch/core/lanes.py"
_OTA_PATH = "src/repro_torch/core/ota.py"
_FEDPG_PATH = "src/repro_torch/core/fedpg.py"
_BUILD_PATH = "src/repro_torch/kernels/build.py"

# Tiny-but-real run shape shared by every program below; the service axes
# take a fleet and a run long enough that a deadline drops agents and a
# staleness decay weighs a replay.
_TINY = dict(n_agents=2, batch_m=1, horizon=3, n_rounds=2)
_TINY_SERVICE = dict(n_agents=6, batch_m=1, horizon=3, n_rounds=4)
# how lane 1's packed leaf is perturbed, x -> a x + b, in turn until its
# history moves: a run reads a value through saturating maps (a truncated
# channel inversion, a deadline past every delay), so one nudge can leave
# the output where it was
_PERTURBATIONS = ((1.5, 0.125), (0.0, 0.0), (100.0, 0.0))


# ---------------------------------------------------------------------------
# lane-contract
# ---------------------------------------------------------------------------

def family_instances(name: str, device=None) -> Optional[list]:
    """Two same-kind instances of a registered family differing in a
    continuous parameter (``None`` when the family has none): the first
    declared-float field scaled, as JAX's ``family_instances``; ``tabular``
    and ``hetero`` get explicit constructions that exercise their packers
    (two Garnet MDPs from generators seeded 11 and 12; two windy fleets)."""
    from repro_torch.rl.envs import is_float_field, make_env
    from repro_torch.utils.device import make_generator

    if name == "tabular":
        from repro_torch.rl.envs import garnet
        return [garnet(make_generator(11, device)),
                garnet(make_generator(12, device))]
    if name == "hetero":
        from repro_torch.rl.envs import WindyLandmarkNav, make_heterogeneous_env
        return [
            make_heterogeneous_env([WindyLandmarkNav(wind=0.0),
                                    WindyLandmarkNav(wind=0.1)]),
            make_heterogeneous_env([WindyLandmarkNav(wind=0.05),
                                    WindyLandmarkNav(wind=0.2)]),
        ]
    proto = make_env(name)
    ffields = [f for f in dataclasses.fields(proto) if is_float_field(f)]
    if not ffields:
        return None
    f = ffields[0]
    other = dataclasses.replace(
        proto, **{f.name: float(getattr(proto, f.name)) * 1.5 + 0.125})
    return [proto, other]


def _expected_packed_keys(part) -> set:
    """Re-derivation of which axes must be packed, from the scenarios alone:
    exactly the axes whose values vary across the partition (env only when
    the registry packer yields varying parameters)."""
    from repro_torch.rl.envs import batched_env_arrays
    from repro_torch.service import participation as svc_participation
    from repro_torch.service import staleness as svc_staleness

    scens = part.scenarios
    proto = part.proto
    expected = set()
    if proto.env is not None and part.varying("env"):
        _, arrays = batched_env_arrays([s.env for s in scens])
        if arrays:
            expected.add("env")
    if part.varying("alpha"):
        expected.add("alpha")
    if proto.channel is not None:
        if part.varying("noise_sigma"):
            expected.add("noise_sigma")
        if part.varying("channel"):
            expected.add("channel")
        if proto.power_control is not None and part.varying("power_control"):
            expected.add("power_control")
        if proto.debias and ("channel" in expected
                             or "power_control" in expected):
            expected.add("update_scale")
    p0 = svc_participation.normalize(proto.participation, proto.n_agents)
    if p0 is not None:
        pn = [svc_participation.normalize(s.participation, s.n_agents)
              for s in scens]
        if p0.kind == "bernoulli" \
                and len({float(p.rate) for p in pn}) > 1:
            expected.add("participation_rate")
        if p0.debias == "realized" and p0.faults is not None \
                and p0.faults.active \
                and len({float(p.faults.deadline) for p in pn}) > 1:
            expected.add("participation_deadline")
        st0 = svc_staleness.normalize(proto.staleness, p0)
        if st0 is not None and len(
                {float(svc_staleness.normalize(s.staleness, q).decay)
                 for s, q in zip(scens, pn)}) > 1:
            expected.add("staleness_decay")
    return expected


def packed_leaves(packed: Dict[str, Any]) -> List[tuple]:
    """``((axis, field or None), array)`` for every leaf of a packing."""
    out = []
    for axis in sorted(packed):
        v = packed[axis]
        if isinstance(v, dict):
            out.extend(((axis, k), v[k]) for k in sorted(v))
        else:
            out.append(((axis, None), v))
    return out


@contextlib.contextmanager
def _perturbed(leaf: tuple, lane: int = 1, ab=_PERTURBATIONS[0]):
    """Lane programs made inside read lane ``lane`` of the packed ``leaf``
    as ``a x + b`` (``ab``): ``lanes.pack_lanes`` is wrapped, and the lane
    program cache emptied on the way in and out."""
    import numpy as np

    from repro_torch.core import fedpg, lanes

    orig = lanes.pack_lanes
    axis, field = leaf

    def patched(specs, n_agents):
        packed = copy.deepcopy(orig(specs, n_agents))
        holder = packed[axis] if field is not None else packed
        key = field if field is not None else axis
        arr = np.array(holder[key], copy=True)
        arr[lane] = (arr[lane].astype(np.float64) * ab[0] + ab[1]).astype(
            arr.dtype)
        holder[key] = arr
        return packed

    fedpg.clear_compilation_cache()
    lanes.pack_lanes = patched
    try:
        yield
    finally:
        lanes.pack_lanes = orig
        fedpg.clear_compilation_cache()


def _history_arrays(hist) -> List[Any]:
    """Every leaf of a lane program's History, on the host."""
    return [x.detach().cpu().numpy() for x in hist[:3]]


def _lane_equal(a, b, lane: int) -> bool:
    import numpy as np

    return all(np.array_equal(x[lane], y[lane], equal_nan=True)
               for x, y in zip(a, b))


def _check_one_partition(report: Report, scens, label: str, dev) -> None:
    """The structural lane-contract assertions for one scenario list that
    must form a single partition."""
    import numpy as np

    from repro_torch.core import fedpg
    from repro_torch.core.sweep import lane_program, partition_scenarios

    parts = partition_scenarios(scens)
    if len(parts) != 1:
        report.findings.append(_finding(
            "lane-contract", _SWEEP_PATH,
            f"{label}: continuous-axis grid split into {len(parts)} "
            "partitions (a continuous axis leaked into _structure_key)"))
        return
    part = parts[0]
    fedpg.clear_compilation_cache()
    packed, fn, seeds = lane_program(None, None, part, mc_runs=1,
                                     device=dev)
    expected = _expected_packed_keys(part)
    if set(packed) != expected:
        report.findings.append(_finding(
            "lane-contract", _SWEEP_PATH,
            f"{label}: packed axes {sorted(packed)} != varying axes "
            f"{sorted(expected)} — constant axes must stay the run's own "
            "values, varying axes must be packed"))
        return
    base = _history_arrays(fn(seeds))

    # Channel / power-control objects pack WHOLESALE by design: all fields
    # of the varying dataclass (plus double-precomputed derived constants
    # like BatchedChannel's _mean) travel as lane parameters, so single
    # leaves may legitimately be constant or unread — but the object as a
    # whole must vary and reach the lanes.  Everything else packs per axis
    # and is held to the strict leaf-level contract.
    wholesale = {"channel", "power_control"}
    n_lanes = len(part.scenarios)
    axis_varies: Dict[str, bool] = {}
    axis_live: Dict[str, bool] = {}
    for leaf, arr in packed_leaves(packed):
        axis = leaf[0]
        name = axis if leaf[1] is None else f"{axis}[{leaf[1]!r}]"
        arr = np.asarray(arr)
        if arr.shape[0] != n_lanes:
            report.findings.append(_finding(
                "lane-contract", _SWEEP_PATH,
                f"{label}: packed leaf {name} lane axis {arr.shape[0]} != "
                f"{n_lanes} lanes"))
            continue
        varies = not all(np.array_equal(arr[0], arr[j])
                         for j in range(1, n_lanes))
        moved, other_same = False, True
        for ab in _PERTURBATIONS:
            with _perturbed(leaf, ab=ab):
                got = _history_arrays(lane_program(
                    None, None, part, mc_runs=1, device=dev)[1](seeds))
            other_same = other_same and _lane_equal(got, base, 0)
            if not _lane_equal(got, base, 1):
                moved = True
                break
        if not other_same:
            report.findings.append(_finding(
                "lane-contract", _LANES_PATH,
                f"{label}: perturbing lane 1's {name} moved lane 0 — lanes "
                "of one batched run are not independent"))
        axis_varies[axis] = axis_varies.get(axis, False) or varies
        axis_live[axis] = axis_live.get(axis, False) or moved
        if axis in wholesale:
            continue
        if not varies:
            report.findings.append(_finding(
                "lane-contract", _SWEEP_PATH,
                f"{label}: packed leaf {name} is identical across lanes — "
                "a partition constant was promoted to a lane value"))
        if not moved:
            report.findings.append(_finding(
                "lane-contract", _LANES_PATH,
                f"{label}: packed leaf {name} is not read by the lane "
                "program — its lanes silently run another value"))
    for axis in sorted(set(axis_varies) & wholesale):
        if not axis_varies[axis]:
            report.findings.append(_finding(
                "lane-contract", _SWEEP_PATH,
                f"{label}: packed object {axis!r} is identical across all "
                "lanes — a partition-constant object was promoted to lane "
                "values"))
        if not axis_live[axis]:
            report.findings.append(_finding(
                "lane-contract", _LANES_PATH,
                f"{label}: no leaf of packed object {axis!r} reaches the "
                "lane program — its lanes silently run the prototype"))


@register_check("lane-contract")
def check_lane_contract(report: Report, device=None,
                        families: Optional[Sequence[str]] = None) -> None:
    from repro_torch.core.channel import NakagamiChannel, RayleighChannel
    from repro_torch.core.power_control import TruncatedInversion
    from repro_torch.core.sweep import (
        Scenario, _pack_partition, partition_scenarios,
    )
    from repro_torch.rl.envs import make_env, registered_envs

    dev = _dev(device)
    names = list(families) if families is not None \
        else sorted(registered_envs())
    chan = RayleighChannel()
    for name in names:
        envs = family_instances(name, dev)
        if envs is None:
            # no continuous env axis: alpha still varies, env stays constant
            report.skipped.append(
                f"lane-contract: env family {name!r} has no continuous "
                "parameter; alpha-axis coverage only")
            proto = make_env(name)
            envs = [proto, proto]
        scens = [
            Scenario(channel=chan, noise_sigma=1e-3, alpha=a, env=e, **_TINY)
            for a, e in zip((1e-3, 2e-3), envs)
        ]
        _check_one_partition(report, scens, f"family {name!r}", dev)

    # the uplink axes: channel params + power control + noise + debias vary
    # together inside one landmark partition
    env = make_env("landmark")
    scens = [
        Scenario(channel=NakagamiChannel(m=m, omega=om), noise_sigma=ns,
                 alpha=1e-3, env=env, debias=True,
                 power_control=TruncatedInversion(c_min=c), **_TINY)
        for m, om, ns, c in ((0.5, 1.0, 1e-3, 0.05), (1.5, 2.0, 1e-2, 0.1))
    ]
    _check_one_partition(report, scens, "uplink axes (channel/pc/noise)", dev)

    # a fully-constant partition must take the replicate path: packed == {}
    const = [Scenario(channel=chan, noise_sigma=1e-3, alpha=1e-3, env=env,
                      **_TINY)] * 2
    packed = _pack_partition(partition_scenarios(const)[0])
    if packed:
        report.findings.append(_finding(
            "lane-contract", _SWEEP_PATH,
            f"identical-scenario partition packed {sorted(packed)}; "
            "constants must stay the run's own values (replicate path)"))


# ---------------------------------------------------------------------------
# wire-dtype
# ---------------------------------------------------------------------------

_FLOAT_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
                "float8_e4m3fn": 1, "float8_e5m2": 1}


def narrowing_ops(ops) -> List[tuple]:
    """Every float -> smaller-float conversion among ``ops``
    (``utils.optrace.AtenOp`` records), as ``(src_dtype, dst_dtype)``
    pairs: the counterpart of JAX's ``narrowing_converts``."""
    hits = []
    for o in ops:
        if o.op.rpartition(".")[0] not in ("aten._to_copy", "aten.to",
                                           "aten.copy_",
                                           "aten._convert_element_type"):
            continue
        srcs = [d for d in o.in_dtypes if d in _FLOAT_BYTES]
        if not srcs or o.dtype not in _FLOAT_BYTES:
            continue
        src = srcs[0]
        if _FLOAT_BYTES[o.dtype] < _FLOAT_BYTES[src]:
            hits.append((src, o.dtype))
    return hits


_JAX_BACKEND = {"torch": "xla", "cuda": "pallas"}


@register_check("wire-dtype")
def check_wire_dtype(report: Report, device=None) -> None:
    from repro_torch.core import ota
    from repro_torch.core.channel import RayleighChannel

    dev = _dev(device)
    native = ota.OTAConfig(channel=RayleighChannel(), noise_sigma=1e-3,
                           debias=True)
    bf16 = dataclasses.replace(native, wire_dtype="bfloat16")
    for apply_form in (False, True):
        form = "aggregate_apply" if apply_form else "aggregate"
        for backend in ("torch", "cuda"):
            tag_b = f"{backend} (JAX {_JAX_BACKEND[backend]})"
            # no config may narrow floats without asking for it — and the
            # knob is the kernel path's, so the plain chain stays native
            for cfg, tag in ((None, "exact"), (native, "native"),
                             *(((bf16, "bf16"),) if backend == "torch"
                               else ())):
                rec = ota.uplink_ops(cfg, apply=apply_form, backend=backend,
                                     device=dev)
                hits = narrowing_ops(rec.ops)
                wires = sorted({r.wire for r in rec.launches})
                if hits or any(w != "float32" for w in wires):
                    report.findings.append(_finding(
                        "wire-dtype", _OTA_PATH,
                        f"{form}/{tag_b}/{tag}: unsanctioned float narrowing "
                        f"on the uplink: aten {hits}, launches read in "
                        f"{wires} (only OTAConfig.wire_dtype on the cuda "
                        "backend may narrow)"))
        # the sanctioned hop: cuda + wire_dtype="bfloat16" must read the
        # stack in bf16, and narrow to nothing else
        rec = ota.uplink_ops(bf16, apply=apply_form, backend="cuda",
                             device=dev)
        hits = narrowing_ops(rec.ops)
        bad = [h for h in hits if h[1] != "bfloat16"]
        if bad:
            report.findings.append(_finding(
                "wire-dtype", _OTA_PATH,
                f"{form}/cuda/bf16: narrowing beyond the sanctioned bf16 "
                f"hop: {bad}"))
        wires = [r.wire for r in rec.launches]
        if not wires or any(w != "bfloat16" for w in wires):
            report.findings.append(_finding(
                "wire-dtype", _OTA_PATH,
                f"{form}/cuda/bf16: wire_dtype='bfloat16' gave K1 launches "
                f"read in {wires} — the wire-dtype knob is being ignored"))


# ---------------------------------------------------------------------------
# build-budget
# ---------------------------------------------------------------------------

@register_check("build-budget")
def check_build_budget(report: Report, device=None) -> None:
    from repro_torch.analyze import budget
    from repro_torch.core import fedpg
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.sweep import (
        grid, partition_scenarios, resolve_env_policy, sweep,
    )
    from repro_torch.rl.envs import WindyLandmarkNav

    dev = _dev(device)
    fedpg.clear_compilation_cache()
    scens = grid(channel=[None, RayleighChannel()], noise_sigma=1e-3,
                 alpha=[1e-3, 2e-3],
                 env=[WindyLandmarkNav(wind=w) for w in (0.0, 0.2)],
                 **_TINY)
    n_parts = len(partition_scenarios(scens))
    with budget.BuildCounter() as c:
        sweep(None, None, scens, 5, 2, device=dev)
    if max(c.lanes, c.lane_programs) > n_parts:
        report.findings.append(_finding(
            "build-budget", _SWEEP_PATH,
            f"sweep over {len(scens)} scenarios / {n_parts} partitions "
            f"made {c.lane_programs} partition programs and {c.lanes} lane "
            f"states (budget {n_parts} each) — a lane axis is splitting the "
            "partition's batched run"))

    # repeated monte_carlo with equal configs must reuse the lane program
    s = scens[-1]
    env, policy = resolve_env_policy(s)
    cfg, ota = s.fedpg_config(), s.ota_config()
    fedpg.monte_carlo(env, policy, cfg, 5, 2, ota=ota, device=dev)
    with budget.BuildCounter() as c2:
        fedpg.monte_carlo(env, policy, cfg, 6, 2, ota=ota, device=dev)
    if c2.lanes != 0:
        report.findings.append(_finding(
            "build-budget", _FEDPG_PATH,
            f"repeated monte_carlo with equal configs made {c2.lanes} lane "
            "program(s); the lane-program cache is not keying correctly"))

    # every kernel library: built at most once, loaded at most once
    counts = budget.process_builds()
    for what, by_name in (("built", counts["built"]),
                          ("loaded", counts["loaded"])):
        over = {k: v for k, v in by_name.items() if v > 1}
        if over:
            report.findings.append(_finding(
                "build-budget", _BUILD_PATH,
                f"kernel libraries {what} more than once in this process: "
                f"{over}"))
    if dev.type == "cuda":
        from repro_torch.kernels import build

        with budget.BuildCounter() as c3:
            for name in build.sources():
                build.load(name)
                build.load(name)
        again = {k: v for k, v in budget.process_builds()["loaded"].items()
                 if v > 1}
        if again or sum(c3.builds.values()) > len(build.sources()):
            report.findings.append(_finding(
                "build-budget", _BUILD_PATH,
                f"loading every kernel twice rebuilt or reloaded: builds "
                f"{c3.builds}, loads {c3.loads}"))


# ---------------------------------------------------------------------------
# collective-audit
# ---------------------------------------------------------------------------

_EXPECTED_PER_ROUND = {"all_reduce": 1, "all_gather": 1}
_DIST_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "scatter", "gather", "barrier", "send", "recv",
    "isend", "irecv", "all_gather_object", "broadcast_object_list",
)
_AUDIT_RANKS = 2


def _audit_cases(n_ranks: int):
    """``(label, n_agents, agent_blocks)`` of the audited rounds: the
    stacked round, and the streamed round on a fleet the ranks do not
    divide."""
    return (("agent-mesh", 2 * n_ranks, None),
            ("streamed agent-mesh (padded)", 2 * n_ranks + 1, 1))


def audit_rank(mesh) -> Dict[str, Dict[str, int]]:
    """One rank of the audit (``launch.mesh.run_local``): each case's
    collectives during a run of ``_TINY``'s rounds, as ``launch.mesh``'s
    counters and as every ``torch.distributed`` collective called."""
    import torch.distributed as dist

    from repro_torch.core import fedpg
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.ota import OTAConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    ota = OTAConfig(channel=RayleighChannel(), noise_sigma=1e-3, debias=True)
    calls: Dict[str, int] = {}
    originals = {n: getattr(dist, n) for n in _DIST_COLLECTIVES
                 if hasattr(dist, n)}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    out = {}
    for label, n, blocks in _audit_cases(mesh.size):
        cfg = fedpg.FedPGConfig(n_agents=n, batch_m=1, horizon=3,
                                n_rounds=_TINY["n_rounds"])
        calls.clear()
        r0, g0 = mesh_lib.ALL_REDUCES, mesh_lib.ALL_GATHERS
        for name, fn in originals.items():
            setattr(dist, name, counting(name, fn))
        try:
            fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 0, ota=ota,
                      agent_blocks=blocks, agent_mesh=mesh,
                      device=mesh.device)
        finally:
            for name, fn in originals.items():
                setattr(dist, name, fn)
        out[label] = {"mesh.all_reduce": mesh_lib.ALL_REDUCES - r0,
                      "mesh.all_gather": mesh_lib.ALL_GATHERS - g0,
                      **{f"dist.{k}": v for k, v in calls.items()}}
    return out


def judge_collectives(report: Report, per_rank: List[Dict]) -> None:
    """Hold each rank's audit counts (:func:`audit_rank`) to one
    ``all_reduce`` and one ``all_gather`` a round and nothing else."""
    rounds = _TINY["n_rounds"]
    want = {f"{w}.{k}": v * rounds for k, v in _EXPECTED_PER_ROUND.items()
            for w in ("mesh", "dist")}
    for rank, cases in enumerate(per_rank):
        for label, got in cases.items():
            got = {k: v for k, v in got.items() if v}
            if got != want:
                unexpected = sorted(set(got) - set(want))
                report.findings.append(_finding(
                    "collective-audit", _LANES_PATH,
                    f"{label} round on rank {rank}: collectives {got} over "
                    f"{rounds} rounds, expected {want} (one all_reduce of "
                    "the uplink's sums and one all_gather of the fleet's "
                    f"scalars a round){'; unexpected: ' if unexpected else ''}"
                    f"{', '.join(unexpected)}"))


@register_check("collective-audit")
def check_collectives(report: Report, device=None,
                      rank_fn: Callable = audit_rank) -> None:
    from repro_torch.launch.mesh import run_local

    judge_collectives(report, run_local(rank_fn, _AUDIT_RANKS, device="cpu",
                                        timeout=300.0))


# ---------------------------------------------------------------------------
# stream-contract
# ---------------------------------------------------------------------------

def row_shapes(ops, width: int) -> List[tuple]:
    """The sorted set of shapes of the new tensors (not views) among
    ``ops`` whose last dimension is ``width``: the gradient rows."""
    return sorted({o.shape for o in ops
                   if not o.view and o.shape and o.shape[-1] == width})


@register_check("stream-contract")
def check_stream_contract(report: Report, device=None) -> None:
    from repro_torch.core import fedpg, ota
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.utils.optrace import OpRecorder

    dev = _dev(device)
    block, small, large, dim = 2, 6, 24, 8
    noisy = ota.OTAConfig(channel=RayleighChannel(), noise_sigma=1e-3,
                          debias=True)
    # 1) the uplink: the blocked fold's rows must not change when the fleet
    #    grows 4x at a fixed block size
    for backend in ("torch", "cuda"):
        for cfg, tag in ((None, "exact"), (noisy, "noisy")):
            for apply_form in (False, True):
                form = "aggregate_apply" if apply_form else "aggregate"
                recs = [ota.uplink_ops(cfg, apply=apply_form, n_agents=n,
                                       dim=dim, agent_blocks=block,
                                       backend=backend, device=dev)
                        for n in (small, large)]
                rows = [row_shapes(r.ops, dim) for r in recs]
                if rows[0] != rows[1]:
                    report.findings.append(_finding(
                        "stream-contract", _OTA_PATH,
                        f"{form}/{backend}/{tag}: the blocked uplink's rows "
                        f"differ between n_agents={small} and "
                        f"n_agents={large} at agent_blocks={block} — its "
                        f"memory grows with the fleet (got {rows[0]} vs "
                        f"{rows[1]})"))
                if backend == "cuda" and \
                        len(recs[1].launches) <= len(recs[0].launches):
                    report.findings.append(_finding(
                        "stream-contract", _OTA_PATH,
                        f"{form}/cuda/{tag}: {len(recs[0].launches)} and "
                        f"{len(recs[1].launches)} K1 launches at "
                        f"n_agents={small} and {large} — agent_blocks="
                        f"{block} is not streaming at all"))

    # 2) the round: the streamed round (rollouts + folds + server tail) must
    #    keep every gradient row O(block x d)
    env, policy = LandmarkNav(), MLPPolicy()

    def round_rows(n):
        cfg = fedpg.FedPGConfig(**{**_TINY, "n_agents": n})
        with OpRecorder() as rec:
            theta, _ = fedpg.run(env, policy, cfg, 0, ota=noisy,
                                 agent_blocks=block, device=dev)
        width = sum(v.numel() for v in theta.values())
        return row_shapes(rec.ops, width)

    fedpg.clear_compilation_cache()   # rounds of the code as it stands
    got = [round_rows(n) for n in (small, large)]
    if got[0] != got[1]:
        only_small = [a for a in got[0] if a not in got[1]]
        only_large = [a for a in got[1] if a not in got[0]]
        report.findings.append(_finding(
            "stream-contract", _LANES_PATH,
            f"streamed round's gradient rows differ between n_agents={small} "
            f"and n_agents={large} at agent_blocks={block} — some state "
            f"scales with the fleet (only at N={small}: {only_small}; only "
            f"at N={large}: {only_large})"))


# ---------------------------------------------------------------------------
# participation-contract
# ---------------------------------------------------------------------------

_PARTICIPATION_PATH = "src/repro_torch/service/participation.py"


def _normaliser_moves(part, dev, n: int = 6) -> bool:
    """Whether the round's normaliser W (``fedpg._round_weights``) moves
    when one agent of the round's mask is flipped."""
    import torch

    from repro_torch.core import fedpg
    from repro_torch.service import participation as svc_part

    part = svc_part.normalize(part, n)
    seed = torch.tensor(7, dtype=torch.int64, device=dev)
    mask = svc_part.round_mask(part, seed, 0, torch.arange(n, device=dev), n)
    flipped = mask.clone()
    flipped[0] = ~flipped[0]
    expected = torch.tensor(svc_part.expected_count(part, n),
                            dtype=torch.float32, device=dev)
    w = [fedpg._round_weights(part, None, m, None, expected).w_norm
         for m in (mask, flipped)]
    return not torch.equal(w[0], w[1])


@register_check("participation-contract")
def check_participation_contract(report: Report, device=None) -> None:
    """The round service's normaliser and lane-packing contracts.

    1. ``debias="realized"``: the round's normaliser W must read the
       round's mask (flip one agent: W moves); ``debias="expected"``: W
       must not (the closed form).
    2. The sweep engine packs exactly the continuous service knobs
       (Bernoulli rate, fault deadline under realized debias, staleness
       decay) as live lanes, while the structural knobs (kind, debias mode)
       split partitions and never-dropping configs join the plain one.
    3. The ``global-rng`` AST rule over ``src/repro_torch/service`` (the
       mask and fault draws are counter hashes, never a global stream).
    """
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.sweep import Scenario, partition_scenarios
    from repro_torch.rl.envs import make_env
    from repro_torch.service.faults import FaultConfig, StragglerModel
    from repro_torch.service.participation import ParticipationConfig
    from repro_torch.service.staleness import StalenessConfig

    dev = _dev(device)
    realized = [
        ParticipationConfig(rate=0.5),
        ParticipationConfig(kind="subset", subset=3),
        ParticipationConfig(kind="full", faults=FaultConfig(
            stragglers=StragglerModel(mean=1.0), deadline=1.0)),
    ]
    for p in realized:
        if not _normaliser_moves(p, dev):
            report.findings.append(_finding(
                "participation-contract", _PARTICIPATION_PATH,
                f"realized-debias normaliser for {p.kind!r} does not read "
                "the round's mask — N/W fell back to the expected-count "
                "analysis"))
    if _normaliser_moves(ParticipationConfig(rate=0.5, debias="expected"),
                         dev):
        report.findings.append(_finding(
            "participation-contract", _PARTICIPATION_PATH,
            "expected-debias normaliser reads the round's mask — the "
            "closed-form E[W] must not depend on the realisation"))

    env = make_env("landmark")
    chan = RayleighChannel()

    def svc_scen(**kw):
        return Scenario(channel=chan, noise_sigma=1e-3, env=env,
                        debias=True, **_TINY_SERVICE, **kw)

    _check_one_partition(report, [
        svc_scen(participation=ParticipationConfig(rate=r))
        for r in (0.3, 0.7)
    ], "service rate axis", dev)
    _check_one_partition(report, [
        svc_scen(participation=ParticipationConfig(
            kind="full", faults=FaultConfig(
                stragglers=StragglerModel(mean=1.0), deadline=d)))
        for d in (0.5, 2.0)
    ], "service deadline axis", dev)
    _check_one_partition(report, [
        svc_scen(participation=ParticipationConfig(rate=0.5),
                 staleness=StalenessConfig(max_age=2, decay=dc))
        for dc in (0.5, 0.9)
    ], "service staleness-decay axis", dev)

    split = partition_scenarios([
        svc_scen(participation=ParticipationConfig(rate=0.5, debias=d))
        for d in ("realized", "expected")
    ])
    if len(split) != 2:
        report.findings.append(_finding(
            "participation-contract", _SWEEP_PATH,
            "realized- and expected-debias scenarios merged into one "
            "partition — the debias mode is structural and must split"))
    merged = partition_scenarios([
        svc_scen(participation=None),
        svc_scen(participation=ParticipationConfig(rate=1.0)),
    ])
    if len(merged) != 1:
        report.findings.append(_finding(
            "participation-contract", _SWEEP_PATH,
            "a full-participation config split from the plain partition — "
            "normalize() must fold it to participation=None"))

    from repro_torch.analyze.engine import repo_root, scan
    from repro_torch.analyze.rules import get_rules

    scan(repo_root(), ["src/repro_torch/service"],
         rules=get_rules(["global-rng"]), report=report)


# ---------------------------------------------------------------------------
# host-sync (the card only)
# ---------------------------------------------------------------------------

# the main cell (PERF.md: Algorithm 2 at the paper's width, Rayleigh,
# noise -60 dB, debiased), a few rounds
MAIN_CELL = dict(n_agents=10, batch_m=10, horizon=20, n_rounds=4,
                 alpha=2e-3)
BATCH_LANES = (1, 20)
STREAM_BLOCK = 4


@contextlib.contextmanager
def round_syncs(counter, counts: List[int]):
    """Append the syncs each round of ``core.lanes`` makes to ``counts``
    (``lanes._round`` is wrapped while the block runs), read from the open
    ``budget.SyncCounter`` ``counter``."""
    from repro_torch.core import lanes

    orig = lanes._round

    def counted(*a, **k):
        before = counter.marks()
        out = orig(*a, **k)
        counts.append(counter.marks() - before)
        return out

    lanes._round = counted
    try:
        yield counts
    finally:
        lanes._round = orig


def sync_counts(dev) -> Dict[str, List[int]]:
    """Syncs per round of the main cell (one run), of a batched run at each
    of ``BATCH_LANES`` lanes, and of the streamed run in blocks of
    ``STREAM_BLOCK`` (``budget.SyncCounter``; the first round pays one-time
    set-up)."""
    from repro_torch.analyze import budget
    from repro_torch.core import fedpg
    from repro_torch.core.channel import RayleighChannel, noise_sigma_from_db
    from repro_torch.core.ota import OTAConfig
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    cfg = fedpg.FedPGConfig(**MAIN_CELL)
    ota = OTAConfig(RayleighChannel(), noise_sigma=noise_sigma_from_db(-60.0),
                    debias=True)
    env, policy = LandmarkNav(), MLPPolicy()
    out: Dict[str, List[int]] = {}
    with budget.SyncCounter() as counter:
        with round_syncs(counter, out.setdefault("main cell", [])):
            fedpg.run(env, policy, cfg, 0, ota=ota, device=dev)
        for r in BATCH_LANES:
            with round_syncs(counter, out.setdefault(f"batched R={r}", [])):
                fedpg.monte_carlo(env, policy, cfg, 0, r, ota=ota,
                                  device=dev)
        with round_syncs(counter, out.setdefault(f"streamed blocks of "
                                        f"{STREAM_BLOCK}", [])):
            fedpg.run(env, policy, cfg, 0, ota=ota,
                      agent_blocks=STREAM_BLOCK, device=dev)
    return out


def judge_syncs(report: Report, counts: Dict[str, List[int]]) -> None:
    """Each run's count constant after its first round; the batched count
    the same at every lane count."""
    for label, per_round in counts.items():
        if len(set(per_round[1:])) > 1:
            report.findings.append(_finding(
                "host-sync", _LANES_PATH,
                f"{label}: host syncs per round {per_round} change from "
                "round to round after the first — a sync depends on the "
                "round's data"))
    batched = {r: counts[f"batched R={r}"][1:] for r in BATCH_LANES
               if f"batched R={r}" in counts}
    if len({tuple(v) for v in batched.values()}) > 1:
        report.findings.append(_finding(
            "host-sync", _LANES_PATH,
            f"host syncs per batched round depend on the lane count: "
            f"{batched} — a sync a lane"))


@register_check("host-sync")
def check_host_sync(report: Report, device=None) -> None:
    """Host-device syncs a round on the card (module docstring).  Only
    syncs PyTorch itself makes are seen (``budget.SyncCounter``): K1's
    ctypes launches and their stream are invisible to the count."""
    dev = _dev(device)
    if dev.type != "cuda":
        report.skipped.append(
            "host-sync: counts syncs with the card; skipped under "
            "device='cpu'")
        return
    judge_syncs(report, sync_counts(dev))
