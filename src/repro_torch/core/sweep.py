"""Scenario-sweep engine: the paper's figure grids, one batched run per
structural partition.

Counterpart of ``repro/core/sweep.py``.  A grid of :class:`Scenario` s
(channel parameters, noise sigma, step size, fleet size, estimator, power
control, environment, round service) is split into partitions by
structure, and each partition runs as ONE lane-batched run
(``core/lanes.py``) over its scenarios times the Monte-Carlo runs:

* **structural axes** split partitions: ``n_agents``, ``batch_m``,
  ``horizon``, ``n_rounds``, ``gamma``, ``estimator``, ``debias``, the
  channel family, the power policy's type, the env family (its kind tag),
  the policy, noise on/off, exact vs over-the-air, ``agent_blocks`` and the
  participation structure;
* **continuous axes** batch as lanes: channel and power-control
  parameters, ``noise_sigma``, ``alpha``, env parameters, the Bernoulli
  rate, the fault deadline (realised debias) and the staleness decay.

Only the axes that vary inside a partition are packed (``_pack_partition``,
float32, the JAX package's layout); a constant axis stays the Python value
the per-scenario run uses.  Every lane is bitwise ``fedpg.run`` of its
scenario and seed (the contract of ``core/lanes.py``); every scenario uses
the Monte-Carlo seeds of ``fedpg.monte_carlo(..., seed, mc_runs)``.

Modes (``MODES``):

* ``"vmap"`` (default): each partition's scenarios x runs as one
  lane-batched run: one round per step for all of them, one K1 lane-form
  launch per stacked round on the card (``2 n_blocks + 1`` per streamed
  round, ``agent_blocks``: the streamed rounds of ``core/lanes.py``).
* ``"map"``: every (scenario, run) through ``fedpg.run``, one after another.
* ``"sharded"``: the ``"vmap"`` lanes laid across a device mesh
  (``mesh=``, from ``launch.mesh.make_sweep_mesh``; default every visible
  CUDA device on the lane axis, or ``device`` alone when given) by
  ``core/distribute.py``: each mesh cell runs its scenarios x seeds as one
  lane-batched run on its device, partitions dispatch with no host
  synchronisation and their results are gathered after the loop.  Bitwise
  ``"vmap"``.

Partitions run inside ``telemetry.trace`` spans (``partition``), which
synchronise the card, so ``Partition.wall_time_us`` covers the device work;
a sharded partition records ``dispatch`` and ``materialize`` spans, and its
wall time runs from its dispatch to its results being ready.
``telemetry`` fills ``SweepResult.history.telemetry`` with ``(S, runs, K)``
probes; telemetry off leaves every history bit unchanged.

Typical use::

    scenarios = grid(channel=[RayleighChannel(), NakagamiChannel()],
                     noise_sigma=[1e-3, 1e-2], alpha=[1e-3, 1e-4],
                     n_agents=10, batch_m=10, n_rounds=200, debias=True)
    result = sweep(LandmarkNav(), MLPPolicy(), scenarios, 0, mc_runs=20)
    print(result.to_csv())
"""
from __future__ import annotations

import dataclasses
import io
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import distribute, fedpg, lanes
from repro_torch.core.channel import Channel, channel_kind
from repro_torch.core.fedpg import FedPGConfig, History
from repro_torch.core.ota import OTAConfig
from repro_torch.core.power_control import (
    PowerPolicy, check_agent_count, effective_moments,
)
from repro_torch.launch.mesh import Mesh, make_sweep_mesh
from repro_torch.rl.envs import env_kind, robust_eq, values_vary
from repro_torch.rl.envs import check_agent_count as check_env_agent_count
from repro_torch.rl.envs import default_policy as env_default_policy
from repro_torch.service import participation as svc_part
from repro_torch.service import staleness as svc_stale
from repro_torch.service.participation import ParticipationConfig
from repro_torch.service.staleness import StalenessConfig
from repro_torch.telemetry import probes as _probes
from repro_torch.telemetry import trace as rtrace
from repro_torch.telemetry.probes import RoundTelemetry, TelemetryConfig
from repro_torch.utils.device import DeviceLike, resolve_device

MODES = ("map", "vmap", "sharded")


@dataclass(frozen=True)
class Scenario:
    """One grid point: everything one ``monte_carlo`` call needs.

    ``channel=None`` is the exact Algorithm-1 uplink.  ``debias`` divides
    the update by the effective gain mean: the channel mean without power
    control, ``E[c p(c)]`` with it (through ``OTAConfig.update_scale``, in
    double).  ``env=None`` runs the env ``sweep()`` was called with;
    ``policy=None`` resolves to ``sweep()``'s policy for those scenarios
    and to the env family's ``default_policy()`` otherwise."""

    channel: Optional[Channel] = None
    noise_sigma: float = 0.0
    alpha: float = 1e-3
    n_agents: int = 10
    batch_m: int = 10
    horizon: int = 20
    gamma: float = 0.99
    n_rounds: int = 200
    estimator: str = "gpomdp"
    power_control: Optional[PowerPolicy] = None
    debias: bool = False
    agent_blocks: Optional[int] = None
    participation: Optional[ParticipationConfig] = None
    staleness: Optional[StalenessConfig] = None
    env: Any = None
    policy: Any = None
    tag: str = ""  # free-form label carried into tables/CSV

    def fedpg_config(self) -> FedPGConfig:
        return FedPGConfig(
            n_agents=self.n_agents, batch_m=self.batch_m,
            horizon=self.horizon, gamma=self.gamma, alpha=self.alpha,
            n_rounds=self.n_rounds, estimator=self.estimator)

    def effective_moments(self) -> Tuple[float, float]:
        """The effective-gain (m_h, sigma_h^2) this scenario realises, in
        double (the pair the Theorem-1/2 bounds take)."""
        if self.channel is None:
            return 1.0, 0.0
        check_agent_count(self.channel, self.n_agents)
        if self.power_control is None:
            return float(self.channel.mean), float(self.channel.var)
        return effective_moments(self.channel, self.power_control,
                                 n_agents=self.n_agents)

    def ota_config(self) -> Optional[OTAConfig]:
        """The equivalent per-scenario OTAConfig (None for exact uplink)."""
        if self.channel is None:
            return None
        check_agent_count(self.channel, self.n_agents)
        update_scale = None
        if self.debias and self.power_control is not None:
            m_eff, _ = self.effective_moments()
            update_scale = 1.0 / (self.n_agents * m_eff)
        return OTAConfig(channel=self.channel, noise_sigma=self.noise_sigma,
                         debias=self.debias,
                         power_control=self.power_control,
                         update_scale=update_scale)

    def describe(self) -> Dict[str, Any]:
        """Flat, CSV-friendly view of the scenario."""
        chan = "exact" if self.channel is None \
            else lanes.kind_tag(self.channel, channel_kind)
        chan_params = "" if self.channel is None else ";".join(
            f"{f.name}={_fmt_param(getattr(self.channel, f.name))}"
            for f in dataclasses.fields(self.channel))
        pc = "" if self.power_control is None \
            else type(self.power_control).__name__
        pc_params = "" if self.power_control is None else ";".join(
            f"{f.name}={_fmt_param(getattr(self.power_control, f.name))}"
            for f in dataclasses.fields(self.power_control))
        env_tag = "default" if self.env is None \
            else lanes.kind_tag(self.env, env_kind)
        env_params = ""
        if self.env is not None and dataclasses.is_dataclass(self.env):
            env_params = ";".join(
                f"{f.name}={_fmt_param(getattr(self.env, f.name))}"
                for f in dataclasses.fields(self.env))
        pol = "" if self.policy is None else type(self.policy).__name__
        pp = self.participation
        part_kind = "" if pp is None else pp.kind
        part_rate: Any = ""
        if pp is not None:
            part_rate = pp.rate if pp.kind == "bernoulli" else (
                pp.subset if pp.kind == "subset" else "")
        part_debias = "" if pp is None else pp.debias
        faults = ""
        if pp is not None and pp.faults is not None:
            faults = "active" if pp.faults.active else "inactive"
        st = self.staleness
        m_eff, v_eff = self.effective_moments()
        return {
            "tag": self.tag, "channel": chan, "channel_params": chan_params,
            "noise_sigma": self.noise_sigma, "alpha": self.alpha,
            "n_agents": self.n_agents, "batch_m": self.batch_m,
            "horizon": self.horizon, "gamma": self.gamma,
            "n_rounds": self.n_rounds, "estimator": self.estimator,
            "power_control": pc, "power_control_params": pc_params,
            "debias": self.debias,
            "agent_blocks": "" if self.agent_blocks is None
            else self.agent_blocks,
            "participation": part_kind, "participation_rate": part_rate,
            "participation_debias": part_debias, "faults": faults,
            "staleness_max_age": "" if st is None else st.max_age,
            "staleness_decay": "" if st is None else st.decay,
            "env": env_tag, "env_params": env_params,
            "policy": pol, "m_h_eff": m_eff, "sigma_h2_eff": v_eff,
        }


def _fmt_param(v: Any) -> str:
    """Compact field rendering for describe(): numbers as %g, nested
    dataclasses as their type, tensors and arrays as their shape."""
    if isinstance(v, (int, float)):
        return f"{v:g}"
    if dataclasses.is_dataclass(v):
        return type(v).__name__
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return f"array{tuple(v.shape)}"
    if isinstance(v, dict):
        return "{" + " ".join(sorted(v)) + "}"
    return str(v)


def resolve_env_policy(scenario: Scenario, env: Any = None,
                       policy: Any = None):
    """The (env, policy) a scenario runs: scenario fields override the
    sweep's defaults; a scenario env with no policy takes the registry's
    ``default_policy``."""
    e = scenario.env if scenario.env is not None else env
    if e is None:
        raise ValueError(
            "scenario has no env: set Scenario.env or pass sweep(env=...)")
    if scenario.policy is not None:
        p = scenario.policy
    elif scenario.env is None and policy is not None:
        p = policy
    else:
        p = env_default_policy(e)
    check_env_agent_count(e, scenario.n_agents)
    return e, p


def grid(**axes) -> List[Scenario]:
    """Cartesian product of scenario axes: a list/tuple value is an axis, a
    scalar a fixed setting; the last axis varies fastest."""
    valid = {f.name for f in dataclasses.fields(Scenario)}
    unknown = set(axes) - valid
    if unknown:
        raise ValueError(f"unknown scenario axes {sorted(unknown)}; "
                         f"choose from {sorted(valid)}")
    names = list(axes)
    values = [v if isinstance(v, (list, tuple)) else [v]
              for v in axes.values()]
    return [Scenario(**dict(zip(names, combo)))
            for combo in itertools.product(*values)]


# ---------------------------------------------------------------------------
# Partitioning by structure.
# ---------------------------------------------------------------------------

def _policy_tag(s: Scenario):
    """The policy is structural outright; unhashable policies split by
    identity."""
    if s.policy is None:
        return None
    try:
        hash(s.policy)
        return s.policy
    except TypeError:
        return (type(s.policy).__name__, id(s.policy))


def _structure_key(s: Scenario) -> Tuple:
    """Everything that changes the shape or the ops of a round: the run's
    sizes, estimator and ``agent_blocks``, the lane settings' structure
    (``lanes.structure_key``, the key ``run_lanes`` holds its lanes to)
    and the policy."""
    return (s.n_agents, s.batch_m, s.horizon, s.gamma, s.n_rounds,
            s.estimator, s.agent_blocks,
            lanes.structure_key(_lane_spec(s, 0, s.env)), _policy_tag(s))


@dataclass
class Partition:
    """A structurally uniform slice of the grid, run as one batched run."""

    indices: List[int]           # positions in the original scenario list
    scenarios: List[Scenario]
    key: Tuple = ()
    wall_time_us: float = 0.0    # filled in by sweep()

    @property
    def proto(self) -> Scenario:
        return self.scenarios[0]

    def varying(self, name: str) -> bool:
        return values_vary([getattr(s, name) for s in self.scenarios])


def partition_scenarios(scenarios: Sequence[Scenario]) -> List[Partition]:
    groups: Dict[Tuple, Partition] = {}
    for i, s in enumerate(scenarios):
        k = _structure_key(s)
        part = groups.setdefault(k, Partition(indices=[], scenarios=[], key=k))
        part.indices.append(i)
        part.scenarios.append(s)
    return list(groups.values())


def _norm_const64(s: Scenario) -> float:
    """The per-scenario debias normaliser in double: the effective gain
    mean under power control, the channel mean otherwise."""
    if not s.debias:
        return 1.0
    return s.effective_moments()[0]


def _lane_spec(s: Scenario, seed: int, env=None) -> lanes.LaneSpec:
    part = svc_part.normalize(s.participation, s.n_agents)
    return lanes.LaneSpec(
        seed=seed, alpha=s.alpha, ota=s.ota_config(), env=env,
        participation=part, staleness=svc_stale.normalize(s.staleness, part))


def _pack_partition(part: Partition) -> Dict[str, Any]:
    """The axes that vary inside ``part``, one float32 value per scenario
    (numpy; the JAX package's layout): constant axes are left out, so
    the lanes use the Python value the per-scenario run uses."""
    specs = [_lane_spec(s, 0, s.env) for s in part.scenarios]
    return lanes.pack_lanes(specs, part.proto.n_agents)


def _lane_scenarios(part: Partition) -> Tuple[List[Scenario], bool]:
    """The scenarios a partition's lanes run, and whether it is the
    replicate path: scenarios that pack to nothing run the prototype's
    lanes alone, and every scenario takes its history."""
    replicate = not _pack_partition(part)
    return (part.scenarios[:1] if replicate else part.scenarios), replicate


# partitions' lane programs made in this process (``_make_lane``, behind
# ``sweep`` and ``lane_program``; analyze's build-budget reads it)
LANE_PROGRAMS = 0


def _make_lane(env, policy, part: Partition,
               telemetry: Optional[TelemetryConfig] = None, *,
               ota_backend: str = "auto"):
    """``lane(scenarios, seeds, device) -> History`` of ``(S, runs, K)``
    leaves: the partition's ``scenarios`` times ``seeds`` as one
    lane-batched run on ``device`` (streamed in the partition's
    ``agent_blocks``)."""
    global LANE_PROGRAMS
    LANE_PROGRAMS += 1
    proto = part.proto
    lane_env, lane_policy = resolve_env_policy(proto, env, policy)
    cfg = proto.fedpg_config()

    def lane(scens: Sequence[Scenario], seeds: Sequence[int],
             device) -> History:
        specs = [_lane_spec(s, r, resolve_env_policy(s, env, policy)[0])
                 for s in scens for r in seeds]
        _, hist = lanes.run_lanes(lane_env, lane_policy, cfg, specs,
                                  telemetry=telemetry,
                                  ota_backend=ota_backend,
                                  agent_blocks=proto.agent_blocks,
                                  device=device)

        def shape(x):
            return x.reshape((len(scens), len(seeds)) + tuple(x.shape[1:]))

        tel = None if hist.telemetry is None else RoundTelemetry(
            *(None if x is None else shape(x) for x in hist.telemetry))
        return History(*(shape(x) for x in hist), telemetry=tel)

    return lane


def _part_telemetry(part: Partition, telemetry: Optional[TelemetryConfig]):
    return _probes.active(telemetry, svc_part.normalize(
        part.proto.participation, part.proto.n_agents))


def lane_program(env, policy, part: Partition, mc_runs: int = 2,
                 telemetry: Optional[TelemetryConfig] = None, *,
                 seed: int = 0, device: DeviceLike = None):
    """The partition's batched run, exposed for inspection: ``(packed, fn,
    seeds)`` with ``fn(seeds)`` what ``sweep(mode="vmap")`` runs for this
    partition (a History of ``(S, runs, K)`` leaves) and ``packed`` the
    lane axes it batches (only the ones that vary)."""
    lane = _make_lane(env, policy, part, _part_telemetry(part, telemetry))
    scens, replicate = _lane_scenarios(part)
    dev = resolve_device(device)

    def fn(seeds: Sequence[int]) -> History:
        h = lane(scens, seeds, dev)
        if not replicate:
            return h

        def expand(x):
            return x.expand((len(part.scenarios),) + tuple(x.shape[1:]))

        tel = None if h.telemetry is None else RoundTelemetry(
            *(None if x is None else expand(x) for x in h.telemetry))
        return History(*(expand(x) for x in h), telemetry=tel)

    return _pack_partition(part), fn, fedpg.run_seeds(seed, mc_runs)


# ---------------------------------------------------------------------------
# Results.
# ---------------------------------------------------------------------------

@dataclass
class SweepResult:
    """Histories for every scenario, plus grid/partition bookkeeping.

    ``history`` fields are numpy arrays of shape ``(n_scenarios, mc_runs,
    n_rounds)`` in the original scenario order (a 1-D object array of
    ``(mc_runs, K_i)`` arrays when the grid varies ``n_rounds``).
    ``mode`` and ``n_devices`` record how the partitions ran (``n_devices``
    is the mesh's size under ``"sharded"``, else 1)."""

    scenarios: List[Scenario]
    history: History
    partitions: List[Partition] = field(default_factory=list)
    mc_runs: int = 0
    mode: str = "vmap"
    n_devices: int = 1

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    def scenario_time_us(self, i: int) -> float:
        """Per-(scenario, run) share of the owning partition's wall time
        (under ``"sharded"`` from dispatch to ready, which for a later
        partition includes waiting on earlier ones)."""
        for part in self.partitions:
            if i in part.indices:
                return part.wall_time_us / (len(part.indices)
                                            * max(self.mc_runs, 1))
        raise IndexError(f"scenario {i} not in any partition")

    def __len__(self) -> int:
        return len(self.scenarios)

    def scenario_history(self, i: int) -> History:
        return self.history.lane(i)

    def telemetry_summary(self, i: int) -> Optional[Dict[str, Any]]:
        """NaN-aware mean of each probe of scenario ``i``; None when the
        sweep ran without telemetry."""
        return _probes.summarize(_probes.index(self.history.telemetry, i))

    def final_reward(self, i: int, tail: int = 20) -> float:
        """Mean reward over the last ``tail`` rounds and every run (float32,
        as the JAX package's ``jnp.mean``)."""
        r = np.asarray(self.history.rewards[i], np.float32)
        return float(np.mean(r[:, -tail:], dtype=np.float32))

    def avg_grad_sq(self, i: int) -> float:
        """(1/K) sum_k ||grad J||^2, averaged over the runs (Fig. 2/5)."""
        g = np.asarray(self.history.grad_sq[i], np.float32)
        return float(np.mean(g, dtype=np.float32))

    def index(self, **fields) -> int:
        """Position of the first scenario matching all given field values
        (``env=`` by identity first, then equality)."""
        for i, s in enumerate(self.scenarios):
            if all(robust_eq(getattr(s, k), v) for k, v in fields.items()):
                return i
        raise KeyError(f"no scenario matches {fields}")

    def to_dicts(self, tail: int = 20) -> List[Dict[str, Any]]:
        rows = []
        for i, s in enumerate(self.scenarios):
            row = {"index": i, **s.describe()}
            row["final_reward"] = self.final_reward(i, tail)
            row["avg_grad_sq"] = self.avg_grad_sq(i)
            row["mean_gain"] = float(np.mean(np.asarray(
                self.history.gain_mean[i])))
            tel = self.telemetry_summary(i)
            if tel is not None:
                for k, v in tel.items():
                    row[f"telemetry_{k}"] = v
            rows.append(row)
        return rows

    def to_csv(self, path: Optional[str] = None, tail: int = 20) -> str:
        rows = self.to_dicts(tail)
        buf = io.StringIO()
        cols = list(rows[0]) if rows else []
        buf.write(",".join(cols) + "\n")
        for row in rows:
            buf.write(",".join(_csv_cell(row[c]) for c in cols) + "\n")
        text = buf.getvalue()
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


def _csv_cell(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    s = str(v)
    if any(c in s for c in ',"\n\r'):  # RFC-4180 quoting
        return '"' + s.replace('"', '""') + '"'
    return s


def _stack_histories(arrs: List[np.ndarray]) -> np.ndarray:
    """Stack per-scenario arrays; ragged round counts fall back to a 1-D
    object array so ``history.x[i]`` indexing keeps working."""
    if len({a.shape for a in arrs}) == 1:
        return np.stack(arrs)
    out = np.empty(len(arrs), dtype=object)
    for i, a in enumerate(arrs):
        out[i] = a
    return out


def _to_numpy(h: History) -> History:
    def cpu(x):
        return None if x is None else x.detach().cpu().numpy()

    tel = None if h.telemetry is None else RoundTelemetry(
        *(cpu(x) for x in h.telemetry))
    return History(*(cpu(x) for x in h), telemetry=tel)


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

def sweep(env, policy, scenarios: Sequence[Scenario], seed: int,
          mc_runs: int, *, mode: str = "vmap", mesh: Optional[Mesh] = None,
          telemetry: Optional[TelemetryConfig] = None,
          ota_backend: str = "auto",
          device: DeviceLike = None) -> SweepResult:
    """Run every scenario x ``mc_runs``, one batched run per partition
    (module docstring).  Every scenario uses the seeds
    ``fedpg.run_seeds(seed, mc_runs)``, those of ``fedpg.monte_carlo(...,
    seed, mc_runs)``.  ``env``/``policy`` are the defaults of scenarios
    that carry none.  ``device=None`` means ``cuda`` and raises without a
    GPU; ``mode="sharded"`` runs on ``mesh`` (``device`` alone when it is
    given instead, every visible CUDA device when neither is)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    sharded = mode == "sharded"
    if mesh is not None and not sharded:
        raise ValueError("mesh= is only meaningful with mode='sharded'")
    if mesh is not None and device is not None:
        raise ValueError("pass mesh= or device=, not both")
    scenarios = list(scenarios)
    if not scenarios:
        raise ValueError("empty scenario list")
    seeds = fedpg.run_seeds(seed, mc_runs)
    parts = partition_scenarios(scenarios)
    n_devices, dev = 1, None
    if sharded:
        if mesh is None:
            mesh = (distribute.default_sweep_mesh() if device is None else
                    make_sweep_mesh(devices=[resolve_device(device)]))
        n_devices = mesh.size
    else:
        dev = resolve_device(device)
    out: List[Optional[History]] = [None] * len(scenarios)

    def collect(part: Partition, stacked: History, replicate: bool) -> None:
        for j, idx in enumerate(part.indices):
            out[idx] = stacked.lane(0 if replicate else j)

    pending = []
    for part in parts:
        if mode == "map":
            with rtrace.span("partition", mode=mode,
                             scenarios=len(part.indices), device=dev) as sp:
                per = [_map_scenario(env, policy, s, seeds, telemetry,
                                     ota_backend, dev)
                       for s in part.scenarios]
            part.wall_time_us = sp.duration_us
            for j, idx in enumerate(part.indices):
                out[idx] = per[j]
            continue
        lane = _make_lane(env, policy, part, _part_telemetry(part, telemetry),
                          ota_backend=ota_backend)
        scens, replicate = _lane_scenarios(part)
        if sharded:   # launched now, gathered after the loop
            t0 = rtrace.now_us()
            outs, placement = distribute.dispatch_partition(
                lane, scens, seeds, mesh, replicate=replicate)
            pending.append((part, t0, outs, placement, replicate))
            continue
        with rtrace.span("partition", mode=mode, scenarios=len(part.indices),
                         device=dev) as sp:
            stacked = _to_numpy(lane(scens, seeds, dev))
        part.wall_time_us = sp.duration_us
        collect(part, stacked, replicate)
    for part, t0, outs, placement, replicate in pending:
        with rtrace.span("materialize", scenarios=len(part.indices)):
            stacked = _to_numpy(distribute.gather(outs, placement))
        part.wall_time_us = rtrace.now_us() - t0
        collect(part, stacked, replicate)

    def stack_field(f: int):
        return _stack_histories([h[f] for h in out])

    tel = None
    if out[0].telemetry is not None:
        tel = RoundTelemetry(*(
            None if any(h.telemetry is None or getattr(h.telemetry, f) is None
                        for h in out)
            else _stack_histories([getattr(h.telemetry, f) for h in out])
            for f in RoundTelemetry._fields))
    history = History(stack_field(0), stack_field(1), stack_field(2),
                      telemetry=tel)
    return SweepResult(scenarios=scenarios, history=history,
                       partitions=parts, mc_runs=mc_runs, mode=mode,
                       n_devices=n_devices)


def _map_scenario(env, policy, s: Scenario, seeds: Sequence[int],
                  telemetry, ota_backend: str, dev) -> History:
    """One scenario's runs through ``fedpg.run``, one after another."""
    e, p = resolve_env_policy(s, env, policy)
    hists = [fedpg.run(e, p, s.fedpg_config(), r, ota=s.ota_config(),
                       ota_backend=ota_backend, agent_blocks=s.agent_blocks,
                       participation=s.participation, staleness=s.staleness,
                       telemetry=telemetry, device=dev)[1] for r in seeds]
    tel = None
    if hists[0].telemetry is not None:
        tel = _probes.stack([h.telemetry for h in hists], 0)
    return _to_numpy(History(*(torch.stack(x) for x in zip(*hists)),
                             telemetry=tel))
