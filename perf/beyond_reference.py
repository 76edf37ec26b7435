#!/usr/bin/env python3
"""The reference half of the benchmarks beyond the paper: power control,
the environment zoo and partial participation at N = 10^4, run by the JAX
package on a CPU.

Runs each benchmark's own setting, functions and seeds with 20 Monte-Carlo
runs (the benchmarks run 1-3) and writes three files that
``chip_smoke.py`` reads (it imports no JAX itself):

* ``perf/power_control_reference.json`` — ``benchmarks.fig_power_control.
  run`` (seed 1, N=8 M=4 K=120 on ``TabularMDP.random(jax.random.key(0),
  3, 2, gamma=0.9, horizon=3)``, whose ``P``, ``l``, ``rho`` the file
  holds): per policy row each run's ``avg_grad_sq``, the effective moments,
  the applicable theorem, its bound and floor, ``holds``; the benchmark's
  ``floor_moves`` claim and its sweep's ``n_partitions``;
* ``perf/env_zoo_reference.json`` — ``benchmarks.fig_env_zoo.run``
  (``jax.random.key(1)``, N=4 M=4 T=10 K=120): per scenario (seven
  families under the exact and the Rayleigh uplink, three wind lanes) each
  run's ``avg_grad_sq`` and last-10-round reward, the partition it ran in,
  ``n_partitions`` and the claim ``partitions < scenarios``, the garnet's
  ``P``, ``l``, ``rho`` (``garnet(jax.random.key(0), 6, 3, 2)``) and the
  l_bar threading row;
* ``perf/participation_reference.json`` — ``benchmarks/
  fig_participation.py``'s lines 50-120 with ``mc_runs`` 20 in place of 1
  (``jax.random.key(7)``, N = 10^4 in blocks of 64, M=1 T=3 K=5): per
  (rate, staleness) lane each run's ``avg_grad_sq``, realised
  participation rate, drift and mean replayed age (the NaN-aware mean of
  each run's rounds, as ``telemetry_summary`` takes them over all runs),
  the full-participation baseline's runs, each sweep's ``n_partitions``,
  and the round-service driver run's commit records (rate 0.5, exp(1)
  stragglers closed at deadline 2, staleness (4, 0.8), 8 rounds).

Each file also records the setting, the runs, the jax version, the
platform and the seconds taken.  Run from the root of a checkout:

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python3 perf/beyond_reference.py \\
        [power_control env_zoo participation]
"""
from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "perf")]

import jax  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import (  # noqa: E402
    fig_env_zoo, fig_participation, fig_power_control,
)
from figures_reference import captured, derived, header, mean_se  # noqa: E402
from repro.core import fedpg, theory  # noqa: E402
from repro.core.channel import RayleighChannel  # noqa: E402
from repro.core.ota import OTAConfig  # noqa: E402
from repro.core.sweep import grid, sweep  # noqa: E402
from repro.rl.envs import make_env  # noqa: E402
from repro.service.driver import RoundService, ServiceConfig  # noqa: E402
from repro.service.faults import FaultConfig, StragglerModel  # noqa: E402
from repro.service.participation import ParticipationConfig  # noqa: E402
from repro.service.staleness import StalenessConfig  # noqa: E402
from repro.telemetry.probes import TelemetryConfig  # noqa: E402

RUNS = 20
POWER = dict(n_rounds=120, seed=1, n_agents=fig_power_control.N_AGENTS,
             batch_m=fig_power_control.BATCH_M, noise_sigma=1e-3,
             noise_sigma2=1e-6, mdp_key=0, n_states=3, n_actions=2,
             gamma=0.9, horizon=3, G=math.sqrt(2.0), F=0.5, l_bar=1.0)
ZOO = dict(n_rounds=120, seed=1, n_agents=fig_env_zoo.N_AGENTS,
           batch_m=fig_env_zoo.BATCH_M, horizon=fig_env_zoo.HORIZON,
           alpha=1e-3, noise_sigma=1e-3, final_reward_tail=10,
           garnet_key=0, garnet=[6, 3, 2])
PART = dict(n_rounds=5, seed=7, n_agents=fig_participation.N_AGENTS,
            agent_blocks=fig_participation.AGENT_BLOCKS,
            rates=list(fig_participation.RATES), batch_m=1, horizon=3,
            noise_sigma=1e-3, stale_max_age=4, stale_decay=0.8,
            driver_rate=0.5, driver_deadline=2.0, driver_rounds=8,
            driver_rounds_per_commit=2)
OUT = ROOT / "perf"


def plain(x):
    """numpy scalars in the driver's records as JSON numbers."""
    return x.item() if hasattr(x, "item") else str(x)


def write(name, out):
    path = OUT / name
    path.write_text(json.dumps(out, indent=1, default=plain) + "\n")
    print(f"wrote {path.relative_to(ROOT)} in {out['seconds']:.1f} s",
          flush=True)


def per_run(res, i, tail):
    """Scenario ``i``'s per-run avg_grad_sq and last-``tail`` reward, with
    their means and standard errors."""
    g = np.asarray(res.history.grad_sq[i], np.float64).mean(axis=1)
    r = np.asarray(res.history.rewards[i], np.float64)[:, -tail:].mean(
        axis=1)
    gm, gse = mean_se(g)
    rm, rse = mean_se(r)
    return {"avg_grad_sq": gm, "avg_grad_sq_se": gse, "final_reward": rm,
            "final_reward_se": rse, "per_run_avg_grad_sq": g.tolist(),
            "per_run_final_reward": r.tolist(),
            "sweep_avg_grad_sq": res.avg_grad_sq(i),
            "sweep_final_reward": res.final_reward(i, tail=tail)}


def partition_of(res, i):
    return next(j for j, p in enumerate(res.partitions) if i in p.indices)


def arrays(mdp):
    return {k: np.asarray(getattr(mdp, k), np.float64).tolist()
            for k in ("P", "l", "rho")}


def jax_tabular_mdp():
    from repro.rl.env import TabularMDP

    s = POWER
    return TabularMDP.random(jax.random.key(s["mdp_key"]),
                             n_states=s["n_states"], n_actions=s["n_actions"],
                             gamma=s["gamma"], horizon=s["horizon"])


def power_control():
    """``fig_power_control.run(n_rounds=120, mc_runs=20)``, its sweep
    captured, its closed-form columns recomputed at full precision."""
    t0 = time.perf_counter()
    s = POWER
    sweeps = captured(fig_power_control, "run_sweep")
    floors = fig_power_control.run(n_rounds=s["n_rounds"], mc_runs=RUNS)
    res = sweeps[0]
    consts = theory.MDPConstants(G=s["G"], F=s["F"], l_bar=s["l_bar"],
                                 gamma=s["gamma"])
    V, delta_j = consts.V(), 1.0 / (1 - s["gamma"])
    mdp = jax_tabular_mdp()
    rows = []
    for i, sc in enumerate(res.scenarios):
        m_h, v_h = sc.effective_moments()
        which, bound = theory.applicable_bound(
            K=s["n_rounds"], n_agents=s["n_agents"], batch_m=s["batch_m"],
            alpha=sc.alpha, m_h=m_h, sigma_h2=v_h,
            noise_sigma2=s["noise_sigma2"], delta_J=delta_j, V=V)
        floor = (theory.theorem1_floor if which == "theorem1"
                 else theory.theorem2_floor)(
            n_agents=s["n_agents"], batch_m=s["batch_m"], m_h=m_h,
            sigma_h2=v_h, noise_sigma2=s["noise_sigma2"], V=V)
        if floor != floors[sc.tag]:
            raise SystemExit(f"{sc.tag}: floor {floor} against the "
                             f"benchmark's {floors[sc.tag]}")
        row = {"tag": sc.tag, "alpha": sc.alpha, "m_h_eff": m_h,
               "sigma_h2_eff": v_h, "which": which, "bound": bound,
               "floor": floor, "partition": partition_of(res, i),
               **per_run(res, i, 20)}
        row["holds"] = derived(f"fig_pc_{sc.tag}")["holds"] == "True"
        rows.append(row)
        print(f"{sc.tag:15s} avg_grad_sq {row['avg_grad_sq']:.4f} +- "
              f"{row['avg_grad_sq_se']:.4f} {which} bound {bound:.4f} "
              f"floor {floor:.5f} holds {row['holds']}", flush=True)
    moves = derived("fig_pc_floor_moves")["pass"] == "True"
    out = header({"benchmark": "benchmarks/fig_power_control.py",
                  "runs": RUNS, "V": V, "delta_J": delta_j, "mode": res.mode,
                  **s}, t0)
    out.update(rows=rows, floor_moves=moves, n_partitions=res.n_partitions,
               mdp=arrays(mdp))
    write("power_control_reference.json", out)


def env_zoo():
    """``fig_env_zoo.run(n_rounds=120, mc_runs=20)``."""
    t0 = time.perf_counter()
    s = ZOO
    res = fig_env_zoo.run(n_rounds=s["n_rounds"], mc_runs=RUNS)
    rows = []
    for i, sc in enumerate(res.scenarios):
        d = sc.describe()
        row = {"tag": sc.tag, "env": d["env"], "channel": d["channel"],
               "partition": partition_of(res, i),
               **per_run(res, i, s["final_reward_tail"])}
        rows.append(row)
        print(f"{sc.tag:22s} final reward {row['final_reward']:.4f} +- "
              f"{row['final_reward_se']:.4f} avg_grad_sq "
              f"{row['avg_grad_sq']:.4g} +- {row['avg_grad_sq_se']:.2g}",
              flush=True)
    lbar = derived("fig_env_lbar_threading")
    env = fig_env_zoo.LandmarkNav()
    consts = theory.constants_for_env(env, horizon=s["horizon"], gamma=0.99,
                                      G=math.sqrt(2.0), F=0.5)
    garnet = next(sc.env for sc in res.scenarios
                  if sc.tag == "garnet_exact")
    out = header({"benchmark": "benchmarks/fig_env_zoo.py", "runs": RUNS,
                  "mode": res.mode, **s}, t0)
    out.update(
        rows=rows, n_partitions=res.n_partitions,
        n_scenarios=len(res.scenarios),
        partitions_fewer=derived("fig_env_zoo_compiles")["pass"] == "True",
        lbar={"l_bar_T10": consts.l_bar, "l_bar_T20": env.l_bar,
              "V": consts.V(), "pass": lbar["pass"] == "True"},
        garnet=arrays(garnet))
    write("env_zoo_reference.json", out)


def run_means(tel, i, name):
    """Each run's NaN-aware mean of probe ``name`` over its rounds (None
    where the sweep carries no such field)."""
    arr = getattr(tel, name)
    if arr is None:
        return None
    a = np.asarray(arr[i], np.float64)
    return [float(np.mean(x[np.isfinite(x)])) if np.isfinite(x).any()
            else None for x in a]


def participation():
    """``fig_participation.run()``'s body with ``mc_runs`` 20: the two
    rate sweeps, the baseline and the driver run."""
    t0 = time.perf_counter()
    s = PART
    env = make_env("landmark")
    policy = env.default_policy()
    ota_cfg = OTAConfig(channel=RayleighChannel(), noise_sigma=1e-3,
                        debias=True)
    key = jax.random.key(s["seed"])
    common = dict(channel=[RayleighChannel()], noise_sigma=1e-3, debias=True,
                  n_agents=s["n_agents"], batch_m=1, horizon=3,
                  n_rounds=s["n_rounds"], agent_blocks=s["agent_blocks"])
    sweeps = []
    for stale in fig_participation.STALE:
        t1 = time.perf_counter()
        scens = grid(staleness=stale,
                     participation=[ParticipationConfig(rate=r)
                                    for r in fig_participation.RATES],
                     **common)
        res = sweep(env, policy, scens, key, mc_runs=RUNS,
                    telemetry=TelemetryConfig())
        rows = []
        for i, sc in enumerate(res.scenarios):
            tel = res.telemetry_summary(i) or {}
            rows.append({
                "rate": sc.participation.rate,
                "max_age": 0 if stale is None else stale.max_age,
                **per_run(res, i, 20),
                "per_run_participation_rate": run_means(
                    res.history.telemetry, i, "participation_rate"),
                "per_run_participation_drift": run_means(
                    res.history.telemetry, i, "participation_drift"),
                "per_run_staleness_mean": run_means(
                    res.history.telemetry, i, "staleness_mean"),
                "participation_rate": tel.get("participation_rate"),
                "participation_drift": tel.get("participation_drift"),
                "staleness_mean": tel.get("staleness_mean")})
            print(f"rate {sc.participation.rate:g} stale "
                  f"{rows[-1]['max_age']}: avg_grad_sq "
                  f"{rows[-1]['avg_grad_sq']:.4g} part_rate "
                  f"{rows[-1]['participation_rate']:.5f} drift "
                  f"{rows[-1]['participation_drift']:.3g} stale_mean "
                  f"{rows[-1]['staleness_mean']}", flush=True)
        sweeps.append({"staleness": None if stale is None else
                       [stale.max_age, stale.decay],
                       "n_partitions": res.n_partitions, "rows": rows,
                       "seconds": time.perf_counter() - t1})
    t1 = time.perf_counter()
    base = grid(participation=[ParticipationConfig(kind="full")], **common)
    bres = sweep(env, policy, base, key, mc_runs=RUNS,
                 telemetry=TelemetryConfig())
    baseline = {"n_partitions": bres.n_partitions, **per_run(bres, 0, 20),
                "seconds": time.perf_counter() - t1}
    print(f"baseline avg_grad_sq {baseline['avg_grad_sq']:.4g}", flush=True)

    t1 = time.perf_counter()
    p = ParticipationConfig(rate=s["driver_rate"], faults=FaultConfig(
        stragglers=StragglerModel(dist="exp", mean=1.0),
        deadline=s["driver_deadline"]))
    cfg = fedpg.FedPGConfig(n_agents=s["n_agents"], batch_m=1, horizon=3,
                            n_rounds=1)
    svc = RoundService(
        env, policy, cfg, key, participation=p,
        staleness=StalenessConfig(max_age=4, decay=0.8), ota=ota_cfg,
        telemetry=TelemetryConfig(), agent_blocks=s["agent_blocks"],
        service=ServiceConfig(rounds_per_commit=s["driver_rounds_per_commit"],
                              max_rounds=s["driver_rounds"],
                              round_deadline_s=600.0))
    records = svc.run()
    driver = {"records": records, "last": records[-1],
              "seconds": time.perf_counter() - t1}
    print(f"driver: {len(records)} commits, last {records[-1]}", flush=True)
    out = header({"benchmark": "benchmarks/fig_participation.py",
                  "runs": RUNS, **s}, t0)
    out.update(sweeps=sweeps, baseline=baseline, driver=driver)
    write("participation_reference.json", out)


def main() -> int:
    t0 = time.perf_counter()
    todo = {"power_control": power_control, "env_zoo": env_zoo,
            "participation": participation}
    for name in (sys.argv[1:] or list(todo)):
        todo[name]()
    print(f"all in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
