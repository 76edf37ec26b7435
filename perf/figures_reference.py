#!/usr/bin/env python3
"""The reference half of the Fig. 3, Figs. 4-5, event-triggered and Theorem
1/2 acceptances: the JAX package on a CPU.

Runs the benchmarks' own settings, functions and seeds and writes four
files that ``chip_smoke.py`` reads (it imports no JAX itself):

* ``perf/fig3_reference.json`` — ``benchmarks.fig3_vs_vanilla.run`` (seed
  1, N=10 M=10 K=250 alpha 1e-3) with 20 Monte-Carlo runs: per scenario
  (``ota``, ``vanilla``) each run's ``avg_grad_sq`` ((1/K) sum_k ||grad
  J||^2) and last-20-round reward, their means and standard errors, and
  the benchmark's ``iters_to_90pct`` and ``same_order``;
* ``perf/fig45_reference.json`` — ``benchmarks.fig45_nakagami.run`` (seed
  2, N=10 K=250 alpha 1e-3, 20 runs): the four (channel, M) scenarios the
  same way, the benchmark's Fig. 4 and Fig. 5 claims, and the Lemma-3
  aggregation-error floor of ``aggregation_error_floor`` with each of its
  400 draws (a copy of the function's body that keeps them; its means are
  checked equal to the function's own), at the policy
  ``MLPPolicy().init(jax.random.key(0))``, whose weights the file holds;
* ``perf/et_reference.json`` — ``benchmarks/et_baseline.py``'s setting
  (N=20 M=5 K=200 alpha 3e-3): the OTA run and the event-triggered runs at
  tau 0.01 and 0.1 from ``jax.random.key(0)`` .. ``key(19)``, one after
  another (``event_triggered.run_jit`` has no lane form): each run's
  last-20 reward, its mean uploads a round and whether every agent
  uploaded every round;
* ``perf/theory_reference.json`` — ``benchmarks/theory_table.py``'s table
  (lines 23-66) at K=150 with 20 runs from ``key(1)``: the tabular MDP's
  ``P``, ``l``, ``rho``, and for each channel row the per-run
  ``avg_grad_sq``, its mean and standard error, alpha, the bound and
  whether it holds.

Each file also records the setting, the jax version, the platform and the
seconds taken.  Run from the root of a checkout (about 3 minutes on 8 CPU
cores):

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python3 perf/figures_reference.py
"""
from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import common, fig3_vs_vanilla, fig45_nakagami  # noqa: E402
from repro.configs.ota_pg_particle import NAKAGAMI, RAYLEIGH  # noqa: E402
from repro.core import fedpg, theory  # noqa: E402
from repro.core.channel import (  # noqa: E402
    NakagamiChannel, RayleighChannel, make_channel,
)
from repro.core.event_triggered import ETConfig, run_jit as et_run  # noqa: E402
from repro.core.ota import OTAConfig  # noqa: E402
from repro.core.power_control import (  # noqa: E402
    TruncatedInversion, make_controlled_channel,
)
from repro.core.sweep import Scenario, sweep  # noqa: E402
from repro.rl.env import LandmarkNav, TabularMDP  # noqa: E402
from repro.rl.policy import MLPPolicy, TabularSoftmaxPolicy  # noqa: E402

RUNS, TAIL = 20, 20
FIG3 = dict(n_rounds=250, n_agents=10, batch_m=10, alpha=1e-3, seed=1)
FIG45 = dict(n_rounds=250, n_agents=10, alpha=1e-3, seed=2, n_draws=400,
             floor_seed=3, ref_seed=9, ref_batches=8, ref_batch=4096)
ET = dict(n_rounds=200, n_agents=20, batch_m=5, alpha=3e-3,
          taus=[0.01, 0.1], keys=list(range(RUNS)))
THEORY = dict(n_rounds=150, seed=1, n_agents=8, batch_m=4, noise_sigma=1e-3,
              noise_sigma2=1e-6, mdp_key=0, n_states=3, n_actions=2,
              gamma=0.9, horizon=3, G=math.sqrt(2.0), F=0.5, l_bar=1.0)
OUT = ROOT / "perf"


def mean_se(x):
    x = np.asarray(x, np.float64)
    return float(x.mean()), float(x.std(ddof=1) / math.sqrt(x.size))


def run_rows(res, i):
    """Scenario ``i``'s per-run avg_grad_sq and last-20 reward, with their
    means and standard errors over the runs."""
    g = np.asarray(res.history.grad_sq[i], np.float64).mean(axis=1)
    r = np.asarray(res.history.rewards[i], np.float64)[:, -TAIL:].mean(axis=1)
    gm, gse = mean_se(g)
    rm, rse = mean_se(r)
    return {"avg_grad_sq": gm, "avg_grad_sq_se": gse, "final_reward": rm,
            "final_reward_se": rse, "per_run_avg_grad_sq": g.tolist(),
            "per_run_final_reward": r.tolist(),
            "sweep_avg_grad_sq": res.avg_grad_sq(i),
            "sweep_final_reward": res.final_reward(i)}


def header(setting, t0):
    return {"setting": setting, "jax_version": jax.__version__,
            "platform": jax.devices()[0].platform,
            "seconds": time.perf_counter() - t0}


def write(name, out):
    path = OUT / name
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path.relative_to(ROOT)} in {out['seconds']:.1f} s",
          flush=True)


def captured(module, name):
    """Wrap ``module.name`` so the benchmark's own call leaves its result
    in the returned list."""
    fn, seen = getattr(module, name), []

    def wrapper(*a, **k):
        out = fn(*a, **k)
        seen.append(out)
        return out

    setattr(module, name, wrapper)
    return seen


def derived(name):
    """The ``derived`` field of the benchmark row ``name`` as a dict."""
    row = next(r for r in common.ROWS if r["name"] == name)
    return dict(kv.split("=", 1) for kv in row["derived"].split(";"))


def fig3():
    t0 = time.perf_counter()
    sweeps = captured(fig3_vs_vanilla, "run_sweep")
    got = fig3_vs_vanilla.run(mc_runs=RUNS, n_rounds=FIG3["n_rounds"],
                              n_agents=FIG3["n_agents"],
                              batch_m=FIG3["batch_m"], alpha=FIG3["alpha"])
    res = sweeps[0]
    rows = [{"tag": s.tag, **run_rows(res, i)}
            for i, s in enumerate(res.scenarios)]
    claim = derived("fig3_same_order_convergence")
    out = header({"scenarios": "benchmarks.fig3_vs_vanilla.scenarios",
                  "runs": RUNS, "final_reward_tail": TAIL, "mode": res.mode,
                  **FIG3}, t0)
    out.update(rows=rows,
               iters_to_90pct={k: int(v[1]) for k, v in got.items()},
               same_order=claim["pass"] == "True")
    write("fig3_reference.json", out)


def floor_draws(theta, n_agents, n_draws):
    """``fig45_nakagami.aggregation_error_floor``'s body (lines 90-129),
    keeping each draw's squared error instead of only their mean."""
    from repro.core import gpomdp, ota
    from repro.rl.sampler import rollout_batch
    from repro.utils.tree import tree_global_norm_sq, tree_sub

    env, pol = LandmarkNav(), MLPPolicy()

    @jax.jit
    def big_grad(k):
        traj = rollout_batch(env, pol, theta, k, 20, 4096)
        return gpomdp.gpomdp_gradient(pol, theta, traj, 0.99)

    refs = jax.vmap(big_grad)(jax.random.split(jax.random.key(9), 8))
    g_ref = jax.tree.map(lambda x: jnp.mean(x, 0), refs)

    out = {}
    for setting in (RAYLEIGH, NAKAGAMI):
        ch = make_channel(setting.channel, **dict(setting.channel_kwargs))
        cfg_ota = OTAConfig(channel=ch, noise_sigma=setting.noise_sigma,
                            debias=True)
        for m in (1, 10):
            @jax.jit
            def one(k, m=m):
                k1, k2 = jax.random.split(k)

                def agent(ka):
                    traj = rollout_batch(env, pol, theta, ka, 20, m)
                    return gpomdp.gpomdp_gradient(pol, theta, traj, 0.99)

                grads = jax.vmap(agent)(jax.random.split(k1, n_agents))
                u, _ = ota.aggregate(grads, cfg_ota, key=k2, backend="xla")
                return tree_global_norm_sq(tree_sub(u, g_ref))

            e = jax.vmap(one)(jax.random.split(jax.random.key(3), n_draws))
            out[(setting.name, m)] = (float(jnp.mean(e)), np.asarray(e))
    return out, g_ref


def fig45():
    t0 = time.perf_counter()
    sweeps = captured(fig45_nakagami, "run_sweep")
    floors = captured(fig45_nakagami, "aggregation_error_floor")
    fig45_nakagami.run(mc_runs=RUNS, n_rounds=FIG45["n_rounds"],
                       n_agents=FIG45["n_agents"])
    res, floor = sweeps[0], floors[0]
    rows = [{"tag": s.tag, "channel": s.tag.rsplit("_M", 1)[0],
             "batch_m": s.batch_m, **run_rows(res, i)}
            for i, s in enumerate(res.scenarios)]
    theta = MLPPolicy().init(jax.random.key(0))
    draws, g_ref = floor_draws(theta, FIG45["n_agents"], FIG45["n_draws"])
    floor_rows = []
    for (name, m), (mean, e) in draws.items():
        if mean != floor[(name, m)]:
            raise SystemExit(f"floor copy {name} M={m}: {mean} against the "
                             f"benchmark's {floor[(name, m)]}")
        fm, fse = mean_se(e)
        floor_rows.append({"channel": name, "batch_m": m, "floor": fm,
                           "floor_se": fse, "benchmark_floor": mean,
                           "per_draw": e.astype(np.float64).tolist()})
        print(f"floor {name:8s} M={m:2d}: {fm:.4f} +- {fse:.4f}", flush=True)
    f4, f5 = derived("fig4_nakagami_degrades"), derived(
        "fig5_batch_less_effective_under_nakagami")
    out = header({"scenarios": "benchmarks.fig45_nakagami.scenarios",
                  "runs": RUNS, "final_reward_tail": TAIL, "mode": res.mode,
                  "theta": "MLPPolicy().init(jax.random.key(0))", **FIG45},
                 t0)
    out.update(
        rows=rows, floor=floor_rows,
        g_ref_norm_sq=float(sum(jnp.sum(x * x) for x in
                                jax.tree.leaves(g_ref))),
        fig4_nak_worse=f4["pass"] == "True",
        fig5_penalty_m1=float(f5["aggerr_nak_over_ray_M1"]),
        fig5_penalty_m10=float(f5["aggerr_nak_over_ray_M10"]),
        fig5_pass=f5["pass"] == "True",
        theta={k: np.asarray(v, np.float64).tolist()
               for k, v in theta.items()})
    write("fig45_reference.json", out)


def et():
    t0 = time.perf_counter()
    env, pol = LandmarkNav(), MLPPolicy()
    n = ET["n_agents"]
    cfg = fedpg.FedPGConfig(n_agents=n, batch_m=ET["batch_m"],
                            n_rounds=ET["n_rounds"], alpha=ET["alpha"])
    ota = OTAConfig(channel=make_channel("rayleigh"),
                    noise_sigma=RAYLEIGH.noise_sigma, debias=True)
    runs = {"ota": []}
    for i in ET["keys"]:
        _, h = fedpg.run_jit(env, pol, cfg, jax.random.key(i), ota=ota)
        runs["ota"].append((np.asarray(h.rewards), np.asarray(h.grad_sq),
                            None))
    for tau in ET["taus"]:
        runs[f"et_{tau:g}"] = []
        for i in ET["keys"]:
            _, h = et_run(env, pol, cfg, ETConfig(tau=tau), jax.random.key(i))
            runs[f"et_{tau:g}"].append((np.asarray(h.rewards),
                                        np.asarray(h.grad_sq),
                                        np.asarray(h.uploads)))
    rows = []
    for name, rs in runs.items():
        r = [float(np.mean(x[0][-TAIL:], dtype=np.float64)) for x in rs]
        g = [float(np.mean(x[1], dtype=np.float64)) for x in rs]
        up = [1.0 if x[2] is None else float(np.mean(x[2], dtype=np.float64))
              for x in rs]
        every = [x[2] is not None and bool(np.all(x[2] == n)) for x in rs]
        rm, rse = mean_se(r)
        um, use = mean_se(up)
        gm, gse = mean_se(g)
        rows.append({"run": name, "final_reward": rm, "final_reward_se": rse,
                     "uploads_per_round": um, "uploads_per_round_se": use,
                     "avg_grad_sq": gm, "avg_grad_sq_se": gse,
                     "every_agent_every_round": all(every),
                     "per_run_final_reward": r, "per_run_uploads": up,
                     "per_run_every_agent": every,
                     "per_run_avg_grad_sq": g})
        print(f"{name:8s} final reward {rm:.4f} +- {rse:.4f}  uploads "
              f"{um:.3f}  every agent every round {all(every)}", flush=True)
    out = header({"benchmark": "benchmarks/et_baseline.py", "runs": RUNS,
                  "horizon": cfg.horizon, "gamma": cfg.gamma,
                  "noise_sigma": RAYLEIGH.noise_sigma,
                  "final_reward_tail": TAIL, **ET}, t0)
    out.update(rows=rows, et_uses=next(
        r["uploads_per_round"] for r in rows if r["run"] == "et_0.01"))
    write("et_reference.json", out)


def theory_table():
    """``benchmarks/theory_table.py``'s lines 23-66 with ``mc_runs`` 20."""
    t0 = time.perf_counter()
    s = THEORY
    mdp = TabularMDP.random(jax.random.key(s["mdp_key"]),
                            n_states=s["n_states"], n_actions=s["n_actions"],
                            gamma=s["gamma"], horizon=s["horizon"])
    pol = TabularSoftmaxPolicy(s["n_states"], s["n_actions"])
    consts = theory.MDPConstants(G=s["G"], F=s["F"], l_bar=s["l_bar"],
                                 gamma=s["gamma"])
    V = consts.V()
    delta_j = 1.0 / (1 - s["gamma"])
    channels = [
        (RayleighChannel(), "rayleigh", 1),
        (NakagamiChannel(m=0.1, omega=1.0), "nakagami", 2),
        (make_controlled_channel(RayleighChannel(), TruncatedInversion()),
         "rayleigh_trunc_inv", 1),
    ]
    scens = [Scenario(channel=ch, noise_sigma=s["noise_sigma"],
                      alpha=min(1e-2, consts.max_stepsize(ch.mean)),
                      n_agents=s["n_agents"], batch_m=s["batch_m"],
                      horizon=mdp.horizon, gamma=mdp.gamma,
                      n_rounds=s["n_rounds"], debias=True, tag=name)
             for ch, name, _ in channels]
    res = sweep(mdp, pol, scens, jax.random.key(s["seed"]), RUNS)
    rows = []
    for i, (ch, name, thm) in enumerate(channels):
        kw = dict(K=s["n_rounds"], n_agents=s["n_agents"],
                  batch_m=s["batch_m"], alpha=scens[i].alpha, m_h=ch.mean,
                  sigma_h2=ch.var, noise_sigma2=s["noise_sigma2"],
                  delta_J=delta_j, V=V)
        bound = (theory.theorem1_bound(**kw) if thm == 1
                 else theory.theorem2_bound(**kw))
        g = np.asarray(res.history.grad_sq[i], np.float64).mean(axis=1)
        gm, gse = mean_se(g)
        empirical = res.avg_grad_sq(i)
        rows.append({"tag": name, "theorem": thm, "alpha": scens[i].alpha,
                     "m_h": ch.mean, "sigma_h2": ch.var, "bound": bound,
                     "avg_grad_sq": gm, "avg_grad_sq_se": gse,
                     "sweep_avg_grad_sq": empirical,
                     "holds": bool(empirical <= bound),
                     "per_run_avg_grad_sq": g.tolist()})
        print(f"theorem {thm} {name:18s} empirical {gm:.4f} +- {gse:.4f} "
              f"bound {bound:.4f} alpha {scens[i].alpha:.3e}", flush=True)
    out = header({"benchmark": "benchmarks/theory_table.py", "runs": RUNS,
                  "V": V, "delta_J": delta_j, **s}, t0)
    out.update(rows=rows, mdp={k: np.asarray(getattr(mdp, k),
                                             np.float64).tolist()
                               for k in ("P", "l", "rho")})
    write("theory_reference.json", out)


def main() -> int:
    t0 = time.perf_counter()
    todo = {"fig3": fig3, "fig45": fig45, "et": et, "theory": theory_table}
    for name in (sys.argv[1:] or list(todo)):
        todo[name]()
    print(f"all in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
