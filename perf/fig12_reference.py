#!/usr/bin/env python3
"""The reference half of the Fig. 1-2 acceptance: the JAX package on a CPU.

Runs ``benchmarks.fig12_rayleigh.scenarios(250, 1e-3)`` (LandmarkNav, the
two-layer MLP policy, the Rayleigh channel with debias, the five (N, M)
settings) through ``repro.core.sweep.sweep`` with 20 Monte-Carlo runs from
``jax.random.key(0)``, and writes ``perf/fig12_reference.json``: for each
(N, M) the mean over runs and its standard error of

* ``avg_grad_sq`` — each run's (1/K) sum_k ||grad J||^2;
* ``final_reward`` — each run's mean reward over the last 20 rounds,

with the jax version and the seconds taken.  ``chip_smoke.py`` reads the
file and holds the port's 20-run table on the card to it; it imports no
JAX itself.  Run from the root of a checkout:

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python3 perf/fig12_reference.py
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
import numpy as np  # noqa: E402

from benchmarks import fig12_rayleigh  # noqa: E402
from repro.core.sweep import sweep  # noqa: E402
from repro.rl.env import LandmarkNav  # noqa: E402
from repro.rl.policy import MLPPolicy  # noqa: E402

N_ROUNDS, ALPHA, RUNS, SEED, TAIL = 250, 1e-3, 20, 0, 20
OUT = ROOT / "perf" / "fig12_reference.json"


def mean_se(x: np.ndarray):
    x = np.asarray(x, np.float64)
    return float(x.mean()), float(x.std(ddof=1) / math.sqrt(x.size))


def main() -> int:
    t0 = time.perf_counter()
    scens = fig12_rayleigh.scenarios(N_ROUNDS, ALPHA)
    res = sweep(LandmarkNav(), MLPPolicy(), scens, jax.random.key(SEED),
                RUNS)
    rows = []
    for i, (n, m) in enumerate(fig12_rayleigh.SETTINGS):
        g = np.asarray(res.history.grad_sq[i]).mean(axis=1)       # (runs,)
        r = np.asarray(res.history.rewards[i])[:, -TAIL:].mean(axis=1)
        gm, gse = mean_se(g)
        rm, rse = mean_se(r)
        rows.append({"n_agents": n, "batch_m": m,
                     "avg_grad_sq": gm, "avg_grad_sq_se": gse,
                     "final_reward": rm, "final_reward_se": rse,
                     "sweep_avg_grad_sq": res.avg_grad_sq(i),
                     "sweep_final_reward": res.final_reward(i)})
        print(f"(N={n:2d}, M={m:2d})  avg_grad_sq {gm:9.2f} +- {gse:6.2f}  "
              f"final reward {rm:8.3f} +- {rse:.3f}", flush=True)
    out = {"setting": {"scenarios": "benchmarks.fig12_rayleigh.scenarios",
                       "n_rounds": N_ROUNDS, "alpha": ALPHA, "runs": RUNS,
                       "seed": SEED, "final_reward_tail": TAIL,
                       "mode": res.mode},
           "jax_version": jax.__version__,
           "platform": jax.devices()[0].platform,
           "seconds": time.perf_counter() - t0,
           "rows": rows}
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT.relative_to(ROOT)} in {out['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
