#!/usr/bin/env python3
"""What the agent mesh adds to a round at one rank, on the card.

One one-rank nccl group (``launch.mesh.run_local``) runs the main cell
(``LandmarkNav``, ``MLPPolicy``, Rayleigh, -60 dB, debias, N=10 M=10 T=20,
alpha 1e-3, K=20) stacked and streamed in blocks of 4 through
``fedpg.run``, on the mesh and off it in turns (ABBA, 3 pairs), timed by the
host clock around each run; then times the round's two collectives alone
at the round's shapes (``all_reduce`` of the packed ``(2, 1, 165)`` sums,
``all_gather`` of the ``(1, 10, 10)`` returns), 200 calls each, by the host
clock with the card synchronised after each call; ``torch.profiler``
over 5 rounds of each form on and off the mesh (device launches and
device-busy microseconds a round); and ``cProfile`` over 5 rounds of each
form on and off the mesh: the functions whose own host time a round grows
most on the mesh.  Run from the root of a checkout on a machine with a
card:

    python3 perf/mesh_round.py

It prints the card's name and power limit and one line per measurement,
and writes ``chiprun_out/mesh_round.json``.
"""
from __future__ import annotations

import cProfile
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ROUNDS, PAIRS, CALLS, PROFILED = 20, 3, 200, 5


def _cell():
    from repro_torch.configs.ota_pg_particle import RAYLEIGH
    from repro_torch.core.channel import make_channel
    from repro_torch.core.fedpg import FedPGConfig
    from repro_torch.core.ota import OTAConfig

    cfg = FedPGConfig(n_agents=10, batch_m=10, horizon=RAYLEIGH.horizon,
                      gamma=RAYLEIGH.gamma, alpha=1e-3, n_rounds=ROUNDS)
    ota = OTAConfig(make_channel(RAYLEIGH.channel,
                                 **dict(RAYLEIGH.channel_kwargs)),
                    noise_sigma=RAYLEIGH.noise_sigma, debias=True)
    return cfg, ota


def rank(mesh):
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fedpg
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    dev = mesh.device
    cfg, ota = _cell()
    env, pol = LandmarkNav(), MLPPolicy()

    def run(c, on_mesh, blocks):
        return fedpg.run(env, pol, c, 7, ota=ota, agent_blocks=blocks,
                         agent_mesh=mesh if on_mesh else None, device=dev)

    out = {}
    for form, blocks in (("stacked", None), ("streamed", 4)):
        short = dataclasses.replace(cfg, n_rounds=2)
        run(short, True, blocks)
        run(short, False, blocks)
        ms = {True: [], False: []}
        for i in range(PAIRS):
            for on_mesh in ((True, False) if i % 2 == 0 else (False, True)):
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                run(cfg, on_mesh, blocks)
                torch.cuda.synchronize(dev)
                ms[on_mesh].append((time.perf_counter() - t) * 1e3 / ROUNDS)
        prof = {}
        for on_mesh in (True, False):
            c = dataclasses.replace(cfg, n_rounds=PROFILED)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                run(c, on_mesh, blocks)
                torch.cuda.synchronize(dev)
            kern = [e for e in p.key_averages()
                    if str(e.device_type).endswith("CUDA")]
            busy = sum(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
                       for e in kern)
            prof["mesh" if on_mesh else "plain"] = {
                "launches_per_round": sum(e.count for e in kern) / PROFILED,
                "busy_us_per_round": busy / PROFILED}
        out[form] = {"ms_mesh": ms[True], "ms_plain": ms[False],
                     "profile": prof, "host": host_diff(
                         lambda on_mesh: run(dataclasses.replace(
                             cfg, n_rounds=PROFILED), on_mesh, blocks))}

    sums = torch.zeros((2, 1, 165), device=dev)
    rets = torch.zeros((1, 10, 10), device=dev)
    calls = {}
    for name, fn in (("all_reduce", lambda: mesh.all_reduce(sums)),
                     ("all_gather", lambda: mesh.all_gather(rets, 1))):
        for _ in range(10):
            fn()
        torch.cuda.synchronize(dev)
        us = []
        for _ in range(CALLS):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            us.append((time.perf_counter() - t) * 1e6)
        calls[name] = statistics.median(us)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    for _ in range(CALLS):
        torch.cuda.synchronize(dev)
    calls["synchronize alone"] = (time.perf_counter() - t) * 1e6 / CALLS
    out["collective_us"] = calls
    return out


def host_diff(run, top=12):
    """``cProfile`` of ``run(True)`` and ``run(False)``: the functions whose
    own time (us a round) grows most on the mesh, and both totals."""
    own = {}
    for on_mesh in (True, False):
        prof = cProfile.Profile()
        prof.enable()
        run(on_mesh)
        prof.disable()
        stats = pstats.Stats(prof).stats
        own[on_mesh] = {f"{Path(f).name}:{line}:{name}": tt * 1e6 / PROFILED
                        for (f, line, name), (_, _, tt, _, _) in
                        stats.items()}
    keys = set(own[True]) | set(own[False])
    diff = sorted(((own[True].get(k, 0.0) - own[False].get(k, 0.0), k)
                   for k in keys), reverse=True)[:top]
    return {"total_us_mesh": sum(own[True].values()),
            "total_us_plain": sum(own[False].values()),
            "top_growth_us": [(k, d) for d, k in diff]}


def main():
    import torch

    from repro_torch.launch.mesh import run_local

    if not torch.cuda.is_available():
        print("mesh_round: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    res = run_local(rank, 1, device="cuda", timeout=900)[0]
    for form in ("stacked", "streamed"):
        r = res[form]
        m, p = statistics.median(r["ms_mesh"]), statistics.median(
            r["ms_plain"])
        print(f"{form}: mesh {m:.3f} ms a round against {p:.3f} off the "
              f"mesh ({m / p:.3f}x; turns {r['ms_mesh']} / "
              f"{r['ms_plain']}); profile {r['profile']}", flush=True)
        print(f"{form} host (cProfile, us a round): {r['host']}",
              flush=True)
    print(f"collectives alone, one rank, median us a call (card synchronised "
          f"after each): {res['collective_us']}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_round.json").write_text(json.dumps(
        {"card": smi, **res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
