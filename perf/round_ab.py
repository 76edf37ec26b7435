#!/usr/bin/env python3
"""One Algorithm-2 round of the port at the paper's width, tree against tree.

For each source tree given (a checkout's root, e.g. the parent commit
unpacked with ``git archive`` and this one), in the order given, a fresh
process imports that tree's ``src/repro_torch`` and runs the main cell
(``LandmarkNav``, ``MLPPolicy``, Rayleigh, sigma 1e-3, debias, N=10 M=10
T=20, alpha 1e-3) through ``fedpg.run`` on the card: after a warm-up, three
runs of K=100 timed with CUDA events (ms per round), then ``torch.profiler``
over 10 rounds (device launches and device-busy microseconds per round).
Run the trees in turns (a b b a) to see the host's drift:

    python3 perf/round_ab.py build/parent . . build/parent

``--agent-blocks B`` (before the trees) times the agent-streamed round in
blocks of B instead:

    python3 perf/round_ab.py --agent-blocks 4 build/parent . . build/parent

It prints the card's name and power limit and one line per tree, and
writes ``chiprun_out/round_ab.json`` (``round_ab_blocks<B>.json``).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1] + "/src")
blocks = None if sys.argv[2] == "none" else int(sys.argv[2])
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import fedpg
from repro_torch.core.channel import RayleighChannel
from repro_torch.core.ota import OTAConfig
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy

torch.backends.cuda.matmul.allow_tf32 = False
env, pol = LandmarkNav(), MLPPolicy()
ota = OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True)


def cfg(k):
    return fedpg.FedPGConfig(n_agents=10, batch_m=10, horizon=20,
                             n_rounds=k, alpha=1e-3)


fedpg.run(env, pol, cfg(3), 99, ota=ota, agent_blocks=blocks, device="cuda")
torch.cuda.synchronize()
ms = []
for _ in range(3):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fedpg.run(env, pol, cfg(100), 0, ota=ota, agent_blocks=blocks,
              device="cuda")
    e.record()
    torch.cuda.synchronize()
    ms.append(s.elapsed_time(e) / 100)
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    fedpg.run(env, pol, cfg(10), 2, ota=ota, agent_blocks=blocks,
              device="cuda")
    torch.cuda.synchronize()
dev = [ev for ev in prof.key_averages()
       if str(ev.device_type).endswith("CUDA")]
busy = sum(getattr(ev, "self_device_time_total", 0) for ev in dev) / 10
print(json.dumps({"tree": sys.argv[1], "agent_blocks": blocks,
                  "ms_per_round": ms,
                  "launches_per_round": sum(ev.count for ev in dev) / 10,
                  "device_busy_us_per_round": busy}))
"""


def main() -> int:
    trees, blocks = sys.argv[1:], "none"
    if trees[:1] == ["--agent-blocks"]:
        blocks, trees = trees[1], trees[2:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rows = []
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", CHILD, tree, blocks],
                             capture_output=True, text=True, check=True,
                             timeout=900, cwd=ROOT)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        rows.append(row)
        print(f"{tree}: ms/round {', '.join(f'{x:.3f}' for x in row['ms_per_round'])}"
              f" | {row['launches_per_round']:.1f} launches, "
              f"{row['device_busy_us_per_round']:.1f} us busy a round",
              flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = "round_ab.json" if blocks == "none" else \
        f"round_ab_blocks{blocks}.json"
    (out_dir / name).write_text(json.dumps({"card": smi, "rows": rows},
                                           indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
