#!/usr/bin/env python3
"""Where K1's tall body spends its time, part by part, on the card.

Builds ``src/repro_torch/kernels/csrc/ota_fused.cu`` as it is and with parts
of the tall body removed (the outputs of those variants are wrong and only
timed), then times each through the wrapper with the tall body forced, at
the stacked round's shapes (A = 10^4 and 10^5 agents, P = 165, f32, agg
with noise), median of 40 CUDA-event timings, in two rounds; the whole body
also at 2, 3, 4 and 6 ring stages, and the loads alone at each depth (a
build each, with ``kTallStages`` edited), with the time per tile, and with
the fold's register step (``kStep``, 16 rows of f32) at 4, 8 and 32 rows.  The wide body and ``torch.mv(G.T, h)`` are timed beside
them.  Run from the root of a checkout on a machine with a CUDA device and
nvcc:

    python3 perf/k1_parts.py

It prints one line per variant and the card's name and power limit, and
writes ``chiprun_out/k1_parts.json``.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FOLD = ("    fold_tile<T, NC>(acc, col, reinterpret_cast<const T*>(stage),\n"
        "                     reinterpret_cast<const float4*>(stage + "
        "t.tile_bytes), rows, n);",
        "    (void)rows;")
GAINS = ("      for (int r = pl; r < rows; r += 32) cp_async4(hs + 4 * r, "
         "h + row0 + r);",
         "      (void)hs;")
ONE_FILL = [("    for (int k = 0; k < t.n_tiles; ++k) {\n"
             "      const int s = k % kTallStages;\n      const int use",
             "    for (int k = 0; k < (t.n_tiles < kTallStages ? t.n_tiles : "
             "kTallStages); ++k) {\n      const int s = k % kTallStages;\n"
             "      const int use"),
            ("    mbar_wait(full0 + 8 * s, (k / kTallStages) & 1);",
             "    if (k < kTallStages) mbar_wait(full0 + 8 * s, 0);")]
VARIANTS = {   # name: the parts removed
    "whole tall body": [],
    "loads only (no fold)": [FOLD],
    "tiles of G only (no gains, no fold)": [FOLD, GAINS],
    "fold only (the ring filled once)": ONE_FILL,
}
SHAPES = [(10_000, 165), (100_000, 165)]
STAGES = (2, 3, 4, 6)
STEPS = (4, 8, 32)
DEPTH = re.compile(r"constexpr int kTallStages = (\d+);")
STEP = re.compile(r"constexpr int kStep = [^;]+;")
SMEM, BARRIERS = 232448, 256      # csrc/ota_fused.cu kSmemMax, kBarBytes


def tiles(n_agents, n_params, stages, elem=4):
    """The tall body's tile count (csrc/ota_fused.cu::tall_plan)."""
    row = n_params * elem
    g, m = row, 16
    while m:
        g, m = m, g % m
    quantum = max(16 // g, 4)
    per_stage = (SMEM - BARRIERS) // stages // 128 * 128
    rows = min(per_stage // (row + 4) // quantum * quantum, 1024)
    rows = min(rows, max(n_agents // quantum * quantum, quantum))
    full = n_agents // rows
    return full + (1 if (n_agents - full * rows) // quantum else 0), rows


def main() -> int:
    import torch

    from repro_torch.kernels import build, ota_fused

    if not torch.cuda.is_available():
        print("k1_parts: no CUDA device visible", file=sys.stderr)
        return 1
    src = (build.CSRC / "ota_fused.cu").read_text()
    depth = int(DEPTH.search(src).group(1))
    # (case name, variant, ring depth, fold step): each variant as the
    # source has it, the whole body and the loads alone at the other
    # depths, the whole body at other fold steps
    builds = [(name, name, depth, None) for name in VARIANTS]
    builds += [(f"{label}, {s} stages", name, s, None)
               for s in STAGES if s != depth
               for label, name in (("whole tall body", "whole tall body"),
                                   ("loads only", "loads only (no fold)"))]
    builds += [(f"whole tall body, fold step {m} rows", "whole tall body",
                depth, m) for m in STEPS]
    out = ROOT / "build" / "k1_parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (case, name, stages, step) in enumerate(builds):
        text = DEPTH.sub(f"constexpr int kTallStages = {stages};", src)
        if step is not None:
            text = STEP.sub(f"constexpr int kStep = {step};", text)
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        procs[case] = (stages, out / f"v{i}.so", subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out / f"v{i}.so"), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for case, (stages, so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {case}:\n{log}")
        libs[case] = (stages, ota_fused.bind(ctypes.CDLL(str(so))))

    def median_ms(fn, iters=40):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            torch.cuda._sleep(2_000_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)

    def timed(lib, body, g, h):
        kw = dict(sigma=1e-3, scale=1.0 / g.shape[0], seed=17)
        with mock.patch.object(ota_fused, "_lib", lambda: lib), \
                mock.patch.object(ota_fused, "k1_body",
                                  lambda *a, **k: body):
            return median_ms(lambda: ota_fused.fused_aggregate(g, h, **kw))

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for a, p in SHAPES:
        g = torch.randn(a, p, device="cuda", generator=gen)
        h = torch.rand(a, device="cuda", generator=gen) + 0.1
        cases = [(case, lib, "tall", stages)
                 for case, (stages, lib) in libs.items()]
        cases.append(("wide body", libs["whole tall body"][1], "wide", 0))
        times = {name: [] for name, *_ in cases}
        times["torch.mv(G.T, h)"] = []
        for _ in range(2):
            for name, lib, body, stages in cases:
                times[name].append(timed(lib, body, g, h))
            times["torch.mv(G.T, h)"].append(median_ms(lambda: torch.mv(g.T,
                                                                      h)))
        for name, lib, body, stages in cases + [("torch.mv(G.T, h)", None,
                                                 None, 0)]:
            ms = statistics.mean(times[name])
            row = {"A": a, "P": p, "variant": name, "ms": times[name]}
            line = f"(A={a}, P={p}) {name}: " + " / ".join(
                f"{t:.4f}" for t in times[name]) + " ms"
            if body == "tall":
                n_tiles, n_rows = tiles(a, p, stages)
                row.update(stages=stages, tiles=n_tiles, rows_per_tile=n_rows,
                           us_per_tile=ms * 1e3 / n_tiles)
                line += (f"; {n_tiles} tiles of {n_rows} rows, "
                         f"{ms * 1e6 / n_tiles:.1f} ns a tile, "
                         f"{ms * 1e6 / a:.2f} ns a row")
            rows.append(row)
            print(line)
        del g, h
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "k1_parts.json").write_text(json.dumps(
        {"card": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
