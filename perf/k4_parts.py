#!/usr/bin/env python3
"""Where the tensor-core K4 spends its time, part by part, on the card.

Builds ``src/repro_torch/kernels/csrc/ssd_scan_tc.cu`` as it is and with
parts of its chunk loop removed (the outputs of those variants are wrong
and only timed), then times each at mamba2-130m's prefill shape (B=4,
S=2048, H=24, P=64, G=1, N=128, chunk 128; bf16 in), median of 40
CUDA-event timings, in two rounds.  The difference between two variants
is the time of the part that separates them, as far as parts do not
overlap.  Run from the root of a checkout on a machine with a CUDA device
and nvcc:

    python3 perf/k4_parts.py

It prints one line per variant and the card's name and power limit, and
writes ``chiprun_out/k4_parts.json``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

G = ("for (int kb = 0; kb <= rb; ++kb)", "for (int kb = 0; kb < 0; ++kb)")
STATE = ("      if (!(my_blocks >> nb & 1u)) continue;", "      continue;")
Y_INTER = ("    float yi[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};\n"
           "    if (rows_y) {",
           "    float yi[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};\n"
           "    if (false) {")
TERMS = ("    for (int i = tid; i < np * kPS; i += kThreads) {",
         "    for (int i = tid; i < 0; i += kThreads) {")
STORE = ("        if (q >= Q || t0 + q >= S) continue;",
         "        if (true) continue;")
PREFETCH = [("      load_x_dt(buf ^ 1, t0 + Q);", "      ;"),
            ("      load_bc(cs, cg, t0 + Q);", "      ;"),
            ("      load_bc(bs, bg, t0 + Q);", "      ;")]
VARIANTS = {   # name: the parts removed
    "whole kernel": [],
    "without C.B^T and y_intra": [G],
    "without the later chunks' loads": PREFETCH,
    "without C.B^T, y_intra, state update, y_inter": [G, STATE, Y_INTER],
    "loads, scan and barriers only": [G, STATE, Y_INTER, TERMS, STORE],
    "first chunk's loads and barriers only": [G, STATE, Y_INTER, TERMS,
                                              STORE] + PREFETCH,
}


def main() -> int:
    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("k4_parts: no CUDA device visible", file=sys.stderr)
        return 1
    src = (build.CSRC / "ssd_scan_tc.cu").read_text()
    out = ROOT / "build" / "k4_parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, cuts) in enumerate(VARIANTS.items()):
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (out / f"v{i}.so", subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"v{i}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, ptxas = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas[name] = [line.strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line]
        lib = ctypes.CDLL(str(so))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_tc_launch.argtypes = [vp] * 6 + [i] * 7 + [vp]
        lib.ssd_scan_tc_launch.restype = i
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(6)
    kw = dict(device="cuda", dtype=torch.float32, generator=gen)
    b, s, h, p, g, n, chunk = 4, 2048, 24, 64, 1, 128, 128
    x = torch.randn(b, s, h, p, **kw).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, **kw)) * 0.1
    A = -torch.exp(torch.rand(h, **kw))
    B = (torch.randn(b, s, g, n, **kw) * 0.5).bfloat16()
    C = (torch.randn(b, s, g, n, **kw) * 0.5).bfloat16()
    y = torch.empty(b, s, h, p, device="cuda")

    def call(lib):
        rc = lib.ssd_scan_tc_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), b, s, h, p, g, n, chunk,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    def median_ms(lib, iters=40):
        for _ in range(3):
            call(lib)
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            torch.cuda._sleep(2_000_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            call(lib)
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(e0.elapsed_time(e1) for e0, e1 in pairs)

    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            times[name].append(median_ms(lib))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for name, ts in times.items():
        print(f"K4 {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms; "
              f"{'; '.join(ptxas[name])}")
    print(smi)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "k4_parts.json").write_text(json.dumps(
        {"card": smi, "shape": [b, s, h, p, g, n, chunk], "ms": times,
         "ptxas": ptxas}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
