"""Render the dry-run and roofline tables from the port's dry-run records.

Counterpart of ``repro/launch/report.py``::

    PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]

Every ``pod16x16`` record enters the roofline table: the port's dry run
counts the whole step (no calibration), so each record is exact.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import warnings
from typing import Dict, List

from repro_torch.configs import ARCH_IDS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import OUT_DIR
from repro_torch.utils.roofline import HBM_BYTES

MESHES = ("pod16x16", "pod2x16x16")


def load(dryrun_dir: str) -> Dict:
    """Index dry-run records by (arch, shape, mesh, filename stem).

    Malformed files (unparseable JSON, or records missing any of the
    identifying keys) are skipped with a warning rather than crashing the
    whole report: one bad artifact should not hide the rest."""
    recs = {}
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        try:
            with open(path) as f:
                r = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            warnings.warn(f"skipping unreadable dry-run record {path}: {e}",
                          stacklevel=2)
            continue
        if not isinstance(r, dict) or not all(
                k in r for k in ("arch", "shape", "mesh")):
            warnings.warn(f"skipping malformed dry-run record {path}: "
                          "missing arch/shape/mesh", stacklevel=2)
            continue
        base = os.path.basename(path)[:-5]
        recs[(r["arch"], r["shape"], r["mesh"], base)] = r
    return recs


def _mem_gb(rec) -> str:
    """The rank's arguments plus the step's peak, in GB; flagged past one
    H100's 80 GB."""
    tot = rec.get("memory", {}).get("total", 0)
    if not tot:
        return "?"
    flag = "" if tot <= HBM_BYTES else " (!)"
    return f"{tot/1e9:.2f}{flag}"


def dryrun_table(recs) -> List[str]:
    lines = [
        "| arch | shape | mesh | status | bytes/rank (args+peak, GB) |"
        " FLOPs/rank | collectives (per-rank wire bytes) |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mesh in MESHES:
                match = [r for (a, s, m, _), r in recs.items()
                         if a == arch and s == shape and m == mesh]
                if not match:
                    lines.append(
                        f"| {arch} | {shape} | {mesh} | MISSING | | | |")
                    continue
                r = match[-1]
                coll = r.get("collectives_rolled", {})
                kinds = ",".join(
                    f"{k}:{int(v):,}" for k, v in
                    sorted(coll.get("bytes_by_kind", {}).items()))
                flops = r["roofline"]["hlo_flops"]
                lines.append(
                    f"| {arch} | {shape} | {mesh} | traced "
                    f"({r.get('t_trace_s', 0):.1f}s) | {_mem_gb(r)} | "
                    f"{flops:.3g} | {kinds or 'none'} |"
                )
    return lines


# The port's lever for each dominant term, by step kind
LEVERS = {
    ("collective", "train"): "one flat buffer a layer (FSDP2 grouping), "
                             "prefetched gathers",
    ("collective", "serve"): "one all-reduce a block (fused collectives), "
                             "CUDA graphs of a layer",
    ("memory", "train"): "fused AdamW into the state, attention without "
                         "the materialised scores",
    ("memory", "serve"): "no copy of the cache or the logits a step",
    ("compute", "train"): "already compute-bound: raise the batch a rank",
    ("compute", "serve"): "already compute-bound: raise the batch a rank",
}


def lever(rec) -> str:
    kind = "train" if rec.get("kind", "train") == "train" else "serve"
    return LEVERS[rec["roofline"]["dominant"], kind]


def roofline_table(recs) -> List[str]:
    lines = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) |"
        " dominant | MODEL/traced FLOPs | MFU bound | one-line lever |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            match = [r for (a, s, m, _), r in recs.items()
                     if a == arch and s == shape and m == "pod16x16"]
            if not match:
                continue
            rec = match[-1]
            r = rec["roofline"]
            lines.append(
                f"| {arch} | {shape} | {r['compute_s']*1e3:.2f} | "
                f"{r['memory_s']*1e3:.2f} | {r['collective_s']*1e3:.2f} | "
                f"**{r['dominant']}** | {r['useful_flop_ratio']:.3f} | "
                f"{r['mfu']:.4f} | {lever(rec)} |"
            )
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--section", default="both",
                    choices=("dryrun", "roofline", "both"))
    args = ap.parse_args(argv)
    recs = load(args.dir)
    if args.section in ("dryrun", "both"):
        print("\n".join(dryrun_table(recs)))
        print()
    if args.section in ("roofline", "both"):
        print("\n".join(roofline_table(recs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
