#!/usr/bin/env python3
"""Peak memory of the psum train step at llama3.2-3b's full width.

Three fresh one-rank nccl groups (``launch.mesh.run_local``), each building
the model (bf16, random weights) and an OTA state (Rayleigh, -60 dB,
debias, bf16 wire), then taking steps on B=8 S=256 batches: psum steps
first, then a plain OTA step (``make_train_step`` over one agent); plain
steps first, then psum steps; psum steps with the ranks' allocator under
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``.  Each step reports
``max_memory_allocated`` since the step began and ``memory_reserved`` in
GB, or the out-of-memory error that stopped its group.  Run from the root
of a checkout on a machine with one H100:

    python3 perf/psum_mem.py

It prints one line per group and writes ``chiprun_out/psum_mem.json``.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

GROUPS = (("psum_first", ["psum", "psum", "plain"], False),
          ("plain_first", ["plain", "plain", "psum", "psum"], False),
          ("psum_expandable", ["psum", "psum"], True))


def steps(mesh, order):
    """The steps of ``order`` on this one-rank mesh, one batch each."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import model as model_lib
    from repro_torch.train import trainer

    cfg = get_config("llama3.2-3b")
    dev = mesh.device
    model = model_lib.build(cfg)
    tcfg = trainer.TrainConfig(aggregator="ota", channel="rayleigh",
                               noise_db=-60.0, debias=True, n_agents=1,
                               total_steps=len(order), lr=1e-4, warmup=2,
                               wire_dtype="bfloat16")
    state = trainer.init_state(model, tcfg, device=dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=256,
                                  global_batch=8), dev)
    fns = {"psum": trainer.make_psum_train_step(model, tcfg, mesh),
           "plain": trainer.make_train_step(model, tcfg)}
    out = []
    for i, name in enumerate(order):
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            state, _ = fns[name](state, data.batch(i))
            torch.cuda.synchronize(dev)
        except torch.OutOfMemoryError as e:
            out.append((name, "OOM", str(e)[:300]))
            break
        out.append((name, "ok", torch.cuda.max_memory_allocated(dev) / 1e9,
                    torch.cuda.memory_reserved(dev) / 1e9))
    return out


def main():
    import torch

    from repro_torch.launch import mesh as mesh_lib

    if not torch.cuda.is_available():
        print("psum_mem: no CUDA device visible", file=sys.stderr)
        return 1
    res = {}
    for label, order, expand in GROUPS:
        if expand:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        else:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        res[label] = mesh_lib.run_local(steps, 1, order, device="cuda",
                                        timeout=600)[0]
        print(label, res[label], flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "psum_mem.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
