"""Training driver: the synthetic pipeline through the OTA (or exact) train
step, with periodic logging and checkpointing.

Counterpart of ``repro/launch/train.py``.  It runs on the card unless
``--device cpu`` is given, and resumes from the latest checkpoint in
``--ckpt-dir``: the step's draws and the batch of step k are functions of
(seed, k), so a resumed run continues the uninterrupted one.

Usage:
    python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
        --steps 200 --aggregator ota --channel rayleigh
    python -m repro_torch.launch.train --example --steps 300 \\
        --ckpt-dir ckpt --ckpt-every 100
    python -m repro_torch.launch.train --arch seamless-m4t-large-v2 \\
        --smoke --steps 6 --seq-len 32 --global-batch 8 --device cpu

The vlm and encdec families' batches carry the frontend memory stub
(``data.pipeline.memory_stub``).

``--example`` trains the width of ``examples/ota_llm_training.py`` (the
llama3.2-3b family at 4 layers, d_model 512, 8 heads, 4 KV heads, d_ff
1536, vocab 32768, about 46M parameters).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.models import model as model_lib
from repro_torch.telemetry import trace
from repro_torch.train import trainer
from repro_torch.utils.device import DeviceLike, resolve_device

EXAMPLE_WIDTH = dict(n_layers=4, d_model=512, n_heads=8, n_kv_heads=4,
                     d_ff=1536, vocab=32768)


def example_config() -> ModelConfig:
    """``examples/ota_llm_training.py``'s ~46M-parameter llama."""
    return get_smoke_config("llama3.2-3b").with_(**EXAMPLE_WIDTH)


def train(cfg: ModelConfig, tcfg: trainer.TrainConfig, shape: InputShape, *,
          steps: int, ckpt_dir: str = "", ckpt_every: int = 100,
          log_every: int = 10, data_seed: int = 0, device: DeviceLike = None,
          verbose: bool = True
          ) -> Tuple[trainer.TrainState, List[Dict[str, Any]]]:
    """The launcher's loop: init (or restore the latest checkpoint in
    ``ckpt_dir``), then steps ``state.step .. steps - 1``, checkpointing
    every ``ckpt_every`` steps and at the end.  Each step writes into the
    state it takes (``trainer.make_train_step``: one state in memory).
    Returns the final state and the logged metrics (every ``log_every``
    steps and the last one; the wall time of each comes from its
    ``train_step`` span)."""
    dev = resolve_device(device)
    model = model_lib.build(cfg)
    state = trainer.init_state(model, tcfg, device=dev)
    if ckpt_dir:
        last = checkpoint.latest_step(ckpt_dir)
        if last is not None:
            state = checkpoint.restore(ckpt_dir, last, state)
            if verbose:
                print(f"restored step {int(state.step)} from {ckpt_dir}")
    step_fn = trainer.make_train_step(model, tcfg)
    history: List[Dict[str, Any]] = []
    wall_us = 0.0
    for i in range(int(state.step), steps):
        log = i % log_every == 0 or i == steps - 1
        batch = make_batch(cfg, shape, i, seed=data_seed, device=dev)
        with trace.span("train_step", step=i) as sp:
            state, metrics = step_fn(state, batch)
            if log:
                m = {k: float(v) for k, v in metrics.items()}
        wall_us += sp.duration_us
        if log:
            m["step"] = i
            m["wall_s"] = wall_us / 1e6
            history.append(m)
            if verbose:
                print(f"step {i:5d} loss {m['loss']:.4f} |g| "
                      f"{m['grad_norm']:.3f} gain {m['gain_mean']:.3f} "
                      f"({m['wall_s']:.1f}s)")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            checkpoint.save(ckpt_dir, i + 1, state)
    if ckpt_dir:
        checkpoint.save(ckpt_dir, steps, state)
    return state, history


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--example", action="store_true",
                    help="examples/ota_llm_training.py's ~46M llama width")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--n-agents", type=int, default=4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--aggregator", default="ota", choices=("ota", "exact"))
    ap.add_argument("--channel", default="rayleigh",
                    choices=("rayleigh", "nakagami", "lognormal", "fixed",
                             "ideal"))
    ap.add_argument("--noise-db", type=float, default=-60.0)
    ap.add_argument("--ota-backend", default="auto",
                    choices=("auto", "torch", "cuda"))
    ap.add_argument("--wire-dtype", default="", choices=("", "bfloat16"))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    ap.add_argument("--metrics-out", default="")
    args = ap.parse_args(argv)

    if args.example:
        cfg = example_config()
    else:
        cfg = get_smoke_config(args.arch) if args.smoke \
            else get_config(args.arch)
    shape = InputShape("cli", seq_len=args.seq_len,
                       global_batch=args.global_batch, kind="train")
    tcfg = trainer.TrainConfig(
        aggregator=args.aggregator, channel=args.channel,
        noise_db=args.noise_db, n_agents=args.n_agents,
        microbatch=args.microbatch, lr=args.lr,
        warmup=min(50, args.steps // 10 + 1), total_steps=args.steps,
        seed=args.seed, ota_backend=args.ota_backend,
        wire_dtype=args.wire_dtype)
    _, history = train(cfg, tcfg, shape, steps=args.steps,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       log_every=args.log_every, data_seed=args.seed,
                       device=args.device)
    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    if history:
        print(f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f} "
              f"over {args.steps} steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
