#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels to
their plain versions.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. card     — versions, ``nvidia-smi`` name and power limit, TF32 off;
2. build    — nvcc builds every ``src/repro_torch/kernels/csrc/*.cu`` and
              prints ptxas's registers, shared memory and spills, and the
              HGMMA/HMMA count of the tensor-core kernels' SASS;
3. K1       — the fused uplink kernel against its plain PyTorch version on
              the card, each of its two bodies (wide, tall) forced in turn:
              agg/sgd/adam, f32 and bf16 wire, with the device rescale
              factor, at the paper's width, (64, 165), (10^4, 165), (10^5,
              165) and beyond; bitwise where the contract says so, the
              bodies bitwise each other; lanes (3 x (4, 800), 20 x (10,
              165), the stack shared or per lane): bitwise the plain lane
              loop and every lane its one-lane launch, per body;
4. main     — Algorithm 2 at the paper's width through ``fedpg.run`` with
              ``ota_backend="auto"``: every round must launch K1 once; then
              Algorithm 1; then a small run where the kernel path and the
              plain chain must agree;
5. fig12    — the Fig. 1-2 (N, M) table through the port's sweep engine
              (``mode="vmap"``, K=250, alpha 1e-3, RAYLEIGH, debias, 20
              runs): each (N, M) one partition of 20 lanes, one K1
              lane-form launch a round; avg_grad_sq and the last-20-round
              reward with their standard errors beside the JAX package's
              20-run means (``perf/fig12_reference.json``), each avg_grad_sq
              within 4 combined standard errors, both trends;
6. times    — K1's device time at (10, 165), (33, 165), (65, 165), (10^4,
              165), (10^5, 165) and (8, 2^21), f32 (and bf16 at 10^4 and
              2^21): agg with and without noise for the rule's body and the
              other one in turns, beside the byte bound, the sequential
              fold's floor and ``torch.mv`` (the matvec alone); sgd and the
              plain version at the main path's shape; then the A sweep at P
              = 165 to 1000 that the dispatch rule's crossovers come from;
7. profile  — torch.profiler over 10 Algorithm-2 rounds: device time by
              kernel and the device's busy share of a round;
8. K3       — the flash-attention kernels against their plain version on
              the card: f32 and bf16, causal / window 128 / bidirectional, GQA
              g = 1-4, Dh 64/80/112/128, ragged lengths, Sq != Sk, 2048 at
              llama3.2-3b's, granite-moe-1b-a400m's, llama-3.2-vision-11b's
              and seamless-m4t-large-v2's decoder's prefill shapes, the
              latter's encoder (512 frames, bidirectional) (bf16 also
              within one bf16 ulp), positions where some queries
              see no key, and views the tensor-core kernel refuses (Dh 72,
              stride 68); each call must launch the kernel the dispatch rule
              names (bf16 on tensor cores, the rest on f32 cores), and the
              tensor-core kernel also within one bf16 ulp of its plain model;
              then how far a single bf16 P would part from the plain version;
9. K4       — the SSD-scan kernels (f32 out) against their plain version: the
              JAX sweep's shapes, mamba2-130m's and zamba2-7b's (H=112,
              N=64), P and S not multiples of
              the 16-column slice and the chunk, f32 and bf16 in, the
              tensor-core kernel also against its plain model, and both
              against the sequential recurrence;
10. llama   — serve llama3.2-3b at full width in bf16: prefill B=4 S=2048
              (28 launches of the tensor-core K3, none of PR 12's), 32 greedy
              serve steps from a capacity-2080 cache, then the prefill again
              with K3's plain version: in float32 (28 launches of PR 12's K3;
              asserted within 2e-2) and in bf16 on 3 seeds (reported beside
              the noise floor of two plain versions);
11. mamba   — serve mamba2-130m at full width in bf16: prefill (24 launches
              of the tensor-core K4), 32 decode steps, the plain-version
              prefills (float32: 24 launches of PR 12's K4);
12. K3/K4 times — median of 60 CUDA-event timings at the serve shapes, the
              tensor-core kernels and PR 12's on the same inputs in turns,
              beside the bound, the plain version and (K3) SDPA; K3 also at
              granite-moe-1b-a400m's prefill shape (H=16 Hkv=8 Dh=64),
              llama-3.2-vision-11b's (H=32 Hkv=8 Dh=128) and
              seamless-m4t-large-v2's encoder (S=512, bidirectional) and
              decoder (H=16 Hkv=16 Dh=64), held to its plain version first;
              K4 also at zamba2-7b's (H=112 N=64);
13. serve profile — torch.profiler over one prefill, then over 4 decode
              steps, of each config: the tensor-core K3's and K4's share of
              device time, launches, and the device's busy share of each;
14. K2      — the server-side update kernel against its plain version:
              5 shapes, f32 and bf16, sigma 0/0.5, debias on/off, bitwise;
              bitwise K1's unit-gain server pass; one K2 launch per
              ``ops.ota_update`` call;
15. K2 times — median of 60 CUDA-event timings at 16 MB (f32, bf16) and
              256 MB (f32), beside the byte bound and the plain version;
16. streamed — Algorithm 2 with ``agent_blocks`` 1, 3, 4, 10 at the paper's
              width: histories bitwise equal, 2 K1 launches per block plus
              the tail, gain means bitwise the stacked run's, reward and
              grad_sq within rtol 1e-5 of the stacked run's (chained, and
              round by round from a common state); Algorithm 1 streamed;
17. large fleets — ``benchmarks/fig_large_n.py``'s settings at N = 10^2 ..
              10^5, one round streamed (32 per block) and stacked: ms and
              peak memory, the streamed peak below the stacked one; the
              stacked round's K1 launch is the tall body's;
18. power control — Algorithm 2 with UnitPower, TruncatedInversion and
              ConstantReceived, 3 Monte-Carlo runs: mean(h) against the
              closed-form effective m_h, the theory's floor;
19. service — the round service at the paper's width: Bernoulli 0.5
              (realised and expected debias), subset 3, Bernoulli 0.5 with
              an exp(1) straggler and deadline 2, each with and without
              staleness (4, 0.8); stacked (K=100, 1 K1 launch a round) and
              streamed at ``agent_blocks`` 1/3/4/10 (K=10, 2 or 3 K1
              launches a block + 1): histories bitwise equal across block
              sizes, gain means bitwise the stacked run's, the realised
              rate within 5 standard errors; full participation bitwise the
              plain round; rounds nobody makes leave theta unchanged;
20. service large — ``benchmarks/fig_participation.py``'s width, N = 10^4
              M=1 T=3: rates 0.25/0.5 x staleness off/(4, 0.8), and 0.5
              with a straggler; stacked and streamed in blocks of 64, 5
              rounds each: ms, peak MB, the realised rate, K1 launches (the
              stacked rounds' all the tall body's); K1's time at (10^4,
              165), the tall body against the wide body in turns;
21. ET      — Fig. 3's argument (``benchmarks/et_baseline.py``: N=20 M=5
              K=200 alpha=3e-3) held to ``perf/et_reference.json`` (the
              JAX package's 20 runs a setting): OTA as 20 lanes of one
              sweep partition (one K1 lane launch a round), the
              event-triggered baseline over 8 seeds at tau 0.01, no K1
              launch; where every reference agent uploads every round at
              both taus, tau 0.1 bitwise tau 0.01 on 2 seeds and every
              agent uploading in every port run; each final reward within
              4 combined standard errors; et_uses > 3; and with Bernoulli
              0.5 participation at ``agent_blocks`` None and 4 (bitwise
              equal): final reward, channel uses per round, ms per round;
22. zoo     — each registered family through Algorithm 2 with K1 at its
              default policy (K=20), then G(PO)MDP on a Garnet MDP against
              ``exact_J``'s autograd gradient (5 standard errors);
23. lanes   — a grid varying alpha, noise sigma, the Rayleigh scale, a
              TruncatedInversion parameter, a windy wind, a Bernoulli rate
              with staleness (4, 0.8), and the exact uplink (K=10, 4 runs):
              every lane of the lane-batched run bitwise ``fedpg.run`` on the
              card (history and theta_K), one K1 launch a round per
              partition, ``sweep(mode="vmap")`` the same histories;
24. batching — the main cell as R = 1, 5, 20, 100 lanes: ms per batched
              round against R x phase 4's ms per round, busy share and
              launches per round; K1's lane launch at (20, 10, 165) and
              (100, 10, 165) against R one-lane launches, the plain version,
              ``torch.baddbmm`` and the byte bound;
25. telemetry — the main cell with telemetry on and off (bitwise equal
              histories, finite probes, the overhead per round), a sweep
              with telemetry, and its span trace in
              ``chiprun_out/sweep_trace.json``;
26. driver  — ``service.driver.RoundService`` at the paper's width
              (Bernoulli 0.5, staleness (4, 0.8), 32 rounds in commits of
              4, a checkpoint each under ``chiprun_out/``): a twin resumed
              after commit 2 by a fresh service ends bitwise the straight
              run (state, later records, per-round history); commits of 1
              bitwise commits of 4; one K1 launch a round; ms per round of
              a bare driver (no telemetry, checkpoint or hook) against the
              same rounds through ``fedpg.run`` (phase 19's stacked
              service round), in turns; then N = 10^4 M=1 T=3 (8 rounds,
              resume after commit 1, the tall body).  The
              run ledger ``chiprun_out/ledger.jsonl`` (platform, phase 5's
              sweeps, the service commits) is rendered to
              ``chiprun_out/REPORT.md``;
27. train   — llama3.2-3b at full width, bf16, OTA (Rayleigh, -60 dB,
              debias, bf16 wire), 4 agents, B=8 S=256, 4 steps: one wide K1
              launch a step at (1, d), finite metrics, ms a step, peak
              memory; 2 exact steps launch no K1; K1 at (1, d) bitwise its
              plain version on the windows [0, 2^20), [2^31, 2^31 + 2^20)
              and [d - 2^20, d), bf16 wire and f32, timed (median of 10)
              beside its byte bound and ``torch.mv``;
28. resume  — ``launch.train``'s loop at ``examples/ota_llm_training.py``'s
              width: 6 straight steps against 3, a checkpoint, a fresh
              restore and 3 more, bitwise under deterministic algorithms
              in a child process that alone gets
              ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (whether two straight
              runs in this process are bitwise without them is reported);
              then 100 steps, the last 10 losses below the first 10;
29. streamed lanes — the main cell in blocks of 4 as R = 1, 5, 20 lanes of
              one batched run (K=20): ms per batched round against R x the
              one-run streamed round, in turns; 2 n_blocks + 1 K1 launches
              a round for every R; lanes 0 and R-1 bitwise ``fedpg.run
              (agent_blocks=4)``; Bernoulli 0.5 with staleness (4, 0.8) at
              R = 5 (every lane bitwise, 3 n_blocks + 1); N = 10^4 M=1 T=3
              in blocks of 1000 as 4 lanes against the stacked lanes (peak
              memory, streamed below stacked); K1's lane fold alone at (20,
              5, 165) and (4, 1001, 165) beside its byte bound, the plain
              version and ``torch.baddbmm``;
30. sweep modes — a streamed partition (3 scenarios) and a
              ``HeterogeneousBudget`` partition (p_max 1.5, 3.0), 4 runs,
              K=10: ``"vmap"`` bitwise ``"map"`` (K1 launches counted),
              ``"sharded"`` bitwise ``"vmap"`` on the default one-device
              mesh and on ``[cuda:0] x 2`` (one pad lane masked);
31. agent mesh — ``launch.mesh.run_local`` (nccl, one process a rank) at
              world size 1 and, with several cards, over all of them: the
              main cell (K=20) stacked, streamed in 4s and Bernoulli 0.5
              streamed in 4s, in turns with the run off the mesh (bitwise
              it at one rank), K1 launches (2 stacked, 2 a rank's block +
              1 streamed) and collectives (1 ``all_reduce`` + 1
              ``all_gather``) a round, every rank bitwise the same with the
              same draws (checksums gathered by the phase); N = 10,001
              (M=1 T=3, blocks of 32, K=3): ms a round, peak MB per rank;
              at one rank the psum train step of llama3.2-3b (B=8 S=256,
              3 steps, 2 K1 launches at (1, d) a step) in turns with the
              plain step: ms and peak memory;
32. granite — serve granite-moe-1b-a400m at full width in bf16 (24 layers,
              d_model 1024, 32 experts top-8): prefill B=4 S=2048 (24
              launches of the tensor-core K3), 16 greedy serve steps, peak
              memory, the float32 prefill (24 launches of PR 12's K3)
              against the plain attention's (asserted within 2e-2), the
              bf16 one beside its noise floor;
33. train granite — granite-moe-1b-a400m at full width, bf16, OTA
              (Rayleigh, -60 dB, debias, bf16 wire), 4 agents, B=8 S=256, 4
              steps: one wide K1 launch a step at (1, d), no K3/K4 launch,
              finite metrics, ms a step, peak memory, K1's share of a
              profiled step; K1 at (1, d) bitwise on two windows, timed
              beside its byte bound and ``torch.mv``; one psum step at one
              rank (2 K1 launches) in turns with the plain step;
34. train mamba2 — mamba2-130m the same way (the mixer through the plain
              scan: no K4 launch in a step); K3's and K4's wrappers refuse
              CUDA tensors that require grad (they have no backward);
35. families — serve zamba2-7b, llama-3.2-vision-11b and
              seamless-m4t-large-v2 at their published widths in bf16 as
              phase 32 (prefill B=4 S=2048, 4 decode steps, peak memory,
              profile): zamba2 81 launches of the tensor-core K4 and no K3
              (its shared attention runs ``attend``); vision 40 wgmma K3
              launches (32 dense and 8 cross layers' self attention; the
              cross attention over the (4, 1601, 4096) patch memory runs
              ``attend``); seamless 48, 24 of them bidirectional (the
              encoder's over its (4, 512, 1024) frames, counted by the
              wrapper in the same prefill); the float32 prefill
              (PR 12's kernels; zamba2 at 13 layers, vision at 10) against
              the plain attention and scan within 2e-2;
36. train families — the three OTA train steps as phase 33 (4 agents, B=8
              S=256, bf16 wire, one wide K1 launch a step, no K3/K4
              launch): seamless at full width (memory (8, 64, 1024)),
              zamba2 at its published width with 13 layers (two groups,
              the shared block twice, a tail of 1), vision with 10 (two
              groups of 4 dense layers and a cross layer);
37. fig3    — Fig. 3 (``benchmarks/fig3_vs_vanilla.py``: N=10 M=10 K=250
              alpha 1e-3): the OTA and the exact uplink as two 20-lane
              ``sweep(mode="vmap")`` partitions (250 and 0 K1 launches),
              avg_grad_sq and the last-20 reward of each held to
              ``perf/fig3_reference.json`` (``repro_torch.figures.
              hold_runs``: z within 4), rounds to 90 % and the benchmark's
              claim ``same_order``;
38. fig45   — Figs. 4-5 (``benchmarks/fig45_nakagami.py``): Nakagami(0.1,
              1) and Rayleigh at M = 1 and 10, four 20-lane partitions (250
              K1 launches each), every value held to
              ``perf/fig45_reference.json``, Fig. 4's claim; the Lemma-3
              aggregation-error floor at the reference's policy weights
              (4000 draws a setting, one K1 launch each; the first 400 held
              to the reference's 400, by the mean of logs where its draws
              are heavy-tailed), Fig. 5's claim; the card's Nakagami(0.1,
              1) gains (10^6 draws, one-run and lane samplers) against
              their mean and variance within 5 standard errors;
39. theory  — the Theorem 1/2 table (``benchmarks/theory_table.py``) on
              the reference's tabular MDP (``perf/theory_reference.json``):
              Rayleigh, Nakagami(0.1, 1) and Rayleigh under truncated
              inversion as three 20-lane partitions, K=150 (150 K1
              launches each); each bound equal to the reference's (rtol
              1e-6), each avg_grad_sq held to the reference's and below its
              bound where the reference's is;
40. sharded serve — ``train.server.shard_for_serving`` on a one-rank nccl
              ``("data", "model")`` mesh (1, 1): llama3.2-3b,
              granite-moe-1b-a400m and mamba2-130m at full width, bf16 and
              float32, prefill B=4 S=2048 and 4 greedy decode steps on the
              same weights as the unsharded path (warm-up, sharded,
              unsharded): logits and every cache field bitwise, K3/K4
              launches a prefill 28 / 24 / 24; ms a prefill and a step,
              peak GB; with four cards, llama3.2-3b over (1, 4) and (2, 2)
              against the one-rank logits; then the split-slot decode
              (one llama3.2-3b attention layer at full width, batch 1,
              ``long_500k``'s 8192-slot ring at position 524287, bf16 and
              float32): ``decode_partials`` over 2 and 4 slot shards plus
              ``combine_partials`` against the unsharded
              ``decode_self_attention`` (float32 rtol 1e-5, bf16 2e-2 of
              the max abs value), the combine's ms beside the layer's;
41. sharded train — ``train.trainer.shard_for_training`` (FSDP over
              data, tensor parallelism over model) on a one-rank nccl (1,
              1) mesh: llama3.2-3b (cut to 8 layers), granite-moe-1b-a400m
              and mamba2-130m at full width, bf16, B=8 S=256, 4 agents, 3
              steps in turns with the plain step on the same weights and
              draws: params, moments and metrics bitwise, one mapped K1
              launch a step, the step's peak within 1.05x the plain's; ms
              a step; then K1's mapped instance at llama3.2-3b's rank-0 row
              of a (2, 2) layout: bitwise its plain version and the
              unmapped (1, d) launch's noise at the same elements, timed
              against the unmapped launch of the same row;
42. power control held — ``benchmarks/fig_power_control.py`` (N=8 M=4
              K=120 on the reference's tabular MDP): seven policies over
              Rayleigh as the reference's five partitions of 20 lanes each
              (the three truncation targets as lanes of one), 120 K1
              launches a partition; each avg_grad_sq held to
              ``perf/power_control_reference.json``'s; the effective
              moments, theorem, bound and floor equal to its (rtol 1e-6);
              ``holds`` where its holds, ``floor_moves``; mean(h) within 5
              standard errors of m_h;
43. zoo held — ``benchmarks/fig_env_zoo.py`` (N=4 M=4 T=10 K=120): seven
              families under the exact and the Rayleigh uplink and three
              wind lanes, 17 scenarios in the reference's 14 partitions of
              20 lanes a scenario; 120 K1 launches a Rayleigh partition and
              none an exact one; each final reward (last 10 rounds) and
              avg_grad_sq held to ``perf/env_zoo_reference.json``'s; the
              l_bar row equal to its (rtol 1e-6);
44. participation held — ``benchmarks/fig_participation.py`` at N = 10^4
              in blocks of 64 (M=1 T=3 K=5): the Bernoulli rates 0.25 and
              0.5 as lanes of one partition a staleness setting (none,
              (4, 0.8)), 20 runs each, telemetry on; 2 or 3 K1 launches a
              block + 1 a batched round (315, 472); avg_grad_sq, the
              realised rate, drift and mean age held to
              ``perf/participation_reference.json``'s; each rate within 5
              standard errors; the full-participation baseline bitwise the
              participation-off sweep; the round-service driver (rate 0.5,
              exp(1) stragglers closed at deadline 2, 8 rounds): its rate
              within 5 standard errors of ``expected_count``;
45. dry run — ``launch/dryrun.py`` against the card: (a) phase 41's
              llama3.2-3b sharded train step (8 layers, B=8 S=256, 4
              agents, bf16 wire) on a (1, 1) nccl mesh against its dry run
              on a fake (1, 1) group (a spawned process): argument bytes and
              FLOPs equal (both sides count a kernel by its formula times
              its launches), one abstract K1 launch, the step's peak within
              ``DRYRUN_MEM_BAND`` of MemTracker's, ms a step against the
              roofline and the MFU; (b) the bf16 prefills of phase 10's cell:
              28 K3 and 24 K4 abstract launches as on the card, FLOPs equal;
              (c) ``DRYRUN_POD`` through the CLI on a fake 256-rank pod
              (granite-moe-1b-a400m ``train_4k``, mixtral-8x22b
              ``prefill_32k``, seamless-m4t-large-v2 ``decode_32k``), one
              process each, all started once (a) and (b) are done: each
              must succeed within 60 s (bytes a rank, dominant term, trace
              seconds);
46. analyze — the static contract checker on the card: (a) ``python -m
              repro_torch.analyze --strict`` as a subprocess, every
              contract on the cuda backend, exits 0 with no finding and
              nothing skipped; the wire-dtype contract in-process, each of
              its K1 launches real; (b) host-device syncs a round
              (``analyze.budget.SyncCounter``) of the main cell, a batched
              round at R = 1 and 20 lanes and a streamed round in blocks
              of 4: the same every round after the first, R = 20's equal
              to R = 1's; one more OTA train step of llama3.2-3b on phase
              27's state (counted there); (c) the wire dtype at full width:
              ``ota.add_awgn`` on llama3.2-3b's whole gradient (its leaves'
              shapes and dtypes from phase 27), one (1, d) K1 launch read
              in bf16 and no aten float narrowing of the row before it but
              the wire hop of the three float32 norm-scale leaves, then
              with the native wire one float32 launch and none.

``python3 chip_smoke.py --agent-mesh-across-cards`` runs phases 1, 2 and
31's mesh over every visible card alone, then the card test of the mesh
over every card (a machine with several cards), and writes
``chiprun_out/agent_mesh_cards.json``.  ``python3 chip_smoke.py
--sharded-serve-across-cards`` (four cards) runs phases 1, 2 and 40 (with
llama3.2-3b over (1, 4) and (2, 2)), then 40e (llama3.2-3b at full width
and depth, batch 1, in ``long_500k``'s 8192-slot cache sequence-sharded
over (4, 1) and (2, 2), float32 and bf16: a prompt of 8192 through K3,
4 steps that wrap the ring into rank 0's slots, against one card fed the
same tokens; ms a step, collectives a step, cache GB a rank), then
deepseek-67b at full width over (1, 4) and cut to 4 layers against one
card's unsharded run, vision over (1, 4) and (2, 2), K3 and K4 at the
ranks' local shapes, then the card test of the sharded serve over every
card, and writes ``chiprun_out/sharded_serve_cards.json``.  ``python3 chip_smoke.py
--sharded-train-across-cards`` (four cards) runs phases 1 and 2, then
llama3.2-3b at full width and depth through the sharded train step on one
card's (1, 1) mesh and over (4, 1), (2, 2) and (1, 4), 3 steps each (ms a
step, GB held and peak a rank, the collectives a step, every rank's
metrics bitwise, loss, grad norm and update norm within 2e-2 of the one
card's), then one more step a rank under the profiler (device busy time,
the nccl kernels' part, the top kernels), and writes
``chiprun_out/sharded_train_cards.json``.  ``python3 chip_smoke.py
--dryrun-against-card`` runs phases 1, 2 and 45 alone, its (c) with
llama3.2-3b's and deepseek-67b's ``train_4k`` as well (minutes of
tracing each), and writes ``chiprun_out/dryrun_against_card.json``.
``python3 chip_smoke.py --analyze-against-card`` runs phases 1, 2, 27 (for
46(b)'s train step and 46(c)'s leaves) and 46 alone, and writes
``chiprun_out/analyze_against_card.json``.

It prints the card line, then one ``{"kernels": [...]}`` line (K1 as its two
bodies, ``ota_fused_wide`` and ``ota_fused_tall``), and as its last
line ``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM, bf16 tensor cores, dense
BF16_ULP = 2 ** -7   # one bf16 ulp of a value, at most, relative to it
FLOOR_SEEDS = (0, 1, 2)
K3_CASES = [  # (b, h, hkv, s, dh, causal, window)
    (1, 2, 2, 128, 64, True, None),       # g=1
    (2, 4, 2, 256, 64, True, None),       # g=2
    (1, 6, 2, 200, 112, True, None),      # g=3, zamba2's head dim, ragged
    (1, 8, 2, 256, 128, True, None),      # g=4
    (1, 2, 1, 1000, 64, True, 128),       # sliding window, ragged
    (2, 2, 2, 384, 64, False, None),      # bidirectional
    (4, 24, 8, 48, 128, True, None),      # a short prompt
    (4, 24, 8, 2048, 128, True, None),    # llama3.2-3b's prefill
    (4, 16, 8, 2048, 64, True, None),     # granite-moe-1b-a400m's prefill
    (4, 32, 8, 2048, 128, True, None),    # llama-3.2-vision-11b's prefill
    (4, 16, 16, 512, 64, False, None),    # seamless-m4t-large-v2's encoder
    (4, 16, 16, 2048, 64, True, None),    # seamless-m4t-large-v2's decoder
]
K3_EDGE_CASES = [  # (b, h, hkv, sq, sk, dh, causal, window, row pad)
    (1, 3, 1, 130, 300, 128, True, None, 0),   # Sq != Sk, neither of 128
    (1, 4, 2, 300, 170, 80, True, None, 0),    # Dh 80: a box of zero columns
    (1, 2, 2, 200, 200, 112, True, 64, 0),     # Dh 112 with a window
    (1, 2, 2, 200, 200, 72, True, None, 0),    # Dh 72: the f32-core kernel
    (1, 2, 2, 200, 200, 64, True, None, 4),    # stride 68: the f32-core kernel
]
K3_BLIND_CASES = [  # (key position stride, shift, window): queries that see
    (1, 100, None),   # no key: the first 100, and every odd one
    (2, 0, 1),
]
K4_CASES = [  # (b, s, h, p, g, n, chunk): tests/test_kernels.py:69-72, the models
    (1, 128, 2, 64, 1, 64, 64),
    (2, 256, 4, 64, 1, 128, 128),
    (1, 256, 4, 32, 2, 16, 64),
    (2, 128, 8, 64, 2, 64, 32),
    (4, 2048, 24, 64, 1, 128, 128),
    (4, 2048, 112, 64, 1, 64, 128),  # zamba2-7b's prefill
]
K4_EDGE_CASES = [  # P and S not multiples of the 16-column slice and the chunk
    (1, 200, 2, 40, 1, 16, 64),
    (1, 300, 3, 24, 1, 32, 40),      # a chunk that is not a multiple of 16
    (2, 48, 4, 32, 1, 16, 128),      # S < chunk: chunk = S
    (1, 130, 2, 8, 1, 8, 128),       # one slice narrower than 16
    (1, 128, 2, 36, 1, 16, 64),      # P = 36: the f32-core kernel
]
K34 = ("flash_attention", "flash_attention_wgmma", "ssd_scan", "ssd_scan_tc")
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 32
K1_SHAPES = [(1, 165), (10, 165), (33, 165), (64, 165), (65, 165),
             (7, 1000), (10_000, 165), (100_000, 165), (8, 2 ** 21 + 3)]
K1_LANE_CASES = [(3, 4, 800), (20, 10, 165)]   # (lanes, A, P)
K1_TIME_SHAPES = [(10, 165), (33, 165), (65, 165), (10_000, 165),
                  (100_000, 165), (8, 2 ** 21)]
K1_SWEEP = ([(a, 165) for a in (32, 48, 64, 256, 1024, 4096, 10_000,
                                 100_000)]
            + [(a, p) for p in (330, 500) for a in (64, 128, 1024, 10_000)]
            + [(a, p) for p in (700, 1000) for a in (1024, 4096, 10_000)])
L2_BYTES = 50e6                # H100 SXM L2
K2_SHAPES = [(7,), (37, 65), (3, 5, 129), (4096, 1024), (2 ** 26,)]
RAYLEIGH_MH = 1.2533141373155003   # sqrt(pi / 2), Rayleigh(1)'s mean
STREAM_BLOCKS = (1, 3, 4, 10)
STREAM_COMPARE_ROUNDS = 10
LARGE_N = (10 ** 2, 10 ** 3, 10 ** 4, 10 ** 5)
LARGE_BLOCKS = 32              # benchmarks/fig_large_n.py's agent_blocks
PC_RUNS = 3
FIG12_ROUNDS, FIG12_ALPHA, FIG12_RUNS = 250, 1e-3, 20
FIG12_TAIL = 20                # SweepResult.final_reward's last 20 rounds
LANE_ROUNDS, LANE_RUNS = 10, 4
BATCH_RUNS = (1, 5, 20, 100)
BATCH_ROUNDS = 20
BATCH_K1_LANES = (20, 100)
TEL_ROUNDS = 50
MAIN_ROUNDS = 100
SERVICE_STREAM_ROUNDS = 10     # streamed service runs: K cut from 100
SERVICE_LARGE_N = 10 ** 4      # benchmarks/fig_participation.py
SERVICE_LARGE_ROUNDS = 5
LARGE_SERVICE_BLOCKS = 64      # benchmarks/fig_participation.py
ET_REF_RUNS = 20               # perf/et_reference.json's runs a setting
ET_RUNS = 8                    # the port's ET runs, one after another
ET_TAU_SEEDS = 2               # seeds whose two tau runs are held bitwise
ZOO_ROUNDS = 20
ZOO_GRAD_AGENTS, ZOO_GRAD_M = 100, 100
STREAMED_LANE_BLOCKS = 4
STREAMED_LANE_RUNS = (1, 5, 20)
STREAMED_LANE_ROUNDS = 20
STREAMED_LANE_TURNS = 2
STREAMED_SERVICE_RUNS = 5
LARGE_LANE_N, LARGE_LANE_RUNS = 10 ** 4, 4   # benchmarks/fig_large_n.py
LARGE_LANE_BLOCKS = 1000
LANE_FOLD_SHAPES = [(20, 5, 165), (4, 1001, 165)]   # (lanes, 1 + b, P)
SHARDED_RUNS, SHARDED_ROUNDS = 4, 10
RECORD = {}


def log(*args):
    print(*args, flush=True)


def phase(name):
    log(f"\n=== {name} ===")
    return time.perf_counter()


def done(name, t0):
    dt = time.perf_counter() - t0
    RECORD.setdefault("phase_seconds", {})[name] = dt
    log(f"--- {name}: {dt:.1f} s")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------

def device_ms(torch, fn, iters=60, warmup=5, sleep_cycles=2_000_000):
    """Median device time of ``fn`` in ms, by CUDA events around each call.
    A spin kernel before each call (``sleep_cycles`` clock cycles) keeps
    the card busy while the host enqueues the call, so the events bracket
    device work, not host launch overhead; a call of many small launches
    needs a longer spin."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(sleep_cycles)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def k1_bound(n_agents, n_params, wire_bytes, mode):
    """Least time in ms for the function K1 computes: bytes moved (each
    input read once, each output written once) over HBM bandwidth, against
    float32 operations over the non-tensor-core peak."""
    n_state = {"agg": 0, "sgd": 1}[mode]
    nbytes = (n_agents * n_params * wire_bytes + 4 * n_agents
              + 4 * n_params * (n_state + 1))
    # matvec 2AP; noise ~14 per element (uniforms, log, sqrt, cos,
    # products); sigma and scale 3; the sgd step 2
    flops = 2 * n_agents * n_params + (17 + 2 * n_state) * n_params
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_fold_floor(n_agents):
    """Least time in ms of K1's contract, a strict sequential fold: one
    dependent float add per agent, about 4 clocks each at the card's
    maximum SM clock (``phase_card``), whatever the bandwidth."""
    return n_agents * 4 / (RECORD["sm_clock_max_mhz"] * 1e6) * 1e3


def k1_forced(body):
    """Within the block every CUDA call of K1 takes ``body`` ("wide" or
    "tall"), whatever the dispatch rule says: to time or check one body
    beside the other on the same inputs."""
    from unittest import mock

    from repro_torch.kernels import ota_fused

    return mock.patch.object(ota_fused, "k1_body", lambda *a, **k: body)


def k1_bodies(n_params):
    """K1's bodies that take P (the tall one up to ``TALL_MAX_PARAMS``)."""
    from repro_torch.kernels import ota_fused

    return [b for b in ota_fused.BODIES
            if b == "wide" or n_params <= ota_fused.TALL_MAX_PARAMS]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card(torch):
    t0 = phase("1. card")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    RECORD["sm_clock_max_mhz"] = float(clock)
    log(f"max SM clock {clock} MHz")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    RECORD["card"] = {"nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "name": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}
    done("card", t0)
    return smi


def phase_build():
    from repro_torch.kernels import build

    t0 = phase("2. build")
    built = build.build()
    for name, b in built.items():
        # ptxas -v: per entry function, registers, shared memory and spills
        log(f"{name}: {b.path.name}")
        log("\n".join(line.strip() for line in b.log.splitlines()
                      if any(w in line for w in ("Compiling entry", "registers",
                                                  "spill", "smem", "arning"))))
    RECORD["ptxas"] = {name: b.log for name, b in built.items()}
    check(set(counters()) <= set(built),
          f"a kernel source is missing: built {sorted(built)}")
    # which tensor-core instructions the tensor-core kernels compiled to
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = {}
    for name in ("flash_attention_wgmma", "ssd_scan_tc"):
        text = subprocess.run([str(cuobjdump), "-sass", str(built[name].path)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        sass[name] = {op: sum(f" {op}." in line for line in text.splitlines())
                      for op in ("HGMMA", "HMMA")}
        log(f"{name} SASS: {sass[name]['HGMMA']} HGMMA, "
            f"{sass[name]['HMMA']} HMMA instructions")
    check(sass["flash_attention_wgmma"]["HGMMA"] > 0,
          "the wgmma K3 compiled to no HGMMA")
    RECORD["sass"] = sass
    done("build", t0)


def k1_inputs(torch, n_agents, n_params, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = dict(device="cuda", dtype=torch.float32, generator=gen)
    g = torch.randn(n_agents, n_params, **f32)
    h = torch.rand(n_agents, **f32) + 0.1
    p = torch.randn(n_params, **f32)
    mu = torch.randn(n_params, **f32) * 0.1
    nu = torch.rand(n_params, **f32) * 0.01
    return g, h, p, mu, nu


def phase_k1(torch):
    from repro_torch.core import ota as ota_lib
    from repro_torch.kernels import ota_fused, ref

    t0 = phase("3. K1 against its plain version")
    max_err = 0.0
    body_err = {"wide": 0.0, "tall": 0.0}
    checks = 0
    rescale_checks = 0

    # counter stream: bits and uniforms bitwise, normals to a few ulp,
    # statistics over 2^22 draws
    n = 2 ** 22
    seed_dev = torch.tensor(0xDEADBEEF, dtype=torch.int64, device="cuda")
    for seed in (0, 123, 2 ** 32 - 1, seed_dev):
        kb = ota_fused.counter_bits(seed, n, "cuda")
        pb = ref.counter_bits(seed, n, "cuda")
        check(all(torch.equal(a, b) for a, b in zip(kb, pb)),
              f"counter bits differ (seed {seed})")
        ku, pu = ref.uniforms(*kb), ref.uniforms(*pb)
        check(all(torch.equal(a, b) for a, b in zip(ku, pu)),
              "uniforms differ")
        kn = ota_fused.fused_aggregate(
            torch.zeros(1, n, device="cuda"), torch.ones(1, device="cuda"),
            sigma=1.0, scale=1.0, seed=seed)
        pn = ref.counter_noise(seed, n, "cuda")
        torch.testing.assert_close(kn, pn, rtol=1e-6, atol=1e-6)
        mean, var = kn.double().mean().item(), kn.double().var().item()
        check(abs(mean) < 5e-3 and abs(var - 1.0) < 5e-3,
              f"noise moments mean={mean} var={var}")
        checks += 1
    log(f"counter stream: bits+uniforms bitwise over 2^22 for 4 seeds; "
        f"last noise mean={mean:.2e} var={var:.6f}")

    for n_agents, n_params in K1_SHAPES:
        g, h, p, mu, nu = k1_inputs(torch, n_agents, n_params,
                                    n_agents + n_params)
        seed = n_agents * 7919 + n_params
        noise = ota_fused.fused_aggregate(
            torch.zeros(1, n_params, device="cuda"),
            torch.ones(1, device="cuda"), sigma=1.0, scale=1.0, seed=seed)
        kw = dict(sigma=0.5, scale=1.0 / (n_agents * 1.2533141373155), seed=seed)
        rkw = dict(sigma=kw["sigma"], scale=kw["scale"])
        akw = dict(alpha=1e-3, step=7, b1=0.9, b2=0.999, eps=1e-8)
        bodies = k1_bodies(n_params)
        for wire in (None, torch.bfloat16):
            gw = g if wire is None else g.to(wire)
            # the plain versions, once for both bodies.  Their fold
            # sum_a h_a g_a (A sequential adds, the costly part at A = 10^5)
            # is made once (sigma 0, scale 1: (0 + sum) * 1 is the sum);
            # each version then folds it as a one-agent stack of unit gain,
            # where 0 + 1 * sum is the sum bit for bit, and finishes it
            acc = ref.ota_fused_ref(gw, h)[None]
            unit = torch.ones(1, device="cuda")
            want = ref.ota_fused_ref(acc, unit, noise, **rkw)
            want0 = ref.ota_fused_ref(acc, unit, None, **rkw)
            want_s = ref.ota_fused_sgd_ref(acc, unit, p, noise, alpha=0.05,
                                           **rkw)
            want_a = ref.ota_fused_adam_ref(acc, unit, p, mu, nu, noise,
                                            **akw, **rkw)
            # the device rescale factor (the round service's N / W, made
            # on the card as the streamed round makes it)
            factors = [ota_lib._participation_rescale(
                n_agents, torch.tensor(w, device="cuda")).reshape(1)
                for w in (3.0, 7.0, 0.0)]
            want_r = [(ref.ota_fused_ref(acc, unit, noise, rescale=r, **rkw),
                       ref.ota_fused_sgd_ref(acc, unit, p, noise, alpha=0.05,
                                             rescale=r, **rkw))
                      for r in factors]
            outs = {}
            for body in bodies:
                with k1_forced(body):
                    # agg: bitwise, noisy and noiseless, and invariant to
                    # threads (the wide body's block size)
                    a128 = ota_fused.fused_aggregate(g, h, wire_dtype=wire,
                                                     threads=128, **kw)
                    a512 = ota_fused.fused_aggregate(g, h, wire_dtype=wire,
                                                     threads=512, **kw)
                    check(torch.equal(a128, a512), "agg depends on threads")
                    check(torch.equal(a128, want),
                          f"{body} agg not bitwise at {(n_agents, n_params)} "
                          f"wire={wire}: max err "
                          f"{(a128 - want).abs().max().item()}")
                    a0 = ota_fused.fused_aggregate(g, h, wire_dtype=wire,
                                                   with_noise=False, **kw)
                    check(torch.equal(a0, want0),
                          f"{body} noiseless agg not bitwise")
                    # sgd and adam: rtol 1e-6
                    s128 = ota_fused.fused_aggregate_sgd(
                        g, h, p, alpha=0.05, wire_dtype=wire, threads=128,
                        **kw)
                    s512 = ota_fused.fused_aggregate_sgd(
                        g, h, p, alpha=0.05, wire_dtype=wire, threads=512,
                        **kw)
                    check(torch.equal(s128, s512), "sgd depends on threads")
                    torch.testing.assert_close(s128, want_s, rtol=1e-6,
                                               atol=1e-7)
                    ad = ota_fused.fused_aggregate_adam(
                        g, h, p, mu, nu, wire_dtype=wire, **akw, **kw)
                    ad512 = ota_fused.fused_aggregate_adam(
                        g, h, p, mu, nu, wire_dtype=wire, threads=512, **akw,
                        **kw)
                    for x, y, z in zip(ad, ad512, want_a):
                        check(torch.equal(x, y), "adam depends on threads")
                        torch.testing.assert_close(x, z, rtol=1e-6, atol=1e-7)
                    # agg with the factor bitwise, sgd rtol 1e-6, a zero
                    # factor a zero update
                    for r, w, (wa, ws) in zip(factors, (3, 7, 0), want_r):
                        ar = ota_fused.fused_aggregate(g, h, wire_dtype=wire,
                                                       rescale=r, **kw)
                        check(torch.equal(ar, wa),
                              f"{body} agg with rescale not bitwise at "
                              f"{(n_agents, n_params)} wire={wire} W={w}")
                        check(w > 0 or not bool(torch.any(ar != 0)),
                              "a zero rescale left a nonzero update")
                        sr = ota_fused.fused_aggregate_sgd(
                            g, h, p, alpha=0.05, wire_dtype=wire, rescale=r,
                            **kw)
                        torch.testing.assert_close(sr, ws, rtol=1e-6,
                                                   atol=1e-7)
                        rescale_checks += 1
                outs[body] = [a128, s128, *ad]
                errs = [(s128 - want_s).abs().max().item()] + [
                    (x - z).abs().max().item() for x, z in zip(ad, want_a)]
                max_err = max(max_err, *errs)
                body_err[body] = max(body_err[body], *errs)
                checks += 1
                log(f"K1 {body} (A={n_agents}, P={n_params}) wire="
                    f"{'bf16' if wire else 'f32'}: agg bitwise, sgd/adam max "
                    f"abs err {max(errs):.3e}; device rescale N/W for W 3, 7, "
                    f"0: agg bitwise, sgd rtol 1e-6")
            if len(outs) == 2:
                check(all(torch.equal(x, y)
                          for x, y in zip(outs["wide"], outs["tall"])),
                      f"the bodies differ at {(n_agents, n_params)}")
            else:  # a stack the tall body cannot take: it refuses it
                try:
                    with k1_forced("tall"):
                        ota_fused.fused_aggregate(g, h, wire_dtype=wire, **kw)
                except ValueError:
                    pass
                else:
                    raise AssertionError(f"the tall body took P={n_params}")
        del g, p, mu, nu
    # a view off the 16-byte grid (rows 1.. of a 10^4 + 1 stack): the rule
    # gives it to the wide body before launch; a forced tall body refuses it
    g, h, _, _, _ = k1_inputs(torch, 10_001, 165, 9)
    view, hv = g[1:], h[1:]
    check(view.data_ptr() % 16 and ota_fused.k1_body(10_000, 165) == "tall",
          "the view is aligned, or the rule keeps 10^4 wide")
    wide0 = ota_fused.LAUNCHES_WIDE
    got = ota_fused.fused_aggregate(view, hv, sigma=0.5, seed=3)
    check(ota_fused.LAUNCHES_WIDE == wide0 + 1,
          "the rule sent an unaligned view to the tall body")
    check(torch.equal(got, ref.ota_fused_ref(
        view, hv, ref.counter_noise(3, 165, "cuda"), sigma=0.5, scale=1.0)),
          "agg of an unaligned view not bitwise")
    try:
        with k1_forced("tall"):
            ota_fused.fused_aggregate(view, hv)
    except ValueError:
        pass
    else:
        raise AssertionError("the tall body took an unaligned view")
    log("K1 unaligned view (10^4, 165): the rule launched the wide body, agg "
        "bitwise; the tall body forced refuses it")
    del g, view
    lane_checks = k1_lane_checks(torch)
    torch.cuda.synchronize()
    RECORD["k1_parity"] = {"checks": checks, "max_abs_err": max_err,
                           "max_abs_err_by_body": body_err,
                           "rescale_checks": rescale_checks,
                           "lane_checks": lane_checks}
    done("K1", t0)
    return body_err


def k1_lane_checks(torch):
    """K1's lane axis, per body: lanes with per-lane sigma, scale, alpha,
    seed and rescale on the card, the stack shared or per lane; agg bitwise
    the plain lane loop, and every lane (agg and sgd) bitwise a one-lane
    launch of the same body.  Per-lane stacks off the 16-byte grid, which
    the rule keeps wide, are refused by the tall body."""
    from repro_torch.kernels import ota_fused, ref

    n = 0
    for lanes, a, p in K1_LANE_CASES:
        gen = torch.Generator(device="cuda").manual_seed(lanes * a + p)
        f32 = dict(device="cuda", dtype=torch.float32, generator=gen)
        sig, sc, al, r = (torch.rand(lanes, **f32) for _ in range(4))
        seeds = torch.arange(lanes, device="cuda", dtype=torch.int64) * 7 + 3
        params = torch.randn(lanes, p, **f32)
        for shared in (True, False):
            g = torch.randn((a, p) if shared else (lanes, a, p), **f32)
            h = torch.rand(lanes, a, **f32) + 0.1
            noise = torch.stack([ref.counter_noise(int(x), p, "cuda")
                                 for x in seeds])
            want = ref.ota_fused_lanes_ref(
                g.expand(lanes, a, p), h, noise, sigma=sig.tolist(),
                scale=sc.tolist(), rescale=r)
            for body in ota_fused.BODIES:
                with k1_forced(body):
                    if body == "tall" and not shared and (a * p * 4) % 16:
                        try:
                            ota_fused.fused_aggregate_lanes(g, h, sigma=sig)
                        except ValueError:
                            continue
                        raise AssertionError("the tall body took lane "
                                             "stacks off the 16-byte grid")
                    agg = ota_fused.fused_aggregate_lanes(
                        g, h, sigma=sig, scale=sc, seed=seeds, rescale=r)
                    sgd = ota_fused.fused_aggregate_sgd_lanes(
                        g, h, params, alpha=al, sigma=sig, scale=sc,
                        seed=seeds)
                    check(torch.equal(agg, want),
                          f"{body} lanes {(lanes, a, p)}: agg not bitwise "
                          f"the plain lane loop")
                    for lane in range(lanes):
                        gl = g if shared else g[lane].clone()
                        one = dict(sigma=sig[lane].item(),
                                   scale=sc[lane].item(),
                                   seed=int(seeds[lane]))
                        check(torch.equal(agg[lane], ota_fused.fused_aggregate(
                            gl, h[lane].clone(),
                            rescale=r[lane:lane + 1].clone(), **one))
                              and torch.equal(
                                  sgd[lane], ota_fused.fused_aggregate_sgd(
                                      gl, h[lane].clone(),
                                      params[lane].clone(),
                                      alpha=al[lane].item(), **one)),
                              f"{body} lane {lane} of {(lanes, a, p)} is not "
                              f"bitwise its one-lane launch")
                n += 1
                log(f"K1 {body} lanes {lanes} x (A={a}, P={p}), stack "
                    f"{'shared' if shared else 'per lane'}: agg bitwise the "
                    f"plain lane loop, every lane bitwise its one-lane launch")
    return n


def alg_config(n_agents, batch_m, n_rounds):
    from repro_torch.configs.ota_pg_particle import RAYLEIGH
    from repro_torch.core.channel import make_channel
    from repro_torch.core.fedpg import FedPGConfig
    from repro_torch.core.ota import OTAConfig

    cfg = FedPGConfig(n_agents=n_agents, batch_m=batch_m,
                      horizon=RAYLEIGH.horizon, gamma=RAYLEIGH.gamma,
                      alpha=1e-3, n_rounds=n_rounds)
    ota = OTAConfig(make_channel(RAYLEIGH.channel,
                                 **dict(RAYLEIGH.channel_kwargs)),
                    noise_sigma=RAYLEIGH.noise_sigma, debias=True)
    return cfg, ota


def timed_run(torch, fedpg, env, pol, cfg, ota, seed, backend="auto",
              agent_blocks=None):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    theta, hist = fedpg.run(env, pol, cfg, seed, ota=ota, ota_backend=backend,
                            agent_blocks=agent_blocks, device="cuda")
    e.record()
    torch.cuda.synchronize()
    return theta, hist, s.elapsed_time(e) / cfg.n_rounds


def phase_main(torch):
    from repro_torch.core import fedpg
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    t0 = phase("4. main path: Algorithm 2 at the paper's width")
    env, pol = LandmarkNav(), MLPPolicy()
    cfg, ota = alg_config(10, 10, MAIN_ROUNDS)
    d = sum(x.numel() for x in pol.init(torch.Generator(), "cpu").values())
    log(f"N={cfg.n_agents} M={cfg.batch_m} T={cfg.horizon} d={d} "
        f"alpha={cfg.alpha} sigma={ota.noise_sigma:.3e} debias={ota.debias} "
        f"K={cfg.n_rounds}")
    # warm-up (library load, first-call set-up), outside the counted run
    fedpg.run(env, pol, alg_config(10, 10, 3)[0], 99, ota=ota, device="cuda")
    torch.cuda.synchronize()

    results = {}
    for name, o in (("alg2", ota), ("alg1", None)):
        reset_counts()
        theta, hist, ms = timed_run(torch, fedpg, env, pol, cfg, o, 0)
        launches = read_counts()["ota_fused"]
        bodies = k1_body_counts()
        expect = cfg.n_rounds if o is not None else 0
        check(launches == expect == bodies["wide"],
              f"{name}: {launches} K1 launches ({bodies}), expected "
              f"{expect}, all of the wide body")
        for field, x in zip(hist._fields, hist):
            check(x.shape == (cfg.n_rounds,) and bool(torch.isfinite(x).all()),
                  f"{name} history {field} not finite / wrong shape")
        check(all(bool(torch.isfinite(v).all()) for v in theta.values()),
              f"{name} theta not finite")
        r = hist.rewards
        results[name] = {
            "launches": launches, "ms_per_round": ms,
            "reward_first10": r[:10].mean().item(),
            "reward_last10": r[-10:].mean().item(),
            "avg_grad_sq": fedpg.avg_grad_sq(hist).item(),
            "gain_mean": hist.gain_mean.mean().item()}
        log(f"{name}: K1 launches={launches} ms/round={ms:.3f} "
            f"reward first10={results[name]['reward_first10']:.4f} "
            f"last10={results[name]['reward_last10']:.4f} "
            f"avg_grad_sq={results[name]['avg_grad_sq']:.4f} "
            f"gain_mean={results[name]['gain_mean']:.4f}")

    # small input: the kernel path against the plain chain on the card,
    # same generator, hence the same rollouts, gains and kernel seeds
    small, small_ota = alg_config(3, 2, 4)
    small = dataclasses.replace(small, horizon=6)
    _, hk, _ = timed_run(torch, fedpg, env, pol, small, small_ota, 5, "cuda")
    _, hp, _ = timed_run(torch, fedpg, env, pol, small, small_ota, 5, "torch")
    for x, y in zip(hk, hp):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    log("small run (N=3 M=2 T=6 K=4): kernel path == plain chain "
        "(rtol 1e-5)")
    RECORD["main"] = results
    done("main", t0)
    return results["alg2"]["launches"], results


def phase_fig12(torch):
    """The North star's table through the port's sweep engine (``"vmap"``:
    each (N, M) a partition of 20 lanes, one K1 lane-form launch a round),
    held to the JAX package's 20-run means in ``perf/fig12_reference.json``
    (``perf/fig12_reference.py``)."""
    from repro_torch import figures
    from repro_torch.core import sweep
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    t0 = phase(f"5. Fig. 1-2 table through the port's sweep (vmap, "
               f"K={FIG12_ROUNDS}, {FIG12_RUNS} runs)")
    ref = reference("fig12_reference.json")
    want = {(r["n_agents"], r["batch_m"]): r for r in ref["rows"]}
    check(ref["setting"]["runs"] == FIG12_RUNS
          and ref["setting"]["n_rounds"] == FIG12_ROUNDS,
          "perf/fig12_reference.json holds another setting")
    scens = figures.fig12_scenarios(FIG12_ROUNDS, FIG12_ALPHA)
    check(len(sweep.partition_scenarios(scens))
          == len(figures.FIG12_SETTINGS),
          "each (N, M) must be its own partition")
    env, pol = LandmarkNav(), MLPPolicy()
    # warm-up (first calls of the lane path), outside the timed partitions
    sweep.sweep(env, pol, [dataclasses.replace(scens[0], n_rounds=2)], 0,
                FIG12_RUNS, device="cuda")
    g, table = {}, []
    for s in scens:
        n, m = s.n_agents, s.batch_m
        res, per_run_g, per_run_r, launches, ms = sweep_partition(
            torch, env, pol, s, 0, FIG12_RUNS, FIG12_ROUNDS,
            f"fig12 N={n} M={m}")
        FIG12_RESULTS.append(res)
        body = [b for b, c in k1_body_counts().items() if c]
        w = want[(n, m)]
        gm, gse, z_g = figures.hold(per_run_g, w["avg_grad_sq"],
                                    w["avg_grad_sq_se"])
        _, rse, z_r = figures.hold(per_run_r, w["final_reward"],
                                   w["final_reward_se"])
        g[(n, m)] = gm
        row = {"N": n, "M": m, "avg_grad_sq": res.avg_grad_sq(0),
               "avg_grad_sq_se": gse, "final_reward": res.final_reward(0),
               "final_reward_se": rse, "ref_avg_grad_sq": w["avg_grad_sq"],
               "ref_avg_grad_sq_se": w["avg_grad_sq_se"],
               "ref_final_reward": w["final_reward"],
               "ref_final_reward_se": w["final_reward_se"],
               "z_avg_grad_sq": z_g, "z_final_reward": z_r,
               "k1_launches": launches, "k1_body": body[0],
               "lanes_per_launch": FIG12_RUNS,
               "ms_per_batched_round": ms,
               "seconds": res.partitions[0].wall_time_us / 1e6}
        table.append(row)
        log(f"N={n:2d} M={m:2d}: avg_grad_sq {row['avg_grad_sq']:.2f} +- "
            f"{gse:.2f} (reference {w['avg_grad_sq']:.2f} +- "
            f"{w['avg_grad_sq_se']:.2f}, z {z_g:+.2f}) | final reward "
            f"{row['final_reward']:.3f} +- {rse:.3f} (reference "
            f"{w['final_reward']:.3f} +- {w['final_reward_se']:.3f}, z "
            f"{z_r:+.2f}) | K1 {launches} launches of the {body[0]} body, "
            f"{FIG12_RUNS} lanes each | {ms:.3f} ms per batched round, "
            f"{row['seconds']:.1f} s")
        check(abs(z_g) < figures.HOLD_Z,
              f"N={n} M={m}: avg_grad_sq {gm} is {z_g:+.2f} combined "
              f"standard errors from the reference's {w['avg_grad_sq']}")
    flags = {"decreases_in_N": g[(1, 10)] > g[(5, 10)] > g[(10, 10)],
             "decreases_in_M": g[(10, 1)] > g[(10, 5)] > g[(10, 10)]}
    log(f"g(1,10) > g(5,10) > g(10,10): {flags['decreases_in_N']}; "
        f"g(10,1) > g(10,5) > g(10,10): {flags['decreases_in_M']}")
    check(all(flags.values()), f"a Fig. 1-2 trend failed: {flags}")
    RECORD["fig12"] = {"table": table, "flags": flags,
                       "reference": {"jax_version": ref["jax_version"],
                                     "platform": ref["platform"]}}
    done("fig12", t0)
    return table


def history_bitwise(torch, a, b_hist, i):
    """``a`` (one run's History, tensors) against lane ``i`` of ``b_hist``."""
    return all(torch.equal(x, y[i]) for x, y in zip(a, b_hist))


def phase_lanes(torch):
    """A grid that varies alpha, noise sigma and the Rayleigh scale (one
    BatchedChannel partition), a TruncatedInversion parameter, a windy
    LandmarkNav wind, a Bernoulli rate with staleness (4, 0.8), and the
    exact uplink: every (scenario, run) lane of the lane-batched run is
    bitwise ``fedpg.run`` on the card, history and theta_K; one K1 launch a
    round per over-the-air partition; ``sweep(mode="vmap")`` gives the same
    histories."""
    import numpy as np

    from repro_torch.core import fedpg, lanes, sweep
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.power_control import TruncatedInversion
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.envs import WindyLandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.service.participation import ParticipationConfig
    from repro_torch.service.staleness import StalenessConfig

    t0 = phase(f"23. lanes bitwise fedpg.run on the card (N=10 M=10 T=20, "
               f"K={LANE_ROUNDS}, {LANE_RUNS} runs)")
    size = dict(n_agents=10, batch_m=10, horizon=20, n_rounds=LANE_ROUNDS)
    ray = RayleighChannel
    scens = (sweep.grid(channel=[ray(1.0), ray(2.0)],
                        noise_sigma=[1e-3, 1e-2], alpha=[1e-3, 2e-3],
                        debias=True, **size)
             + sweep.grid(channel=ray(), noise_sigma=1e-3, debias=True,
                          power_control=[TruncatedInversion(p_max=5.0),
                                         TruncatedInversion(p_max=10.0)],
                          **size)
             + sweep.grid(channel=ray(), noise_sigma=1e-3, debias=True,
                          env=[WindyLandmarkNav(wind=0.05),
                               WindyLandmarkNav(wind=0.1)], **size)
             + sweep.grid(channel=ray(), noise_sigma=1e-3, debias=True,
                          participation=[ParticipationConfig(rate=0.5),
                                         ParticipationConfig(rate=0.8)],
                          staleness=StalenessConfig(4, 0.8), **size)
             + sweep.grid(channel=None, alpha=[1e-3, 2e-3], **size))
    env0, pol0 = LandmarkNav(), MLPPolicy()
    parts = sweep.partition_scenarios(scens)
    check(len(parts) == 5, f"{len(parts)} partitions, expected 5")
    seeds = fedpg.run_seeds(0, LANE_RUNS)
    lane_hist, rows = {}, []
    for part in parts:
        env, pol = sweep.resolve_env_policy(part.proto, env0, pol0)
        specs = [sweep._lane_spec(s, r, sweep.resolve_env_policy(
            s, env0, pol0)[0]) for s in part.scenarios for r in seeds]
        cfg = part.proto.fedpg_config()
        reset_counts()
        theta, hist = lanes.run_lanes(env, pol, cfg, specs, device="cuda")
        launches = read_counts()["ota_fused"]
        expect = 0 if part.proto.channel is None else LANE_ROUNDS
        check(launches == expect,
              f"partition {part.key[:3]}: {launches} K1 launches, expected "
              f"{expect} (one a round)")
        for i, spec in enumerate(specs):
            c = dataclasses.replace(cfg, alpha=spec.alpha)
            t1, h1 = fedpg.run(spec.env or env, pol, c, spec.seed,
                               ota=spec.ota, participation=spec.participation,
                               staleness=spec.staleness, device="cuda")
            check(history_bitwise(torch, h1, hist, i)
                  and all(torch.equal(t1[k], theta[k][i]) for k in t1),
                  f"lane {i} of partition {part.indices} is not bitwise its "
                  f"fedpg.run")
        for j, idx in enumerate(part.indices):
            lane_hist[idx] = [x[j * LANE_RUNS:(j + 1) * LANE_RUNS].cpu()
                              .numpy() for x in hist]
        packed = sorted(sweep._pack_partition(part))
        rows.append({"scenarios": len(part.indices), "lanes": len(specs),
                     "packed": packed, "k1_launches": launches})
        log(f"partition of {len(part.indices)} scenarios x {LANE_RUNS} runs "
            f"= {len(specs)} lanes, packed {packed}: every lane bitwise its "
            f"fedpg.run (history and theta_K); K1 launches {launches}")
    res = sweep.sweep(env0, pol0, scens, 0, LANE_RUNS, device="cuda")
    check(res.n_partitions == 5, "sweep partitions")
    for idx in range(len(scens)):
        check(all(np.array_equal(x[idx], y)
                  for x, y in zip(res.history, lane_hist[idx])),
              f"sweep(vmap) scenario {idx} differs from its lanes")
    log(f"sweep(mode='vmap') over the {len(scens)} scenarios: the same "
        f"histories, bitwise")
    RECORD["lanes"] = rows
    done("lanes", t0)


def lane_k1_inputs(torch, lanes, n_agents, n_params, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = dict(device="cuda", dtype=torch.float32, generator=gen)
    g = torch.randn(lanes, n_agents, n_params, **f32)
    h = torch.rand(lanes, n_agents, **f32) + 0.1
    p = torch.randn(lanes, n_params, **f32)
    sig = torch.full((lanes,), 1e-3, device="cuda")
    sc = torch.full((lanes,), 1.0 / (n_agents * RAYLEIGH_MH), device="cuda")
    al = torch.full((lanes,), 1e-3, device="cuda")
    seeds = torch.arange(lanes, device="cuda", dtype=torch.int64) * 7 + 3
    return g, h, p, sig, sc, al, seeds


def phase_batching(torch, one_run_ms):
    """The main cell (N=10 M=10 T=20 d=165) as R = 1, 5, 20, 100 lanes of
    one batched run: ms per batched round against R x phase 4's ms per
    round, with the device's busy share and launches per round (profiler);
    then K1's lane launch at (20, 10, 165) and (100, 10, 165) against R
    one-lane launches, the plain version, one PyTorch call
    (``torch.baddbmm``: the lanes' gain matvec plus the noise) and the
    byte bound."""
    from repro_torch.core import fedpg, lanes
    from repro_torch.kernels import ota_fused, ref
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    t0 = phase("24. what batching buys: the main cell as R lanes")
    env, pol = LandmarkNav(), MLPPolicy()
    cfg, ota = alg_config(10, 10, BATCH_ROUNDS)
    rows = []
    for runs in BATCH_RUNS:
        specs = [lanes.LaneSpec(s, cfg.alpha, ota)
                 for s in fedpg.run_seeds(0, runs)]
        lanes.run_lanes(env, pol, dataclasses.replace(cfg, n_rounds=2),
                        specs, device="cuda")
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        reset_counts()
        s.record()
        lanes.run_lanes(env, pol, cfg, specs, device="cuda")
        e.record()
        torch.cuda.synchronize()
        ms = s.elapsed_time(e) / BATCH_ROUNDS
        k1 = read_counts()["ota_fused"]
        check(k1 == BATCH_ROUNDS, f"R={runs}: {k1} K1 launches")
        prof = profile_rounds(torch, lambda: lanes.run_lanes(
            env, pol, dataclasses.replace(cfg, n_rounds=3), specs,
            device="cuda"), 3, ms)
        row = {"runs": runs, "ms_per_batched_round": ms,
               "runs_x_one_run_ms": runs * one_run_ms,
               "speedup": runs * one_run_ms / ms,
               "ms_per_run_round": ms / runs,
               "busy_share": prof["busy_share"],
               "device_launches_per_round":
                   prof["device_launches_per_round"],
               "device_busy_us_per_round": prof["device_busy_us_per_round"],
               "k1_us_per_round": prof["k1_us_per_round"]}
        rows.append(row)
        log(f"R={runs:3d}: {ms:.3f} ms per batched round against R x "
            f"{one_run_ms:.3f} = {runs * one_run_ms:.3f} ms "
            f"({row['speedup']:.2f}x; {ms / runs:.3f} ms per run-round); "
            f"device busy {prof['busy_share']:.2%}, "
            f"{prof['device_launches_per_round']:.0f} launches a round")
    lane_rows = []
    for n_lanes in BATCH_K1_LANES:
        g, h, p, sig, sc, al, seeds = lane_k1_inputs(torch, n_lanes, 10, 165,
                                                     n_lanes)
        one = [dict(sigma=1e-3, scale=1.0 / (10 * RAYLEIGH_MH), alpha=1e-3,
                    seed=seeds[i].clone()) for i in range(n_lanes)]
        gl = [g[i].clone() for i in range(n_lanes)]
        hl = [h[i].clone() for i in range(n_lanes)]
        pl = [p[i].clone() for i in range(n_lanes)]
        noise = torch.stack([ref.counter_noise(int(x), 165, "cuda")
                             for x in seeds])
        sn = (sig[:, None] * noise).unsqueeze(1)

        def lane_call():
            return ota_fused.fused_aggregate_sgd_lanes(
                g, h, p, alpha=al, sigma=sig, scale=sc, seed=seeds)

        def one_lane_calls():
            for i in range(n_lanes):
                ota_fused.fused_aggregate_sgd(gl[i], hl[i], pl[i], **one[i])

        def plain():
            nz = torch.stack([ref.counter_noise(s, 165, "cuda")
                              for s in seeds])
            return ref.ota_fused_sgd_lanes_ref(
                g, h, p, nz, alpha=[1e-3] * n_lanes, sigma=[1e-3] * n_lanes,
                scale=sc.tolist())

        lane_ms = device_ms(torch, lane_call)
        loop_ms = device_ms(torch, one_lane_calls,
                            sleep_cycles=2_000_000 * n_lanes // 4)
        plain_ms = device_ms(torch, plain, iters=10, warmup=2,
                             sleep_cycles=100_000_000)
        lib_ms = device_ms(torch, lambda: torch.baddbmm(
            sn, h.unsqueeze(1), g))
        want = plain()
        got = lane_call()
        err = (got - want).abs().max().item()
        check(err <= 1e-6 * want.abs().max().item(),
              f"K1 lanes ({n_lanes}, 10, 165) vs its plain version: {err}")
        per_lane_bytes = 10 * 165 * 4 + 10 * 4 + 2 * 165 * 4
        flops = n_lanes * (2 * 10 * 165 + 19 * 165)
        t_bytes = n_lanes * per_lane_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        row = {"lanes": n_lanes, "A": 10, "P": 165, "mode": "sgd",
               "body": ota_fused.k1_body(10, 165, torch.float32, n_lanes,
                                         g.data_ptr()),
               "ms": lane_ms, "one_lane_launches_ms": loop_ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_call": "torch.baddbmm(sigma*noise, h, G)",
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": err}
        lane_rows.append(row)
        log(f"K1 lanes ({n_lanes}, 10, 165) sgd, {row['body']} body: "
            f"{lane_ms * 1e3:.2f} us against {n_lanes} one-lane launches "
            f"{loop_ms * 1e3:.2f} us; plain {plain_ms:.3f} ms; "
            f"torch.baddbmm {lib_ms * 1e3:.2f} us; {row['bound_by']} bound "
            f"{row['bound_ms'] * 1e3:.4f} us; max |err| {err:.2e}")
    RECORD["batching"] = {"rounds": rows, "k1_lanes": lane_rows}
    done("batching", t0)
    return rows, lane_rows


def phase_telemetry(torch):
    """The main cell with ``TelemetryConfig()`` on and off: the histories
    and theta bitwise equal, the probes finite, the overhead per round and
    ``summarize``'s fields; then a sweep with telemetry (the Fig. 1-2
    scenarios at K=20, 4 runs) against the same sweep without it, and its
    span trace written to ``chiprun_out/sweep_trace.json``."""
    import numpy as np

    from repro_torch import figures
    from repro_torch.core import fedpg, sweep
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.telemetry import TelemetryConfig, summarize, trace

    t0 = phase(f"25. telemetry on and off (main cell, K={TEL_ROUNDS})")
    env, pol = LandmarkNav(), MLPPolicy()
    cfg, ota = alg_config(10, 10, TEL_ROUNDS)
    fedpg.run(env, pol, dataclasses.replace(cfg, n_rounds=3), 7, ota=ota,
              telemetry=TelemetryConfig(), device="cuda")
    runs = {}
    for name, tel in (("off", None), ("on", TelemetryConfig()),
                      ("off2", None), ("on2", TelemetryConfig())):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        theta, hist = fedpg.run(env, pol, cfg, 4, ota=ota, telemetry=tel,
                                device="cuda")
        e.record()
        torch.cuda.synchronize()
        runs[name] = (theta, hist, s.elapsed_time(e) / cfg.n_rounds)
    (t_off, h_off, _), (t_on, h_on, _) = runs["off"], runs["on"]
    check(all(torch.equal(x, y) for x, y in zip(h_off, h_on))
          and all(torch.equal(t_off[k], t_on[k]) for k in t_off),
          "telemetry on changed the history or theta")
    tel = h_on.telemetry
    check(h_off.telemetry is None and tel is not None, "telemetry fields")
    for name in ("snr", "grad_norm_pre", "grad_norm_post", "moment_drift",
                 "dispersion"):
        x = getattr(tel, name)
        check(x.shape == (cfg.n_rounds,) and bool(torch.isfinite(x).all()),
              f"probe {name} not finite")
    ms_off = statistics.mean([runs["off"][2], runs["off2"][2]])
    ms_on = statistics.mean([runs["on"][2], runs["on2"][2]])
    summary = summarize(tel)
    log(f"histories and theta bitwise equal with telemetry on and off; "
        f"ms/round off {ms_off:.3f}, on {ms_on:.3f} (overhead "
        f"{ms_on - ms_off:+.3f} ms, {ms_on / ms_off - 1:+.1%})")
    log("summarize: " + ", ".join(f"{k}={v:.6g}" for k, v in summary.items()))
    scens = figures.fig12_scenarios(20, FIG12_ALPHA)
    plain = sweep.sweep(env, pol, scens, 0, 4, device="cuda")
    trace.reset()
    with trace.span("fig12 sweep with telemetry", device="cuda"):
        res = sweep.sweep(env, pol, scens, 0, 4, device="cuda",
                          telemetry=TelemetryConfig())
    check(all(np.array_equal(x, y) for x, y in zip(plain.history,
                                                   res.history)),
          "sweep telemetry changed a history")
    sweep_summary = [res.telemetry_summary(i) for i in range(len(scens))]
    check(all(v is not None and v == v for row in sweep_summary
              for v in row.values()), "sweep probes not finite")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    doc = trace.export(str(out / "sweep_trace.json"))
    spans = [ev["name"] for ev in doc["traceEvents"] if ev["ph"] == "X"]
    check(spans.count("partition") == len(scens), f"spans {spans}")
    log(f"sweep with telemetry ({len(scens)} partitions x 4 runs, K=20): "
        f"histories bitwise the sweep without it; trace of {len(spans)} "
        f"spans in chiprun_out/sweep_trace.json; per-scenario snr "
        + ", ".join(f"{r['snr']:.3g}" for r in sweep_summary))
    RECORD["telemetry"] = {"ms_off": ms_off, "ms_on": ms_on,
                           "summary": summary,
                           "sweep_summary": sweep_summary,
                           "partition_us": [p.wall_time_us
                                            for p in res.partitions]}
    done("telemetry", t0)


def k1_turns(torch, fn, bodies, **kw):
    """``fn``'s device time with each of K1's bodies forced, in turns
    (a, b, b, a): the mean of the two timings of each."""
    order = list(bodies) + list(reversed(bodies))
    times = {b: [] for b in bodies}
    for b in order:
        with k1_forced(b):
            times[b].append(device_ms(torch, fn, **kw))
    return {b: statistics.mean(t) for b, t in times.items()}


def phase_times(torch):
    """K1 beside its bounds and PyTorch's matvec: at each shape, both bodies
    in turns (agg with and without noise), ``torch.mv(G.T, h)``, the byte
    bound and the sequential fold's floor; sgd and the plain version at the
    main path's shapes; then the A sweep the dispatch rule's crossover is
    read from."""
    from repro_torch.kernels import ota_fused, ref

    t0 = phase("6. K1 times (median of 60, CUDA events; bodies in turns)")
    rows = []
    for n_agents, n_params in K1_TIME_SHAPES:
        g, h, p, _, _ = k1_inputs(torch, n_agents, n_params, 1)
        kw = dict(sigma=1e-3, scale=1.0 / (n_agents * RAYLEIGH_MH), seed=17)
        bodies = k1_bodies(n_params)
        for wire in (torch.float32, torch.bfloat16):
            if wire == torch.bfloat16 and n_params < 2 ** 21 \
                    and n_agents != 10_000:
                continue
            gw = g.to(wire).contiguous()
            wb = gw.element_size()
            hw = h.to(wire)
            rule = ota_fused.k1_body(n_agents, n_params, wire)
            agg = k1_turns(torch, lambda: ota_fused.fused_aggregate(
                gw, h, **kw), bodies)
            agg0 = k1_turns(torch, lambda: ota_fused.fused_aggregate(
                gw, h, with_noise=False, scale=kw["scale"]), bodies)
            lib_ms = device_ms(torch, lambda: torch.mv(gw.T, hw))
            bound, by = k1_bound(n_agents, n_params, wb, "agg")
            nbytes = n_agents * n_params * wb
            row = {"A": n_agents, "P": n_params,
                   "wire": "bf16" if wb == 2 else "f32", "body": rule,
                   "ms": agg[rule], "agg_ms": agg, "agg_noiseless_ms": agg0,
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": lib_ms, "library_call": "torch.mv(G.T, h)",
                   "g_in_l2": nbytes < L2_BYTES}
            def noise():   # the plain version draws its noise each call
                return ref.counter_noise(17, n_params, "cuda")

            if n_agents == 10 or n_params >= 2 ** 21:
                # sgd and its plain version at the main path's shape (the
                # Algorithm-2 round) and at (8, 2^21)
                row["sgd_ms"] = device_ms(
                    torch, lambda: ota_fused.fused_aggregate_sgd(
                        gw, h, p, alpha=1e-3, **kw))
                row["plain_sgd_ms"] = device_ms(
                    torch, lambda: ref.ota_fused_sgd_ref(
                        gw, h, p, noise(), alpha=1e-3, sigma=kw["sigma"],
                        scale=kw["scale"]), sleep_cycles=20_000_000)
            if n_agents == 10_000:
                # agg's plain version at the stacked round's shape at 10^4
                row["plain_agg_ms"] = device_ms(
                    torch, lambda: ref.ota_fused_ref(
                        gw, h, noise(), sigma=kw["sigma"], scale=kw["scale"]),
                    iters=5, warmup=1, sleep_cycles=20_000_000)
            rows.append(row)
            other = [b for b in bodies if b != rule]
            floor = k1_fold_floor(n_agents)
            RECORD.setdefault("k1_fold_floor_ms", {})[n_agents] = floor
            log(f"(A={n_agents}, P={n_params}) {row['wire']}: rule {rule} "
                f"agg {agg[rule] * 1e3:.2f} us ({bound / agg[rule]:.2%} of "
                f"the {bound * 1e3:.4f} us {by} bound; fold floor "
                f"{floor * 1e3:.2f} us)"
                + "".join(f" | {b} {agg[b] * 1e3:.2f} us" for b in other)
                + f" | noiseless {', '.join(f'{b} {agg0[b] * 1e3:.2f}' for b in bodies)} us"
                f" | torch.mv {lib_ms * 1e3:.2f} us"
                + (f" | sgd {row['sgd_ms'] * 1e3:.2f} us, plain "
                   f"{row['plain_sgd_ms'] * 1e3:.2f} us" if "sgd_ms" in row
                   else "")
                + (f" | plain agg {row['plain_agg_ms']:.3f} ms"
                   if "plain_agg_ms" in row else "")
                + ("" if row["g_in_l2"] else " (G past the L2)"))
        del g, p
    sweep = []
    for n_agents, n_params in K1_SWEEP:
        g, h, _, _, _ = k1_inputs(torch, n_agents, n_params, 2)
        kw = dict(sigma=1e-3, scale=1.0 / n_agents, seed=5)
        agg = k1_turns(torch, lambda: ota_fused.fused_aggregate(g, h, **kw),
                       ota_fused.BODIES)
        rule = ota_fused.k1_body(n_agents, n_params)
        fastest = min(agg, key=agg.get)
        sweep.append({"A": n_agents, "P": n_params, "rule": rule,
                      "fastest": fastest, "agg_ms": agg})
        log(f"sweep (A={n_agents}, P={n_params}): wide "
            f"{agg['wide'] * 1e3:.2f} us, tall {agg['tall'] * 1e3:.2f} us; "
            f"the rule takes {rule}"
            + ("" if rule == fastest else
               f", {agg[rule] / agg[fastest] - 1:.1%} slower than {fastest}"))
        del g
    RECORD["times"] = rows
    RECORD["k1_sweep"] = sweep
    done("times", t0)
    return rows


def profile_rounds(torch, run, rounds, ms_per_round):
    """torch.profiler over ``run()`` (``rounds`` rounds): device time by
    kernel, launches per round, K1's time, and the device's busy share of
    an unprofiled round of ``ms_per_round``."""
    kernels, busy, _ = device_kernels(torch, run)
    busy /= rounds
    return {"device_busy_us_per_round": busy,
            "device_launches_per_round":
                sum(e.count for e in kernels) / rounds,
            "k1_us_per_round": sum(e.device_us for e in kernels
                                   if "ota_fused" in e.key) / rounds,
            "busy_share": busy / (ms_per_round * 1e3),
            "kernel_names": len(kernels),
            "top": [{"name": e.key[:90],
                     "device_us_per_round": e.device_us / rounds,
                     "launches_per_round": e.count / rounds}
                    for e in kernels[:12]]}


def phase_profile(torch, ms_per_round):
    """torch.profiler over 10 Algorithm-2 rounds at the paper's width:
    device time by kernel, launches per round, and the device's busy share
    of an unprofiled round (``ms_per_round`` from the main phase)."""
    from repro_torch.core import fedpg
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    t0 = phase("7. where the time goes: torch.profiler, 10 Algorithm-2 "
               "rounds")
    rounds = 10
    cfg, ota = alg_config(10, 10, rounds)
    res = profile_rounds(torch, lambda: fedpg.run(
        LandmarkNav(), MLPPolicy(), cfg, 2, ota=ota, device="cuda"), rounds,
        ms_per_round)
    for t in res["top"]:
        log(f"{t['device_us_per_round']:9.1f} us/round "
            f"x{t['launches_per_round']:6.1f}  {t['name']}")
    log(f"per round: device busy {res['device_busy_us_per_round']:.1f} us "
        f"over {res['device_launches_per_round']:.0f} device launches "
        f"({res['kernel_names']} kernel names); K1 "
        f"{res['k1_us_per_round']:.1f} us; busy share of an unprofiled "
        f"{ms_per_round:.3f} ms round {res['busy_share']:.2%}")
    RECORD["profile"] = res
    done("profile", t0)


# ---------------------------------------------------------------------------
# the serving path: K3 and K4
# ---------------------------------------------------------------------------

def counters():
    """Each kernel's launch counter: (wrapper module, attribute).  K1's
    (the sum of its two bodies') is reset here but read from the two
    (``k1_body_counts``)."""
    from repro_torch.kernels import (
        flash_attention, ota_channel, ota_fused, ssd_scan,
    )

    return {"ota_fused": (ota_fused, "LAUNCHES"),
            "ota_channel": (ota_channel, "LAUNCHES"),
            "flash_attention": (flash_attention, "LAUNCHES"),
            "flash_attention_wgmma": (flash_attention, "LAUNCHES_TC"),
            "ssd_scan": (ssd_scan, "LAUNCHES"),
            "ssd_scan_tc": (ssd_scan, "LAUNCHES_TC")}


def reset_counts():
    from repro_torch.kernels import flash_attention, ota_fused

    for mod, attr in counters().values():
        setattr(mod, attr, 0)
    ota_fused.LAUNCHES_WIDE = ota_fused.LAUNCHES_TALL = 0
    ota_fused.LAUNCHES_MAPPED = 0
    flash_attention.LAUNCHES_BIDIR = flash_attention.LAUNCHES_TC_BIDIR = 0


def k3_bidir_counts():
    """K3's bidirectional launches of each kernel since ``reset_counts``
    (counted among the kernel's launches, where the wrapper launches it)."""
    from repro_torch.kernels import flash_attention

    return {"flash_attention": flash_attention.LAUNCHES_BIDIR,
            "flash_attention_wgmma": flash_attention.LAUNCHES_TC_BIDIR}


def k1_body_counts():
    """K1's launches of each body since ``reset_counts``."""
    from repro_torch.kernels import ota_fused

    return {"wide": ota_fused.LAUNCHES_WIDE, "tall": ota_fused.LAUNCHES_TALL}


def read_counts():
    counts = {name: getattr(mod, attr)
              for name, (mod, attr) in counters().items()}
    counts["ota_fused"] = sum(k1_body_counts().values())
    return counts


def old_kernel(mod):
    """Within the block, the wrapper ``mod`` sends every CUDA call to its
    f32 kernel (PR 12's K3 or K4), whatever the dtype: to time that kernel
    beside the tensor-core one on the same inputs."""
    from unittest import mock

    return mock.patch.object(mod, "takes_tensor_cores",
                             lambda *args: False)


def k3_inputs(torch, b, h, hkv, s, dh, dtype, seed, sk=None, pad=0):
    """q (B, H, S, Dh), k/v (B, Hkv, Sk, Dh) from ``seed``; ``pad`` > 0
    gives views into rows of Dh + pad elements (a sequence stride the
    tensor-core kernel does not take)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=torch.float32, generator=gen)
    sk = s if sk is None else sk
    return tuple(torch.randn(shape[:3] + (dh + pad,), **kw).to(dtype)[..., :dh]
                 for shape in ((b, h, s, dh), (b, hkv, sk, dh), (b, hkv, sk, dh)))


def k3_expect(torch, q, k, v):
    """The kernel the K3 wrapper's dispatch rule picks for these views."""
    from repro_torch.kernels import flash_attention

    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return ("flash_attention_wgmma"
            if flash_attention.takes_tensor_cores(q, k, v, out)
            else "flash_attention")


def ulp_excess(got, want):
    """max(|got - want| - (1e-5 + 2^-7 |want|)): <= 0 within one bf16 ulp."""
    got, want = got.float(), want.float()
    return ((got - want).abs() - (1e-5 + BF16_ULP * want.abs())).max().item()


def launched(torch, fn, expect):
    """``fn()`` must launch the kernel ``expect`` once and no other."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts[expect] == 1 and sum(counts.values()) == 1,
          f"expected one {expect} launch, counted {counts}")
    return out


def phase_k3(torch):
    from repro_torch.kernels import flash_attention, ref

    t0 = phase("8. K3 against its plain version")
    errs = {"flash_attention": {"float32": 0.0, "bfloat16": 0.0},
            "flash_attention_wgmma": {"bfloat16": 0.0}}
    model_err = 0.0
    cases = [(b, h, hkv, s, s, dh, causal, window, 0)
             for b, h, hkv, s, dh, causal, window in K3_CASES] + K3_EDGE_CASES
    for dtype in (torch.float32, torch.bfloat16):
        tol = 3e-6 if dtype == torch.float32 else 2e-2
        name = str(dtype)[6:]
        for case in cases:
            b, h, hkv, sq, sk, dh, causal, window, pad = case
            q, k, v = k3_inputs(torch, b, h, hkv, sq, dh, dtype, sq + dh, sk,
                                pad)
            kernel = k3_expect(torch, q, k, v)
            got = launched(torch, lambda: flash_attention.flash_attention(
                q, k, v, causal=causal, window=window), kernel)
            want = ref.flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
            # the model's (B, S, H, Dh) layout, read through strides
            bshd = flash_attention.attend_bshd(
                *(x.transpose(1, 2).contiguous() for x in (q, k, v)),
                q_pos=torch.arange(sq, device="cuda"),
                k_pos=torch.arange(sk, device="cuda"), causal=causal,
                window=window)
            torch.cuda.synchronize()
            if not pad:
                check(torch.equal(bshd.transpose(1, 2), got),
                      f"K3 layouts disagree at {case}")
            extra = ""
            if dtype == torch.bfloat16:
                # both sides compute in f32 from the same inputs: only the
                # output's rounding to bf16 may part them
                check(ulp_excess(got, want) <= 0,
                      f"K3 {case}: more than one bf16 ulp from the plain "
                      f"version ({ulp_excess(got, want):.3e})")
            if kernel == "flash_attention_wgmma":
                model = ref.flash_attention_tc(q, k, v, causal=causal,
                                               window=window)
                check(ulp_excess(got, model) <= 0,
                      f"K3 {case}: more than one bf16 ulp from its model")
                m_err = (got.float() - model.float()).abs().max().item()
                model_err = max(model_err, m_err)
                extra = f"; vs its model {m_err:.3e}"
            err = (got.float() - want.float()).abs().max().item()
            errs[kernel][name] = max(errs[kernel][name], err)
            log(f"K3 {case} {name} -> {kernel}: max abs err {err:.3e} (tol "
                f"{tol}{'' if tol < 1e-3 else ', and one bf16 ulp'}){extra}")
        for stride, shift, window in K3_BLIND_CASES:
            q, k, v = (x.transpose(1, 2).contiguous() for x in
                       k3_inputs(torch, 2, 4, 2, 200, 64, dtype, 7))
            q_pos = torch.arange(200, device="cuda")
            k_pos = torch.arange(200, device="cuda") * stride + shift
            kernel = ("flash_attention_wgmma" if dtype == torch.bfloat16
                      else "flash_attention")
            got = launched(torch, lambda: flash_attention.attend_bshd(
                q, k, v, q_pos=q_pos, k_pos=k_pos, window=window), kernel)
            want = plain_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                   window=window)
            blind = int((~ref.visible(q_pos, k_pos, True, window).any(1))
                        .sum())
            check(blind > 0, "no query without a visible key")
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
            if dtype == torch.bfloat16:
                check(ulp_excess(got, want) <= 0,
                      "K3 blind rows: more than one bf16 ulp")
            err = (got.float() - want.float()).abs().max().item()
            errs[kernel][name] = max(errs[kernel][name], err)
            log(f"K3 positions k = {stride}*i + {shift}, window {window} "
                f"({blind} of 200 queries see no key) {name} -> {kernel}: "
                f"max abs err {err:.3e} (tol {tol})")

    # what the P split buys: the same arithmetic with a single bf16 P
    b, h, hkv, s, dh = SERVE_BATCH, 24, 8, SERVE_PROMPT, 128
    q, k, v = k3_inputs(torch, b, h, hkv, s, dh, torch.bfloat16, 5)
    plain = ref.flash_attention_plain(q, k, v).float()
    single = {}
    for terms in (1, 2):
        out = ref.flash_attention_tc(q, k, v, p_terms=terms).float()
        diff = (out - plain).abs()
        single[terms] = {
            "max_abs_err": diff.max().item(),
            "ulp_excess": ulp_excess(out, plain),
            "share_beyond_one_ulp": (diff > 1e-5 + BF16_ULP * plain.abs())
            .float().mean().item()}
        log(f"K3 model with P in {terms} bf16 term(s), serve shape: max abs "
            f"err {single[terms]['max_abs_err']:.3e} against the plain "
            f"version, {single[terms]['share_beyond_one_ulp']:.3e} of the "
            f"outputs beyond one bf16 ulp")
    check(single[2]["ulp_excess"] <= 0, "the split-P model leaves one ulp")
    del q, k, v, plain
    RECORD["k3_parity"] = {"cases": (len(cases) + len(K3_BLIND_CASES)) * 2,
                           "max_abs_err": errs, "wgmma_vs_model": model_err,
                           "p_terms": single}
    done("K3", t0)
    return errs


def ssd_inputs(torch, b, s, h, p, g, n, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(device="cuda", dtype=torch.float32, generator=gen)
    x = torch.randn(b, s, h, p, **kw)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, **kw)) * 0.1
    A = -torch.exp(torch.rand(h, **kw))
    B = torch.randn(b, s, g, n, **kw) * 0.5
    C = torch.randn(b, s, g, n, **kw) * 0.5
    return x.to(dtype), dt.to(dtype), A, B.to(dtype), C.to(dtype)


def phase_k4(torch):
    from repro_torch.kernels import ref, ssd_scan

    t0 = phase("9. K4 against its plain version")
    errs = {"ssd_scan": {"float32": 0.0, "bfloat16": 0.0},
            "ssd_scan_tc": {"bfloat16": 0.0}}
    model_err = 0.0
    tol = 5e-5   # the output is f32 whatever the input's dtype
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for case in K4_CASES + K4_EDGE_CASES:
            b, s, h, p, g, n, chunk = case
            x, dt, A, B, C = ssd_inputs(torch, b, s, h, p, g, n, dtype,
                                        s + h * p)
            kernel = ("ssd_scan_tc" if ssd_scan.takes_tensor_cores(x, B, C)
                      else "ssd_scan")
            got = launched(torch, lambda: ssd_scan.ssd_scan(
                x, dt, A, B, C, chunk=chunk), kernel)
            want = ref.ssd_ref(x, dt, A, B, C, chunk)
            check(got.dtype == torch.float32, "K4 output not float32")
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)
            err = (got - want).abs().max().item()
            errs[kernel][name] = max(errs[kernel][name], err)
            extra = ""
            if kernel == "ssd_scan_tc":
                model = ref.ssd_tc(x, dt, A, B, C, chunk)
                torch.testing.assert_close(got, model, atol=tol, rtol=tol)
                m_err = (got - model).abs().max().item()
                model_err = max(model_err, m_err)
                extra = f"; vs its model {m_err:.3e}"
            log(f"K4 {case} {name} -> {kernel}: max abs err {err:.3e} (tol "
                f"{tol}){extra}")
    seq_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, B, C = ssd_inputs(torch, 1, 256, 2, 32, 1, 32, dtype, 11)
        kernel = "ssd_scan_tc" if dtype == torch.bfloat16 else "ssd_scan"
        got = launched(torch, lambda: ssd_scan.ssd_scan(x, dt, A, B, C,
                                                        chunk=64), kernel)
        seq = ref.ssd_sequential_ref(x, dt, A, B, C)
        torch.testing.assert_close(got, seq, atol=1e-4, rtol=0)
        seq_err[kernel] = (got - seq).abs().max().item()
        log(f"K4 vs the sequential recurrence (1, 256, 2, 32, 1, 32, 64) "
            f"{str(dtype)[6:]} -> {kernel}: max abs err {seq_err[kernel]:.3e} "
            f"(atol 1e-4)")
    RECORD["k4_parity"] = {"cases": (len(K4_CASES) + len(K4_EDGE_CASES)) * 2,
                           "max_abs_err": errs, "tc_vs_model": model_err,
                           "sequential_max_abs_err": seq_err}
    done("K4", t0)
    return errs


def plain_attention(q, k, v, *, q_pos, k_pos, causal=True, window=None,
                    block_k=128):
    """K3's plain version in the model's layout (for the cross-check);
    another ``block_k`` sums in another order."""
    from repro_torch.kernels import ref

    return ref.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, q_pos=q_pos, k_pos=k_pos,
        block_k=block_k).transpose(1, 2)


def plain_ssd(x, dt, A, B, C, *, chunk=128, alt_chunk=None):
    """K4's plain version (for the cross-check); ``alt_chunk`` chunks the
    same scan otherwise, which sums in another order."""
    from repro_torch.kernels import ref

    return ref.ssd_ref(x, dt, A, B, C, alt_chunk or chunk)


def rel_err(a, b):
    """max|a - b| / max|b|, in float32."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def plain_prefill(torch, m, params, prompt, kernel, **alt):
    """The prefill with the kernel's plain version patched in."""
    import functools
    from unittest import mock

    from repro_torch.kernels import flash_attention, ssd_scan

    target = ((flash_attention, "attend_bshd",
               functools.partial(plain_attention, **alt))
              if kernel.startswith("flash_attention")
              else (ssd_scan, "ssd_scan", functools.partial(plain_ssd, **alt)))
    memory = model_memory(m, prompt)
    with torch.no_grad(), mock.patch.object(*target):
        reset_counts()
        logits, _ = m.prefill(params, prompt, memory)
        torch.cuda.synchronize()
        counts = read_counts()
        check(not any(counts[k] for k in K34), "the plain prefill launched "
              f"K3/K4: {counts}")
    return logits


def events(torch):
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


KV_FIELDS = ("kv", "groups_kv", "cross_self_kv")   # caches with a capacity


def model_memory(m, prompt):
    """The vlm and encdec families' frontend memory for ``prompt`` (the
    data pipeline's stub, a function of the prompt and a fixed seed), in
    the model's dtype; None for the other families."""
    from repro_torch.data import memory_stub
    from repro_torch.models.model import needs_memory

    if not needs_memory(m.cfg):
        return None
    return memory_stub(m.cfg, prompt, prompt.shape[1])


def widen_cache(m, cache, capacity, device="cuda"):
    """A prefill's KV (the dense, moe and encdec families' ``kv``; the vlm
    family's ``groups_kv`` and ``cross_self_kv``) copied into a cache of
    ``capacity`` slots, as examples/serve_smoke.py does, with its
    ``cross_kv`` as it is; the SSM and hybrid prefills' caches (zeroed, as
    the JAX package returns them) are kept as they are."""
    if m.cfg.family in ("ssm", "hybrid"):
        return cache
    fields = [f for f in KV_FIELDS if getattr(cache, f) is not None]
    k = getattr(cache, fields[0]).k                  # (lead..., B, S, Hkv, Dh)
    b, s = k.shape[-4], k.shape[-3]
    mem_len = 0 if cache.cross_kv is None else cache.cross_kv[0].shape[2]
    full = m.init_cache(b, capacity, mem_len, device=device)
    for f in fields:
        for dst, src in zip(getattr(full, f), getattr(cache, f)):
            dst[..., :s, :, :] = src
    return full._replace(pos=cache.pos, cross_kv=cache.cross_kv)


def model_and_prompt(torch, m, seed):
    """Random parameters on the card and a random prompt, from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = m.init(gen, device="cuda")
    prompt = torch.randint(0, m.cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           device="cuda", generator=gen)
    return params, prompt


def bf16_cross_check(torch, m, params, prompt, kernel, logits):
    """Last-position logits of the kernel's prefill against the plain
    version's, in bf16, beside the noise floor: the plain version against
    a plain version that sums in another order."""
    alt = ({"block_k": 64} if kernel.startswith("flash_attention")
           else {"alt_chunk": 64})
    plain = plain_prefill(torch, m, params, prompt, kernel)
    floor = plain_prefill(torch, m, params, prompt, kernel, **alt)
    out = {"rel_err": rel_err(logits, plain),
           "noise_floor": rel_err(floor, plain),
           "first_token_matches_plain": bool(torch.equal(
               torch.argmax(logits[:, -1:, :], -1),
               torch.argmax(plain[:, -1:, :], -1))), "floor_by": alt}
    del plain, floor
    torch.cuda.empty_cache()
    return out


def serve(torch, arch, kernel, kernel32, n_launches, steps=SERVE_STEPS,
          seeds=FLOOR_SEEDS, depth32=None, n_launches32=None, n_bidir=0):
    """Serve one config at full width: prefill, ``steps`` decode steps,
    plain cross-check.  ``kernel`` names the counter the bf16 prefill must
    advance by ``n_launches`` (and no other K3/K4 counter), ``n_bidir`` of
    them bidirectional (the float32 prefill as many); ``kernel32`` the one
    the float32 prefill must (by ``n_launches32``, default ``n_launches``;
    the float32 model has ``depth32`` layers where given, a cut that lets
    it fit beside the bf16 weights).  The vlm and encdec
    families take the data pipeline's memory stub of the prompt.  Returns
    the numbers (peak memory of the bf16 serve included), the model and its
    seed-0 parameters and prompt.

    The cross-check against the plain version is asserted in float32: in
    bf16, 24-28 layers of random weights amplify the rounding of either
    version to about the 2e-2 bound (two plain versions that only sum in
    another order differ by as much), so the bf16 difference is reported
    beside that noise floor, on each of ``seeds``.  The kernels' bf16
    arithmetic is held in phases 8 and 9."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import param_count
    from repro_torch.train import server

    cfg = get_config(arch)
    m = model_lib.build(cfg)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s0, s1 = events(torch)
    s0.record()
    params, prompt = model_and_prompt(torch, m, seeds[0])
    s1.record()
    torch.cuda.synchronize()
    n_params = param_count(params)
    log(f"{arch}: {n_params / 1e9:.3f} B parameters ({cfg.dtype}), init "
        f"{s0.elapsed_time(s1):.1f} ms")
    b, s = SERVE_BATCH, SERVE_PROMPT
    memory = model_memory(m, prompt)
    with torch.no_grad():
        m.prefill(params, prompt, memory)   # warm-up: cuBLAS, library load
        torch.cuda.synchronize()
        reset_counts()
        s0.record()
        logits, cache = m.prefill(params, prompt, memory)
        s1.record()
        torch.cuda.synchronize()
        counts, bidir = read_counts(), k3_bidir_counts()
    prefill_ms = s0.elapsed_time(s1)
    check(counts[kernel] == n_launches
          and sum(counts[k] for k in K34) == n_launches,
          f"{arch} prefill: {counts} launches, expected {n_launches} of "
          f"{kernel} and no other K3/K4")
    check(bidir.get(kernel, 0) == sum(bidir.values()) == n_bidir,
          f"{arch} prefill: bidirectional K3 launches {bidir}, expected "
          f"{n_bidir} of {kernel}")
    check(logits.shape == (b, 1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"{arch} prefill logits not finite / wrong shape")

    cap = s + steps
    full = widen_cache(m, cache, cap)
    del cache
    step = server.make_serve_step(
        m, InputShape("serve", seq_len=cap, global_batch=b, kind="decode"))
    tok = torch.argmax(logits[:, -1:, :], -1)
    step_logits = []
    s0.record()
    for _ in range(steps):
        tok, lg, full = step(params, full, tok)
        step_logits.append(lg)
    s1.record()
    torch.cuda.synchronize()
    decode_ms = s0.elapsed_time(s1)
    check(all(bool(torch.isfinite(lg.float()).all()) for lg in step_logits),
          f"{arch} decode logits not finite")
    del step_logits
    check(full.pos == (steps if cfg.family in ("ssm", "hybrid")
                       else s + steps), f"{arch} cache position")
    del full
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # bf16: the kernel's prefill against the plain version's, on each seed
    bf16 = [bf16_cross_check(torch, m, params, prompt, kernel, logits)]
    del logits
    for seed in seeds[1:]:
        p_seed, prompt_seed = model_and_prompt(torch, m, seed)
        with torch.no_grad():
            lg, _ = m.prefill(p_seed, prompt_seed,
                              model_memory(m, prompt_seed))
        bf16.append(bf16_cross_check(torch, m, p_seed, prompt_seed, kernel,
                                     lg))
        del p_seed, prompt_seed, lg
        torch.cuda.empty_cache()

    # the asserted cross-check: the seed-0 model (``depth32`` layers) and
    # prompt in float32
    n32 = n_launches if n_launches32 is None else n_launches32
    m32 = model_lib.build(cfg.with_(dtype="float32",
                                    n_layers=depth32 or cfg.n_layers))
    params32 = m32.init(torch.Generator(device="cuda").manual_seed(
        seeds[0]), device="cuda")
    with torch.no_grad():
        reset_counts()
        logits32, _ = m32.prefill(params32, prompt, model_memory(m32, prompt))
        torch.cuda.synchronize()
        counts32, bidir32 = read_counts(), k3_bidir_counts()
        check(counts32[kernel32] == n32
              and sum(counts32[k] for k in K34) == n32,
              f"{arch} f32 prefill: {counts32} launches, expected "
              f"{n32} of {kernel32} and no other K3/K4")
        check(bidir32.get(kernel32, 0) == sum(bidir32.values()) == n_bidir,
              f"{arch} f32 prefill: bidirectional K3 launches {bidir32}, "
              f"expected {n_bidir} of {kernel32}")
    plain32 = plain_prefill(torch, m32, params32, prompt, kernel)
    rel32 = rel_err(logits32, plain32)
    check(bool(torch.isfinite(logits32).all()), f"{arch} f32 logits")
    check(rel32 < 2e-2, f"{arch}: f32 kernel vs plain prefill logits rel err "
                        f"{rel32}")
    del params32, logits32, plain32
    torch.cuda.empty_cache()
    res = {"params": n_params, "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": b * s / prefill_ms * 1e3,
           "decode_ms_per_step": decode_ms / steps,
           "decode_tokens_per_s": b * steps / decode_ms * 1e3,
           "decode_steps": steps, "peak_gb": peak_gb,
           "launches": counts, "launches_f32": counts32,
           "bidirectional_launches": bidir,
           "bidirectional_launches_f32": bidir32,
           "f32_layers": m32.cfg.n_layers, "plain_rel_err_f32": rel32,
           "bf16_by_seed": dict(zip(seeds, bf16))}
    log(f"{arch}: prefill B={b} S={s} {prefill_ms:.2f} ms "
        f"({res['prefill_tokens_per_s']:.0f} tok/s), {kernel} launches "
        f"{counts[kernel]}{f' ({n_bidir} bidirectional)' if n_bidir else ''}"
        f"; decode {steps} steps "
        f"{res['decode_ms_per_step']:.2f} ms/step "
        f"({res['decode_tokens_per_s']:.1f} tok/s); peak {peak_gb:.2f} GB "
        f"allocated")
    log(f"{arch}: last-position logits, kernel vs plain prefill, f32 at "
        f"{m32.cfg.n_layers} layers {rel32:.3e} (asserted < 2e-2)")
    for seed, r in zip(seeds, bf16):
        log(f"{arch}: seed {seed} bf16 {r['rel_err']:.3e} beside a noise "
            f"floor of {r['noise_floor']:.3e} (plain vs plain with "
            f"{r['floor_by']}); first greedy token equal: "
            f"{r['first_token_matches_plain']}")
    return res, m, params, prompt


def phase_serve(torch):
    t0 = phase("10. serve llama3.2-3b (bf16, full width)")
    llama = serve(torch, "llama3.2-3b", "flash_attention_wgmma",
                  "flash_attention", 28)
    done("llama", t0)
    t0 = phase("11. serve mamba2-130m (bf16, full width)")
    mamba = serve(torch, "mamba2-130m", "ssd_scan_tc", "ssd_scan", 24)
    done("mamba", t0)
    RECORD["serve"] = {"llama3.2-3b": llama[0], "mamba2-130m": mamba[0]}
    return llama, mamba


def k3_bound(b, h, hkv, s, dh, elem_bytes, causal=True):
    """Least time in ms for attention at these shapes (causal or
    bidirectional): 4*dh FLOP per visible (query, key) pair over the bf16
    tensor-core peak, against Q, K, V read once and O written once over HBM
    bandwidth."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * dh * pairs
    nbytes = elem_bytes * (2 * b * h * s * dh + 2 * b * hkv * s * dh)
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def k4_bound(b, s, h, p, g, n, q, in_bytes, out_bytes):
    """Least time in ms for the chunked SSD: the causal half of C.B^T per
    group, the decay-weighted intra product, the inter-chunk read and the
    state update per head, over the bf16 tensor-core peak; against x, dt,
    A, B, C read once and y written once over HBM bandwidth."""
    nc = -(-s // q)
    tri = q * (q + 1) // 2
    flops = nc * b * (g * tri * n * 2 + h * (tri * (p * 2 + 1)
                                              + 4 * q * n * p + q * n))
    nbytes = (b * s * h * p * (in_bytes + out_bytes) + b * s * h * 4 + h * 4
              + 2 * b * s * g * n * in_bytes)
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops, nbytes


def k34_turns(torch, new, old, mod, iters_old=60):
    """A tensor-core kernel and its f32-core one (forced through the
    wrapper ``mod``) timed in turns (new, old, old, new): each one's
    median of its two turns' medians, and the four."""
    a = device_ms(torch, new)
    with old_kernel(mod):
        b = device_ms(torch, old, iters=iters_old, sleep_cycles=20_000_000)
        c = device_ms(torch, old, iters=iters_old, sleep_cycles=20_000_000)
    d = device_ms(torch, new)
    return statistics.median([a, d]), statistics.median([b, c]), \
        [a, b, c, d]


def k3_times(torch, h, hkv, dh, seed, arch, s=SERVE_PROMPT, causal=True,
             what="prefill", b=SERVE_BATCH):
    """The tensor-core K3 at ``arch``'s ``what`` shape (bf16; B=4, S 2048
    and causal unless given): held to its plain version (2e-2 and one bf16
    ulp), then timed beside the f32-core kernel, the plain version and
    SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention

    q, k, v = (x.transpose(1, 2).contiguous() for x in
               k3_inputs(torch, b, h, hkv, s, dh, torch.bfloat16, seed))
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    call = lambda: flash_attention.attend_bshd(q, k, v, q_pos=pos,  # noqa
                                               k_pos=pos, causal=causal)
    got = launched(torch, call, "flash_attention_wgmma")
    want = plain_attention(q, k, v, q_pos=pos, k_pos=pos, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    check(ulp_excess(got, want) <= 0, f"K3 at {arch}'s {what} shape: "
          f"more than one bf16 ulp from the plain version")
    err = (got.float() - want.float()).abs().max().item()
    del got, want
    ms, old_ms, order = k34_turns(torch, call, call, flash_attention,
                                  iters_old=20)
    plain_ms = device_ms(torch, lambda: plain_attention(
        q, k, v, q_pos=pos, k_pos=pos, causal=causal),
        sleep_cycles=20_000_000)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    bound, by, flops, nbytes = k3_bound(b, h, hkv, s, dh, 2, causal)
    row = {"arch": arch, "what": what, "shape": [b, h, hkv, s, dh],
           "dtype": "bfloat16", "causal": causal, "ms": ms,
           "ms_pr12_kernel": old_ms,
           "turns_new_old_old_new": order, "max_abs_err": err,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_call": f"F.scaled_dot_product_attention(is_causal="
                           f"{causal}, enable_gqa=True)",
           "bound_ms": bound, "bound_by": by, "flops": flops,
           "bytes": nbytes, "achieved_tflops": flops / ms / 1e9,
           "achieved_tflops_pr12_kernel": flops / old_ms / 1e9}
    log(f"K3 at {arch}'s {what} (B={b}, H={h}, Hkv={hkv}, S={s}, "
        f"Dh={dh}) {'causal' if causal else 'bidirectional'} bf16: "
        f"wgmma {ms:.4f} ms "
        f"({row['achieved_tflops']:.2f} TFLOP/s; bound {bound:.4f} ms, "
        f"{by}, {bound / ms:.2%} of it; max abs err {err:.3e}) | f32-core "
        f"kernel {old_ms:.4f} ms ({bound / old_ms:.2%}) | plain "
        f"{plain_ms:.4f} ms | SDPA {lib_ms:.4f} ms | turns "
        f"{[round(t, 4) for t in order]}")
    return row


def k4_times(torch, h, n, seed, arch, what="prefill"):
    """The tensor-core K4 at ``arch``'s ``what`` shape (B=4, S=2048, P=64,
    G=1, Q=128, bf16 in, f32 out; ``h`` heads, state ``n``) beside the
    f32-core kernel and the plain version."""
    from repro_torch.kernels import ref, ssd_scan

    b, s, p, g, chunk = SERVE_BATCH, SERVE_PROMPT, 64, 1, 128
    x, dt, A, B, C = ssd_inputs(torch, b, s, h, p, g, n, torch.bfloat16,
                                seed)
    dt = dt.float()             # the model's dt is float32 (softplus)
    call = lambda: ssd_scan.ssd_scan(x, dt, A, B, C, chunk=chunk)  # noqa
    launched(torch, call, "ssd_scan_tc")
    ms, old_ms, order = k34_turns(torch, call, call, ssd_scan)
    plain_ms = device_ms(torch, lambda: ref.ssd_ref(x, dt, A, B, C, chunk),
                         sleep_cycles=20_000_000)
    bound, by, flops, nbytes = k4_bound(b, s, h, p, g, n, chunk, 2, 4)
    row = {"arch": arch, "what": what, "shape": [b, s, h, p, g, n, chunk],
           "dtype": "bfloat16 in, f32 out", "ms": ms,
           "ms_pr12_kernel": old_ms, "turns_new_old_old_new": order,
           "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bound, "bound_by": by, "flops": flops,
           "bytes": nbytes, "achieved_tflops": flops / ms / 1e9}
    log(f"K4 at {arch}'s {what} (B={b}, S={s}, H={h}, P={p}, G={g}, N={n}, "
        f"Q={chunk}) bf16 in, f32 out: tensor cores {ms:.4f} ms (bound "
        f"{bound:.4f} ms, {by}, {bound / ms:.2%} of it; "
        f"{nbytes / 1e9:.3f} GB, {flops / 1e12:.3f} TFLOP) | f32-core kernel "
        f"{old_ms:.4f} ms ({bound / old_ms:.2%}) | plain {plain_ms:.4f} ms "
        f"| no single PyTorch call computes the scan | turns "
        f"{[round(t, 4) for t in order]}")
    return row


def phase_k34_times(torch):
    """The tensor-core K3 and K4 at the serve shapes beside their PR 12
    kernels (forced through the wrapper on the same inputs), the plain
    versions and, for K3, SDPA; kernels timed in turns (new, old, old,
    new) and each kernel's number the median of its two turns' medians."""
    t0 = phase("12. K3 and K4 times at the serve shapes (median of 60)")

    k3 = k3_times(torch, 24, 8, 128, 5, "llama3.2-3b")
    k3["granite"] = k3_times(torch, 16, 8, 64, 8, "granite-moe-1b-a400m")
    k3[VISION] = k3_times(torch, 32, 8, 128, 9, VISION)
    k3[SEAMLESS] = k3_times(torch, 16, 16, 64, 10, SEAMLESS,
                            s=SERVE_PROMPT // 4, causal=False,
                            what="encoder")
    k3[SEAMLESS + " decoder"] = k3_times(torch, 16, 16, 64, 12, SEAMLESS,
                                         what="decoder")

    k4 = k4_times(torch, 24, 128, 6, "mamba2-130m")
    k4[ZAMBA] = k4_times(torch, 112, 64, 13, ZAMBA)
    RECORD["k34_times"] = {"flash_attention": k3, "ssd_scan": k4}
    done("K3/K4 times", t0)
    return k3, k4


class DeviceKernel(NamedTuple):
    key: str              # the kernel's (or copy's) name
    count: int            # its launches
    device_us: float      # their device time


def device_kernels(torch, fn):
    """torch.profiler around ``fn()``: the device events (kernels, copies)
    summed by name into ``DeviceKernel``s, sorted by device time, their
    total device time in us, and ``fn()``'s result.  The profiler's raw
    events are summed here: ``key_averages()`` gives the same counts and
    times, but builds a Python object per host and device event first,
    seconds for a prefill's few thousand launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, us = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    kernels = sorted((DeviceKernel(k, n, us)
                      for k, (n, us) in by_name.items()),
                     key=lambda k: k.device_us, reverse=True)
    check(kernels, "the profiler recorded no device activity")
    return kernels, sum(e.device_us for e in kernels), out


def profile_serve(torch, m, params, prompt, kernel_name, res, steps=4):
    """torch.profiler over one prefill, then (a second window) ``steps``
    decode steps; busy shares against the unprofiled times in ``res``."""
    from repro_torch.configs.base import InputShape
    from repro_torch.train import server

    b, s = prompt.shape
    step = server.make_serve_step(
        m, InputShape("serve", seq_len=s + steps, global_batch=b,
                      kind="decode"))
    out = {}
    with torch.no_grad():
        memory = model_memory(m, prompt)
        kernels, busy, (logits, cache) = device_kernels(
            torch, lambda: m.prefill(params, prompt, memory))
        ours = sum(e.device_us for e in kernels if kernel_name in e.key)
        out["prefill"] = {
            "device_busy_us": busy, "kernel_us": ours,
            "kernel_share": ours / busy, "launches": sum(
                e.count for e in kernels),
            "busy_share_of_unprofiled": busy / (res["prefill_ms"] * 1e3),
            "top": [{"name": e.key[:90], "device_us": e.device_us,
                     "launches": e.count} for e in kernels[:8]]}
        state = {"tok": torch.argmax(logits[:, -1:, :], -1),
                 "cache": widen_cache(m, cache, s + steps)}
        del cache

        def decode():
            for _ in range(steps):
                state["tok"], _, state["cache"] = step(params, state["cache"],
                                                       state["tok"])

        kernels, busy, _ = device_kernels(torch, decode)
        out["decode_step"] = {
            "device_busy_us": busy / steps,
            "launches": sum(e.count for e in kernels) / steps,
            "busy_share_of_unprofiled": busy / steps / (
                res["decode_ms_per_step"] * 1e3),
            "top": [{"name": e.key[:90], "device_us": e.device_us / steps,
                     "launches": e.count / steps} for e in kernels[:6]]}
    del logits, state
    torch.cuda.empty_cache()
    return out


def phase_serve_profile(torch, llama, mamba):
    t0 = phase("13. where the serve time goes: torch.profiler, one prefill, "
               "then 4 decode steps")
    out = {}
    for arch, served, name in (("llama3.2-3b", llama,
                                "flash_fwd_wgmma_kernel"),
                               ("mamba2-130m", mamba, "ssd_scan_tc_kernel")):
        out[arch] = logged_serve_profile(torch, arch, served, name)
    RECORD["serve_profile"] = out
    done("serve profile", t0)


def logged_serve_profile(torch, arch, served, name):
    """``profile_serve`` of one served model, and its log lines."""
    res, m, params, prompt = served
    prof = profile_serve(torch, m, params, prompt, name, res)
    pre, dec = prof["prefill"], prof["decode_step"]
    for t in pre["top"]:
        log(f"prefill {t['device_us']:11.1f} us x{t['launches']:5d}  "
            f"{t['name']}")
    for t in dec["top"]:
        log(f"decode  {t['device_us']:11.1f} us x{t['launches']:7.1f}  "
            f"{t['name']} (per step)")
    log(f"{arch} prefill: device busy {pre['device_busy_us']:.1f} us over "
        f"{pre['launches']} launches; {name} {pre['kernel_us']:.1f} us "
        f"({pre['kernel_share']:.2%} of device time); busy share of the "
        f"unprofiled {res['prefill_ms']:.2f} ms prefill "
        f"{pre['busy_share_of_unprofiled']:.2%}")
    log(f"{arch} decode: device busy {dec['device_busy_us']:.1f} us over "
        f"{dec['launches']:.0f} launches per step; busy share of the "
        f"unprofiled {res['decode_ms_per_step']:.2f} ms step "
        f"{dec['busy_share_of_unprofiled']:.2%}")
    return prof


# ---------------------------------------------------------------------------
# K2, the agent-streamed round, large fleets, power control
# ---------------------------------------------------------------------------

def k2_bound(numel, elem_bytes, noise):
    """Least time in ms for the function K2 computes: one read and one
    write of v over HBM bandwidth, against float32 operations (noise about
    14 per element, as for K1, then sigma, add and scale: 17; 1 without
    noise) over the non-tensor-core peak."""
    nbytes = 2 * numel * elem_bytes
    flops = (17 if noise else 1) * numel
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_k2(torch):
    from repro_torch.kernels import ops, ota_channel, ota_fused, ref

    t0 = phase("14. K2 against its plain version")
    checks = 0
    for i, shape in enumerate(K2_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        base = torch.randn(shape, device="cuda", generator=gen)
        seed = 7919 * (i + 1)
        for dtype in (torch.float32, torch.bfloat16):
            v = base.to(dtype)
            for sigma in (0.0, 0.5):
                for debias in (True, False):
                    kw = dict(sigma=sigma, n_agents=7, m_h=RAYLEIGH_MH,
                              debias=debias, seed=seed)
                    got = ota_channel.ota_channel_apply(v, **kw)
                    want = ref.ota_channel_plain(v, **kw)
                    check(got.dtype == dtype and got.shape == v.shape,
                          f"K2 {shape} {dtype}: got {got.dtype} "
                          f"{tuple(got.shape)}")
                    check(torch.equal(got, want),
                          f"K2 not bitwise at {shape} {dtype} sigma={sigma} "
                          f"debias={debias}: max err "
                          f"{(got.float() - want.float()).abs().max().item()}")
                    checks += 1
        # the streams are equal: K2 on a flat float32 v is K1's unit-gain
        # server pass on the same seed
        flat = base.reshape(-1)
        k2 = ota_channel.ota_channel_apply(flat, sigma=0.5, n_agents=7,
                                           m_h=RAYLEIGH_MH, seed=seed)
        k1 = ota_fused.fused_server_pass(
            flat, sigma=0.5, scale=ref.ota_channel_scale(7, RAYLEIGH_MH, True),
            seed=seed)
        check(torch.equal(k2, k1), f"K2 != K1 server pass at {shape}")
        log(f"K2 {shape}: f32 and bf16, sigma 0/0.5, debias on/off bitwise "
            f"equal to the plain version; == fused_server_pass (f32 flat)")
        del base, flat, k1, k2
    # the path: one ops.ota_update call at microbench's 16 MB
    v = torch.randn(4096, 1024, device="cuda")
    reset_counts()
    out = ops.ota_update(v, sigma=1e-3, n_agents=10, m_h=RAYLEIGH_MH, seed=3)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["ota_channel"] == 1 and sum(counts.values()) == 1,
          f"ops.ota_update launched {counts}, expected one K2 launch")
    check(bool(torch.isfinite(out).all()), "ota_update output not finite")
    log(f"ops.ota_update on a CUDA (4096, 1024) tensor: {counts}")
    RECORD["k2_parity"] = {"checks": checks, "max_abs_err": 0.0,
                           "launches": counts["ota_channel"]}
    done("K2", t0)
    return counts["ota_channel"]


def phase_k2_times(torch):
    from repro_torch.kernels import ota_channel, ref

    t0 = phase("15. K2 times (median of 60, CUDA events)")
    rows = []
    kw = dict(sigma=1e-3, n_agents=10, m_h=RAYLEIGH_MH, seed=17)
    for shape, dtype in (((4096, 1024), torch.float32),
                         ((4096, 1024), torch.bfloat16),
                         ((2 ** 26,), torch.float32)):
        v = torch.randn(shape, device="cuda").to(dtype)
        ms = device_ms(torch, lambda: ota_channel.ota_channel_apply(v, **kw))
        plain_ms = device_ms(torch, lambda: ref.ota_channel_plain(v, **kw),
                             sleep_cycles=20_000_000)
        bound, by = k2_bound(v.numel(), v.element_size(), True)
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "mbytes": v.numel() * v.element_size() / 1e6, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": None}
        rows.append(row)
        log(f"K2 {shape} {row['dtype']} ({row['mbytes']:.1f} MB): "
            f"{ms * 1e3:.2f} us (bound {bound * 1e3:.2f} us, {by}; "
            f"{bound / ms:.2%} of it) | plain {plain_ms * 1e3:.2f} us | no "
            f"PyTorch call draws this noise stream")
        del v
    log("the 16 MB cases fit the 50 MB L2 after the warm-up, so their share "
        "of the HBM bound can pass 100 %; the kernel's row is the 2^26 one")
    RECORD["k2_times"] = rows
    done("K2 times", t0)
    return rows


def history_equal(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_streamed(torch):
    from repro_torch.core import fedpg, ota as ota_lib
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.utils.device import make_generator

    t0 = phase("16. agent-streamed Algorithm 2 at the paper's width")
    env, pol = LandmarkNav(), MLPPolicy()
    cfg, ota = alg_config(10, 10, MAIN_ROUNDS)
    fedpg.run(env, pol, dataclasses.replace(cfg, n_rounds=2), 99, ota=ota,
              agent_blocks=3, device="cuda")
    torch.cuda.synchronize()
    _, stacked, stacked_ms = timed_run(torch, fedpg, env, pol, cfg, ota, 0)
    hists, res = {}, {}
    for b in STREAM_BLOCKS:
        n_blocks = ota_lib.blocked_layout(cfg.n_agents, b)[0]
        reset_counts()
        theta, hist, ms = timed_run(torch, fedpg, env, pol, cfg, ota, 0,
                                    agent_blocks=b)
        counts = read_counts()
        expect = (2 * n_blocks + 1) * cfg.n_rounds
        check(counts["ota_fused"] == expect and counts["ota_channel"] == 0,
              f"agent_blocks={b}: {counts}, expected {expect} K1 launches")
        check(all(bool(torch.isfinite(x).all()) for x in hist)
              and all(bool(torch.isfinite(t).all()) for t in theta.values()),
              f"agent_blocks={b}: not finite")
        hists[b] = (theta, hist)
        res[b] = {"n_blocks": n_blocks, "ms_per_round": ms,
                  "k1_launches_per_round": counts["ota_fused"] / cfg.n_rounds,
                  "avg_grad_sq": fedpg.avg_grad_sq(hist).item()}
        log(f"agent_blocks={b} ({n_blocks} blocks): {ms:.3f} ms/round, "
            f"{counts['ota_fused'] / cfg.n_rounds:.0f} K1 launches per round, "
            f"avg_grad_sq={res[b]['avg_grad_sq']:.4f}")
    first = STREAM_BLOCKS[0]
    for b in STREAM_BLOCKS[1:]:
        check(history_equal(torch, hists[first][1], hists[b][1])
              and all(torch.equal(hists[first][0][k], hists[b][0][k])
                      for k in hists[first][0]),
              f"history of agent_blocks={b} is not bitwise that of "
              f"agent_blocks={first}")
    streamed = hists[first][1]
    check(torch.equal(streamed.gain_mean, stacked.gain_mean),
          "streamed gain means are not bitwise the stacked round's")
    drift = {f: ((getattr(streamed, f) - getattr(stacked, f)).abs()
                 / getattr(stacked, f).abs()).max().item()
             for f in ("rewards", "grad_sq")}
    check(max(drift.values()) <= 1e-5,
          f"streamed vs stacked history beyond rtol 1e-5: {drift}")
    log(f"histories bitwise equal for agent_blocks {STREAM_BLOCKS}; gain "
        f"means bitwise the stacked run's ({stacked_ms:.3f} ms/round); over "
        f"{cfg.n_rounds} chained rounds reward and grad_sq differ from the "
        f"stacked run's by at most {drift['rewards']:.3e} and "
        f"{drift['grad_sq']:.3e} relative (rtol 1e-5)")

    # one round at a time from the same theta and generator state: the
    # streamed round against the stacked round, rtol 1e-5
    stk = fedpg.make_round_fn(env, pol, cfg, ota)
    stm = fedpg.make_round_fn(env, pol, cfg, ota, agent_blocks=3)
    gen = make_generator(5, "cuda")
    theta = pol.init(gen, "cuda")
    worst = {"reward": 0.0, "grad_sq": 0.0}
    for _ in range(STREAM_COMPARE_ROUNDS):
        state = gen.get_state()
        th_a, m_a = stk(theta, gen)
        gen.set_state(state)
        _, m_b = stm(theta, gen)
        check(torch.equal(m_a[2], m_b[2]), "gain mean differs")
        for name, x, y in (("reward", m_a[0], m_b[0]),
                           ("grad_sq", m_a[1], m_b[1])):
            torch.testing.assert_close(y, x, rtol=1e-5, atol=0)
            worst[name] = max(worst[name],
                              ((y - x).abs() / x.abs()).item())
        theta = th_a
    log(f"{STREAM_COMPARE_ROUNDS} rounds from the same theta and draws: "
        f"streamed vs stacked largest relative difference reward "
        f"{worst['reward']:.3e}, grad_sq {worst['grad_sq']:.3e} (rtol 1e-5)")

    # Algorithm 1 streamed: one K1 fold per block
    alg1 = {}
    for b in (3, 10):
        n_blocks = ota_lib.blocked_layout(cfg.n_agents, b)[0]
        reset_counts()
        _, h1, ms = timed_run(torch, fedpg, env, pol, cfg, None, 0,
                              agent_blocks=b)
        counts = read_counts()
        check(counts["ota_fused"] == n_blocks * cfg.n_rounds,
              f"Algorithm 1 agent_blocks={b}: {counts}")
        check(all(bool(torch.isfinite(x).all()) for x in h1),
              "Algorithm 1 streamed not finite")
        alg1[b] = (h1, ms)
    check(history_equal(torch, alg1[3][0], alg1[10][0]),
          "Algorithm 1 streamed history depends on agent_blocks")
    log(f"Algorithm 1 streamed: {alg1[3][1]:.3f} ms/round (3 per block), "
        f"{alg1[10][1]:.3f} ms/round (5 per block), bitwise equal, "
        f"avg_grad_sq={fedpg.avg_grad_sq(alg1[3][0]).item():.4f}")
    RECORD["streamed"] = {"blocks": res, "stacked_ms_per_round": stacked_ms,
                          "chained_drift": drift, "per_round_worst": worst,
                          "alg1_ms_per_round": {b: alg1[b][1] for b in alg1}}
    done("streamed", t0)
    return res


def phase_large_fleet(torch):
    from repro_torch.core import fedpg, ota as ota_lib
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.ota import OTAConfig
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    t0 = phase("17. large fleets (benchmarks/fig_large_n.py settings, one "
               "round)")
    env, pol = LandmarkNav(), MLPPolicy()
    ota = OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True)
    rows = []
    for n in LARGE_N:
        cfg = dataclasses.replace(alg_config(n, 1, 1)[0], horizon=3)
        row = {"N": n}
        for form, blocks in (("streamed", LARGE_BLOCKS), ("stacked", None)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_counts()
            theta, hist, ms = timed_run(torch, fedpg, env, pol, cfg, ota, 1,
                                        agent_blocks=blocks)
            counts = read_counts()
            check(all(bool(torch.isfinite(x).all()) for x in hist)
                  and all(bool(torch.isfinite(t).all())
                          for t in theta.values()),
                  f"N={n} {form}: not finite")
            expect = 1 if blocks is None else (
                2 * ota_lib.blocked_layout(n, blocks)[0] + 1)
            check(counts["ota_fused"] == expect,
                  f"N={n} {form}: {counts['ota_fused']} K1 launches, "
                  f"expected {expect}")
            # the stacked round folds N rows in one launch: the tall body
            bodies = k1_body_counts()
            check(blocks is not None or bodies["tall"] == 1,
                  f"N={n} stacked: {bodies}, expected the tall body")
            # the run's own peak: above what was allocated before it
            peak = torch.cuda.max_memory_allocated() - resident
            row[form] = {"ms_per_round": ms, "peak_mb": peak / 1e6,
                         "k1_launches": counts["ota_fused"],
                         "k1_tall_launches": bodies["tall"]}
        rows.append(row)
        log(f"N={n:6d}: streamed ({LARGE_BLOCKS} per block) "
            f"{row['streamed']['ms_per_round']:.1f} ms, peak "
            f"{row['streamed']['peak_mb']:.1f} MB, "
            f"{row['streamed']['k1_tall_launches']} of "
            f"{row['streamed']['k1_launches']} K1 launches tall | stacked "
            f"{row['stacked']['ms_per_round']:.1f} ms, peak "
            f"{row['stacked']['peak_mb']:.1f} MB, K1 tall")
    big = rows[-1]
    check(big["streamed"]["peak_mb"] < big["stacked"]["peak_mb"],
          f"N={big['N']}: streamed peak {big['streamed']['peak_mb']:.1f} MB "
          f"not below stacked {big['stacked']['peak_mb']:.1f} MB")
    RECORD["large_fleet"] = rows
    done("large fleet", t0)


def phase_power_control(torch):
    from repro_torch.core import fedpg, theory
    from repro_torch.core.power_control import (
        ConstantReceived, TruncatedInversion, UnitPower, effective_moments,
    )
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    t0 = phase("18. power control: Algorithm 2 at the paper's width, "
               f"{PC_RUNS} Monte-Carlo runs")
    env, pol = LandmarkNav(), MLPPolicy()
    cfg, base_ota = alg_config(10, 10, MAIN_ROUNDS)
    consts = theory.constants_for_env(env, horizon=cfg.horizon,
                                      gamma=cfg.gamma, G=2 ** 0.5, F=0.5)
    rows = []
    for policy in (UnitPower(), TruncatedInversion(), ConstantReceived()):
        ota = dataclasses.replace(base_ota, power_control=policy)
        m_h, var_h = effective_moments(ota.channel, policy,
                                       n_agents=cfg.n_agents)
        hist = fedpg.monte_carlo(env, pol, cfg, 0, PC_RUNS, ota=ota,
                                 device="cuda")
        check(all(bool(torch.isfinite(x).all()) for x in hist),
              f"{type(policy).__name__}: not finite")
        mean_h = hist.gain_mean.double().mean().item()
        n_gains = cfg.n_agents * cfg.n_rounds * PC_RUNS
        se = (var_h / n_gains) ** 0.5
        # 5 standard errors of the mean of n_gains iid gains, plus 4 float32
        # ulps of m_h for c * (target / c), which is target only in exact
        # arithmetic (ConstantReceived has no variance to give an error)
        allow = 5 * se + 4 * 2 ** -23 * m_h
        check(abs(mean_h - m_h) <= allow,
              f"{type(policy).__name__}: mean(h)={mean_h} vs m_h={m_h} "
              f"(allowed {allow})")
        which, bound = theory.applicable_bound(
            K=cfg.n_rounds, n_agents=cfg.n_agents, batch_m=cfg.batch_m,
            alpha=cfg.alpha, m_h=m_h, sigma_h2=var_h,
            noise_sigma2=ota.noise_sigma ** 2,
            delta_J=consts.l_bar / (1 - cfg.gamma), V=consts.V())
        floor = (theory.theorem1_floor if which == "theorem1"
                 else theory.theorem2_floor)(
            n_agents=cfg.n_agents, batch_m=cfg.batch_m, m_h=m_h,
            sigma_h2=var_h, noise_sigma2=ota.noise_sigma ** 2, V=consts.V())
        row = {"policy": type(policy).__name__,
               "avg_grad_sq": fedpg.avg_grad_sq(hist).mean().item(),
               "mean_h": mean_h, "m_h": m_h, "sigma_h2": var_h,
               "se": se, "which": which, "bound": bound, "floor": floor}
        rows.append(row)
        log(f"{row['policy']:18s} avg_grad_sq={row['avg_grad_sq']:.4f} "
            f"mean(h)={mean_h:.6f} m_h={m_h:.6f} (|diff| "
            f"{abs(mean_h - m_h):.2e}, se {se:.2e}) sigma_h^2={var_h:.5f} "
            f"{which} bound={bound:.4e} floor={floor:.4e}")
    RECORD["power_control"] = rows
    done("power control", t0)


# ---------------------------------------------------------------------------
# the round service, the event-triggered baseline, the environment zoo
# ---------------------------------------------------------------------------

def service_seed(torch, pol, seed):
    """The mask-stream seed ``fedpg.run`` draws for a service run from
    ``seed``: theta_0 first, then one uint32 (fedpg's module docstring)."""
    from repro_torch.core.ota import sample_seed
    from repro_torch.utils.device import make_generator

    gen = make_generator(seed, "cuda")
    pol.init(gen, "cuda")
    return sample_seed(gen, "cuda")


def realised_rate(torch, part, seed_t, n, rounds):
    """The realised participation rate of ``rounds`` rounds and its
    expected value (closed form, faults included)."""
    from repro_torch.service import participation as P

    ids = torch.arange(n, device="cuda")
    count = sum(P.round_mask(part, seed_t, r, ids, n).sum().item()
                for r in range(rounds))
    return count / (n * rounds), P.expected_count(part, n) / n


def rate_within(rate, expect, n_draws, what):
    """The realised rate within 5 standard errors of the expected one (a
    PRNG-free subset mask must hit it exactly)."""
    se = (expect * (1 - expect) / n_draws) ** 0.5
    check(abs(rate - expect) <= 5 * se + 1e-12,
          f"{what}: realised rate {rate} vs {expect} (5 se = {5 * se})")
    return se


def service_configs():
    from repro_torch.service import (
        FaultConfig, ParticipationConfig, StragglerModel,
    )

    strag = FaultConfig(stragglers=StragglerModel("exp", mean=1.0),
                        deadline=2.0)
    return [("bernoulli 0.5 realized", ParticipationConfig(rate=0.5)),
            ("bernoulli 0.5 expected",
             ParticipationConfig(rate=0.5, debias="expected")),
            ("subset 3", ParticipationConfig(kind="subset", subset=3)),
            ("bernoulli 0.5 + exp(1) straggler, deadline 2",
             ParticipationConfig(rate=0.5, faults=strag))]


def service_timed(torch, fedpg, env, pol, cfg, ota, seed, part, stale,
                  agent_blocks=None, theta0=None):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    theta, hist = fedpg.run(env, pol, cfg, seed, ota=ota, theta0=theta0,
                            agent_blocks=agent_blocks, participation=part,
                            staleness=stale, device="cuda")
    e.record()
    torch.cuda.synchronize()
    return theta, hist, s.elapsed_time(e) / cfg.n_rounds


def finite(torch, theta, hist):
    return (all(bool(torch.isfinite(x).all()) for x in hist)
            and all(bool(torch.isfinite(t).all()) for t in theta.values()))


def phase_service(torch):
    from repro_torch.core import fedpg, ota as ota_lib
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.service import (
        CrashSchedule, FaultConfig, ParticipationConfig, StalenessConfig,
    )

    t0 = phase("19. the round service at the paper's width (N=10 M=10 T=20, "
               "Rayleigh, debias)")
    env, pol = LandmarkNav(), MLPPolicy()
    cfg, ota = alg_config(10, 10, MAIN_ROUNDS)
    short = dataclasses.replace(cfg, n_rounds=SERVICE_STREAM_ROUNDS)
    stale_cfg = StalenessConfig(max_age=4, decay=0.8)
    # warm-up of every form, outside the counted runs
    for b in (None, 3):
        fedpg.run(env, pol, dataclasses.replace(cfg, n_rounds=2), 99, ota=ota,
                  participation=ParticipationConfig(rate=0.5),
                  staleness=stale_cfg, agent_blocks=b, device="cuda")
    torch.cuda.synchronize()
    seed_t = service_seed(torch, pol, 0)
    rows = []
    for name, part in service_configs():
        rate, expect = realised_rate(torch, part, seed_t, cfg.n_agents,
                                     cfg.n_rounds)
        rate_within(rate, expect, cfg.n_agents * cfg.n_rounds, name)
        for stale in (None, stale_cfg):
            row = {"config": name, "staleness": stale is not None,
                   "realised_rate": rate, "expected_rate": expect}
            reset_counts()
            theta, stacked, ms = service_timed(torch, fedpg, env, pol, cfg,
                                               ota, 0, part, stale)
            counts = read_counts()
            check(counts["ota_fused"] == cfg.n_rounds
                  and sum(counts.values()) == cfg.n_rounds,
                  f"{name}: stacked service launched {counts}, expected "
                  f"{cfg.n_rounds} K1 launches")
            check(finite(torch, theta, stacked), f"{name}: not finite")
            row["stacked"] = {"ms_per_round": ms, "k1_per_round": 1,
                              "reward_last10":
                                  stacked.rewards[-10:].mean().item(),
                              "avg_grad_sq": fedpg.avg_grad_sq(stacked).item()}
            hists = {}
            for b in STREAM_BLOCKS:
                n_blocks = ota_lib.blocked_layout(cfg.n_agents, b)[0]
                reset_counts()
                th_b, h_b, ms_b = service_timed(torch, fedpg, env, pol, short,
                                                ota, 0, part, stale,
                                                agent_blocks=b)
                counts = read_counts()
                per_block = 3 if stale is not None else 2
                expect_k1 = (per_block * n_blocks + 1) * short.n_rounds
                check(counts["ota_fused"] == expect_k1
                      and sum(counts.values()) == expect_k1,
                      f"{name} agent_blocks={b}: {counts}, expected "
                      f"{expect_k1} K1 launches")
                check(finite(torch, th_b, h_b), f"{name} b={b}: not finite")
                hists[b] = (th_b, h_b)
                row[f"streamed_{b}"] = {
                    "ms_per_round": ms_b, "n_blocks": n_blocks,
                    "k1_per_round": counts["ota_fused"] / short.n_rounds}
            first = hists[STREAM_BLOCKS[0]]
            for b in STREAM_BLOCKS[1:]:
                check(history_equal(torch, first[1], hists[b][1])
                      and all(torch.equal(first[0][k], hists[b][0][k])
                              for k in first[0]),
                      f"{name}: agent_blocks={b} is not bitwise "
                      f"agent_blocks={STREAM_BLOCKS[0]}")
            k = short.n_rounds
            check(torch.equal(first[1].gain_mean, stacked.gain_mean[:k]),
                  f"{name}: streamed gain means are not the stacked run's")
            drift = max(((first[1].rewards - stacked.rewards[:k]).abs()
                         / stacked.rewards[:k].abs().clamp_min(1e-30))
                        .max().item(),
                        ((first[1].grad_sq - stacked.grad_sq[:k]).abs()
                         / stacked.grad_sq[:k].abs().clamp_min(1e-30))
                        .max().item())
            row["streamed_vs_stacked_rel"] = drift
            rows.append(row)
            log(f"{name}{' + staleness (4, 0.8)' if stale else ''}: rate "
                f"{rate:.4f} (expected {expect:.4f}); stacked "
                f"{ms:.3f} ms/round (1 K1/round); streamed "
                + ", ".join(f"b={b} {row[f'streamed_{b}']['ms_per_round']:.3f}"
                            for b in STREAM_BLOCKS)
                + f" ms/round ({per_block} K1/block + 1), bitwise equal; "
                f"vs stacked {drift:.2e} relative")

    # full participation is the plain round, bit for bit
    plain_cfg = dataclasses.replace(cfg, n_rounds=SERVICE_STREAM_ROUNDS)
    for b in (None, 3):
        _, plain = fedpg.run(env, pol, plain_cfg, 0, ota=ota, agent_blocks=b,
                             device="cuda")
        _, full = fedpg.run(env, pol, plain_cfg, 0, ota=ota, agent_blocks=b,
                            participation=ParticipationConfig(rate=1.0),
                            staleness=stale_cfg, device="cuda")
        check(history_equal(torch, plain, full),
              f"full participation is not the plain round (agent_blocks={b})")
    # a round nobody makes leaves theta bitwise unchanged
    nobody = ParticipationConfig(kind="full", faults=FaultConfig(
        crashes=CrashSchedule(frac=1.0, period=1, down=1)))
    theta0 = pol.init(torch.Generator(device="cuda").manual_seed(3), "cuda")
    for b in (None, 3):
        for debias in ("realized", "expected"):
            th, h, _ = service_timed(
                torch, fedpg, env, pol, dataclasses.replace(cfg, n_rounds=3),
                ota, 0, dataclasses.replace(nobody, debias=debias), None,
                agent_blocks=b, theta0=theta0)
            check(all(torch.equal(th[k], theta0[k]) for k in th)
                  and bool(torch.all(h.grad_sq == 0)),
                  f"an empty round moved theta (agent_blocks={b}, {debias})")
    log("full participation == the plain round (stacked and streamed); "
        "empty rounds leave theta bitwise unchanged (realized, expected)")
    # where the time goes: 10 stacked service rounds, Bernoulli 0.5 with
    # staleness, beside the unprofiled time of the same configuration
    prof = profile_rounds(torch, lambda: fedpg.run(
        env, pol, dataclasses.replace(cfg, n_rounds=10), 2, ota=ota,
        participation=ParticipationConfig(rate=0.5), staleness=stale_cfg,
        device="cuda"), 10, rows[1]["stacked"]["ms_per_round"])
    log(f"stacked service round, bernoulli 0.5 + staleness, profiled: device "
        f"busy {prof['device_busy_us_per_round']:.1f} us over "
        f"{prof['device_launches_per_round']:.0f} launches a round; K1 "
        f"{prof['k1_us_per_round']:.1f} us; busy share of an unprofiled "
        f"{rows[1]['stacked']['ms_per_round']:.3f} ms round "
        f"{prof['busy_share']:.2%}")
    RECORD["service_profile"] = prof
    RECORD["service"] = rows
    done("service", t0)
    return rows


def phase_service_large(torch):
    from repro_torch.core import fedpg, ota as ota_lib
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.ota import OTAConfig
    from repro_torch.kernels import ota_fused
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.service import (
        FaultConfig, ParticipationConfig, StalenessConfig, StragglerModel,
    )

    t0 = phase("20. the round service at benchmarks/fig_participation.py's "
               "width (N=10^4 M=1 T=3)")
    env, pol = LandmarkNav(), MLPPolicy()
    ota = OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True)
    n = SERVICE_LARGE_N
    cfg = dataclasses.replace(alg_config(n, 1, SERVICE_LARGE_ROUNDS)[0],
                              horizon=3)
    stale = StalenessConfig(max_age=4, decay=0.8)
    strag = FaultConfig(stragglers=StragglerModel("exp", mean=1.0),
                        deadline=2.0)
    cases = [(f"rate {r}", ParticipationConfig(rate=r), s)
             for r in (0.25, 0.5) for s in (None, stale)]
    cases.append(("rate 0.5 + exp(1) straggler, deadline 2",
                  ParticipationConfig(rate=0.5, faults=strag), stale))
    fedpg.run(env, pol, dataclasses.replace(cfg, n_rounds=1), 99, ota=ota,
              participation=cases[0][1], staleness=stale,
              agent_blocks=LARGE_SERVICE_BLOCKS, device="cuda")
    torch.cuda.synchronize()
    seed_t = service_seed(torch, pol, 1)
    rows = []
    for name, part, st in cases:
        rate, expect = realised_rate(torch, part, seed_t, n, cfg.n_rounds)
        se = rate_within(rate, expect, n * cfg.n_rounds, name)
        row = {"config": name, "staleness": st is not None,
               "realised_rate": rate, "expected_rate": expect, "se": se}
        for form, blocks in (("stacked", None),
                             ("streamed", LARGE_SERVICE_BLOCKS)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            reset_counts()
            theta, hist, ms = service_timed(torch, fedpg, env, pol, cfg, ota,
                                            1, part, st, agent_blocks=blocks)
            counts = read_counts()
            check(finite(torch, theta, hist), f"N={n} {name} {form}: "
                  "not finite")
            n_blocks = ota_lib.blocked_layout(n, LARGE_SERVICE_BLOCKS)[0]
            per_round = 1 if blocks is None else (
                (3 if st is not None else 2) * n_blocks + 1)
            check(counts["ota_fused"] == per_round * cfg.n_rounds,
                  f"N={n} {name} {form}: {counts['ota_fused']} K1 launches, "
                  f"expected {per_round * cfg.n_rounds}")
            bodies = k1_body_counts()
            check(blocks is not None or bodies["tall"] == cfg.n_rounds,
                  f"N={n} {name} stacked: {bodies}, expected the tall body "
                  f"every round")
            row[form] = {"ms_per_round": ms,
                         "peak_mb": (torch.cuda.max_memory_allocated()
                                     - resident) / 1e6,
                         "k1_per_round": per_round,
                         "k1_tall_launches": bodies["tall"]}
        rows.append(row)
        log(f"N={n} {name}{' + staleness (4, 0.8)' if st else ''}: rate "
            f"{rate:.5f} (expected {expect:.5f}, se {se:.1e}) | stacked "
            f"{row['stacked']['ms_per_round']:.1f} ms, peak "
            f"{row['stacked']['peak_mb']:.1f} MB, 1 K1/round | streamed "
            f"({LARGE_SERVICE_BLOCKS} per block) "
            f"{row['streamed']['ms_per_round']:.1f} ms, peak "
            f"{row['streamed']['peak_mb']:.1f} MB, "
            f"{row['streamed']['k1_per_round']} K1/round")
    # K1 at the stacked service round's shape: (10^4, 165), masked gains,
    # the rule's tall body against the wide body, in turns
    g, h, p, _, _ = k1_inputs(torch, n, 165, 5)
    h = torch.where(torch.rand(n, device="cuda") < 0.5, h,
                    torch.zeros_like(h))
    kw = dict(sigma=1e-3, scale=1.0 / (n * RAYLEIGH_MH), seed=11)
    check(ota_fused.k1_body(n, 165) == "tall", "the rule keeps 10^4 wide")
    ms = k1_turns(torch, lambda: ota_fused.fused_aggregate(g, h, **kw),
                  ("tall", "wide"))
    bound, by = k1_bound(n, 165, 4, "agg")
    k1 = {"A": n, "P": 165, "mode": "agg", "ms": ms["tall"],
          "ms_wide_body": ms["wide"], "bound_ms": bound, "bound_by": by}
    floor = k1_fold_floor(n)
    log(f"K1 agg at (10^4, 165) f32: tall {ms['tall'] * 1e3:.2f} us, the "
        f"wide body {ms['wide'] * 1e3:.2f} us "
        f"({ms['wide'] / ms['tall']:.2f}x; "
        f"bound {bound * 1e3:.3f} us, {by}, {bound / ms['tall']:.2%} of it; "
        f"fold floor {floor * 1e3:.2f} us)")
    RECORD["service_large"] = {"rows": rows, "k1": k1,
                               "k1_fold_floor_ms": floor}
    done("service large", t0)
    return rows, k1


def reference(name):
    """One of the JAX package's reference files under ``perf/``."""
    return json.loads((ROOT / "perf" / name).read_text())


def held_line(what, h, ref_mean, ref_se, stat="mean"):
    """A log line of a value held to the reference, and the check."""
    log(f"{what}: {h.mean:.4f} +- {h.se:.4f} ({stat}; reference "
        f"{ref_mean:.4f} +- {ref_se:.4f}, z {h.z:+.2f})")
    check(h.ok, f"{what}: {h.mean} is {h.z:+.2f} combined standard errors "
                f"from the reference's {ref_mean}")
    return {"mean": h.mean, "se": h.se, "ref_mean": ref_mean,
            "ref_se": ref_se, "z": h.z, "statistic": stat}


def hold_row(port_runs, ref_runs, what):
    """``figures.hold_runs`` of per-run values, logged and checked."""
    import numpy as np

    from repro_torch import figures

    stat, h = figures.hold_runs(port_runs, ref_runs)
    ref = np.asarray(ref_runs, np.float64)
    ref = np.log(ref) if stat == "log_mean" else ref
    rm, rse = figures.mean_se(ref)
    return held_line(what, h, rm, rse, stat)


def checked_sweep(torch, env, pol, scens, seed, runs, expect_k1, what,
                  telemetry=None):
    """The scenarios of one partition as one ``sweep(mode="vmap")`` call
    of ``runs`` lanes a scenario on the card: one partition, its K1
    launches checked (``expect_k1``, all of one body), its history finite;
    returns the result, launches, the body and ms per batched round."""
    import numpy as np

    from repro_torch.core import sweep

    reset_counts()
    res = sweep.sweep(env, pol, scens, seed, runs, mode="vmap",
                      telemetry=telemetry, device="cuda")
    launches, bodies = read_counts()["ota_fused"], k1_body_counts()
    check(res.n_partitions == 1, f"{what}: split into {res.n_partitions} "
                                 f"partitions")
    check(launches == expect_k1 and sum(bool(c) for c in bodies.values())
          <= 1, f"{what}: {launches} K1 launches ({bodies}), expected "
                f"{expect_k1} of one body")
    check(all(np.isfinite(np.asarray(x, np.float64)).all()
              for x in res.history), f"{what}: history not finite")
    body = next((b for b, c in bodies.items() if c), None)
    ms = res.partitions[0].wall_time_us / 1e3 / scens[0].n_rounds
    return res, launches, body, ms


def per_run_values(h, tail):
    """A scenario's per-run avg_grad_sq and last-``tail``-round reward."""
    import numpy as np

    return (np.asarray(h.grad_sq, np.float64).mean(axis=1),
            np.asarray(h.rewards, np.float64)[:, -tail:].mean(axis=1))


def sweep_partition(torch, env, pol, s, seed, runs, expect_k1, what):
    """One scenario as one partition of ``runs`` lanes on the card
    (:func:`checked_sweep`); returns the result, per-run avg_grad_sq and
    last-20 rewards, launches and ms per batched round."""
    res, launches, _, ms = checked_sweep(torch, env, pol, [s], seed, runs,
                                         expect_k1, what)
    per_g, per_r = per_run_values(res.history.lane(0), FIG12_TAIL)
    return res, per_g, per_r, launches, ms


def phase_et(torch):
    """``benchmarks/et_baseline.py`` held to the JAX package's 20 runs a
    setting (``perf/et_reference.json``): the over-the-air run as 20 lanes
    of one sweep partition, the event-triggered runs one after another."""
    import numpy as np

    from repro_torch import figures
    from repro_torch.core import event_triggered as et
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.service import ParticipationConfig

    ref = reference("et_reference.json")
    want = {r["run"]: r for r in ref["rows"]}
    cfg, ota = figures.et_setting()
    st = ref["setting"]
    check((st["n_rounds"], st["n_agents"], st["batch_m"], st["alpha"],
           st["horizon"], st["gamma"], tuple(st["taus"]), st["runs"])
          == (cfg.n_rounds, cfg.n_agents, cfg.batch_m, cfg.alpha, cfg.horizon,
              cfg.gamma, figures.ET_TAUS, ET_REF_RUNS)
          and st["noise_sigma"] == ota.noise_sigma,
          "perf/et_reference.json holds another setting")
    # every agent uploads every round at both taus in the reference, so a
    # run is the same at either tau: the taus are checked bitwise on
    # ET_TAU_SEEDS seeds, the runs held once, at the first tau
    check(all(want[f"et_{t:g}"]["every_agent_every_round"]
              for t in figures.ET_TAUS),
          "perf/et_reference.json: an agent skipped an upload; phase 21 "
          "holds only runs where every agent uploads every round")
    t0 = phase(f"21. ET against OTA (benchmarks/et_baseline.py: N="
               f"{cfg.n_agents} M={cfg.batch_m} K={cfg.n_rounds} alpha="
               f"{cfg.alpha}): OTA {ET_REF_RUNS} lanes, ET {ET_RUNS} runs")
    env, pol = LandmarkNav(), MLPPolicy()
    et.run(env, pol, dataclasses.replace(cfg, n_rounds=2),
           et.ETConfig(0.1), 99, agent_blocks=4,
           participation=ParticipationConfig(rate=0.5), device="cuda")
    _, _, per_r, launches, ms = sweep_partition(
        torch, env, pol, figures.et_scenario(cfg, ota), 0, ET_REF_RUNS,
        cfg.n_rounds, "ET's OTA partition")
    rows = [{"run": "ota", "final_reward": float(per_r.mean()),
             "channel_uses_per_round": 1.0, "ms_per_round": ms,
             "k1_launches": launches, "rounds": cfg.n_rounds,
             "lanes": ET_REF_RUNS,
             "held": {"final_reward": held_line(
                 "OTA final reward", figures.hold(
                     per_r, want["ota"]["final_reward"],
                     want["ota"]["final_reward_se"]),
                 want["ota"]["final_reward"],
                 want["ota"]["final_reward_se"])}}]

    def et_timed(tau, seed, part=None, blocks=None):
        reset_counts()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        th, h = et.run(env, pol, cfg, et.ETConfig(tau), seed,
                       agent_blocks=blocks, participation=part,
                       device="cuda")
        e.record()
        torch.cuda.synchronize()
        check(finite(torch, th, h), f"ET tau={tau} seed {seed}: not finite")
        check(read_counts()["ota_fused"] == 0, "the ET uplink launched K1")
        return h, s.elapsed_time(e) / cfg.n_rounds

    n, tau, tau2 = cfg.n_agents, *figures.ET_TAUS
    runs = [et_timed(tau, seed) for seed in range(ET_RUNS)]
    rew = np.array([h.rewards[-20:].mean().item() for h, _ in runs])
    check(all(bool((h.uploads == n).all()) for h, _ in runs),
          f"ET tau {tau:g}: an agent did not upload in a round where the "
          f"reference's all do")
    row = {"run": f"et tau {tau:g}", "final_reward": float(rew.mean()),
           "channel_uses_per_round": float(np.mean(
               [h.uploads.mean().item() for h, _ in runs])),
           "ms_per_round": statistics.mean(ms for _, ms in runs),
           "runs": ET_RUNS, "held": {}}
    for t in figures.ET_TAUS:
        w = want[f"et_{t:g}"]
        row["held"][f"final_reward at tau {t:g}"] = held_line(
            f"ET final reward, {ET_RUNS} runs, against tau {t:g}'s",
            figures.hold(rew, w["final_reward"], w["final_reward_se"]),
            w["final_reward"], w["final_reward_se"])
    for seed in range(ET_TAU_SEEDS):
        h, _ = et_timed(tau2, seed)
        check(history_equal(torch, h, runs[seed][0]),
              f"ET seed {seed}: tau {tau2:g} is not bitwise tau {tau:g}'s "
              f"run")
    log(f"ET seeds 0-{ET_TAU_SEEDS - 1}: tau {tau2:g} bitwise tau {tau:g}'s "
        f"runs; every agent uploaded every round in all {ET_RUNS} runs")
    rows.append(row)
    et_uses = rows[1]["channel_uses_per_round"]
    check(et_uses > 3.0, f"et_uses {et_uses} <= 3: the scaling claim "
                         f"(et_baseline.py:61) failed")

    part = ParticipationConfig(rate=0.5)
    hp, ms_p = et_timed(0.1, 0, part)
    hb, ms_b = et_timed(0.1, 0, part, 4)
    check(history_equal(torch, hp, hb),
          "ET with participation depends on agent_blocks")
    for name, h, ms in (("et tau 0.1, bernoulli 0.5", hp, ms_p),
                        ("et tau 0.1, bernoulli 0.5, agent_blocks 4", hb,
                         ms_b)):
        rows.append({"run": name,
                     "final_reward": h.rewards[-20:].mean().item(),
                     "channel_uses_per_round": h.uploads.mean().item(),
                     "ms_per_round": ms})
    for r in rows:
        log(f"{r['run']:42s} final reward {r['final_reward']:.4f}  channel "
            f"uses/round {r['channel_uses_per_round']:.2f}  "
            f"{r['ms_per_round']:.3f} ms/round")
    log(f"OTA: {launches} K1 lane launches, one a round of {ET_REF_RUNS} "
        f"lanes; ET with participation: agent_blocks None and 4 bitwise "
        f"equal; et_uses {et_uses:.1f} > 3")
    RECORD["et"] = rows
    done("ET", t0)
    return rows


def phase_zoo(torch):
    from repro_torch.core import fedpg, gpomdp
    from repro_torch.rl import envs
    from repro_torch.rl.sampler import rollout_batch

    t0 = phase("22. the environment zoo through Algorithm 2 (N=10 M=10 T=20, "
               "K=20, K1)")
    _, ota = alg_config(10, 10, ZOO_ROUNDS)
    cfg = fedpg.FedPGConfig(n_agents=10, batch_m=10, horizon=20, gamma=0.99,
                            alpha=1e-4, n_rounds=ZOO_ROUNDS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fleet = envs.make_heterogeneous_env(
        [envs.WindyLandmarkNav(wind=0.02 * i) for i in range(cfg.n_agents)])
    zoo = [("landmark", envs.make_env("landmark")),
           ("windy", envs.WindyLandmarkNav(wind=0.05)),
           ("multilandmark", envs.MultiLandmarkNav(n_landmarks=3)),
           ("cliffwalk", envs.CliffWalk(width=6, height=4, slip=0.05)),
           ("lqr", envs.LQRTask()),
           ("tabular", envs.garnet(gen, n_states=8, n_actions=4,
                                   branching=3)),
           ("hetero", fleet)]
    check(sorted(n for n, _ in zoo) == sorted(envs.registered_envs()),
          "a registered family is missing from the zoo phase")
    rows = []
    for name, env in zoo:
        pol = envs.default_policy(env)
        reset_counts()
        theta, hist, ms = timed_run(torch, fedpg, env, pol, cfg, ota, 0)
        counts = read_counts()
        check(counts["ota_fused"] == cfg.n_rounds,
              f"{name}: {counts['ota_fused']} K1 launches, expected "
              f"{cfg.n_rounds}")
        check(finite(torch, theta, hist), f"{name}: not finite")
        rows.append({"env": name, "policy": type(pol).__name__,
                     "ms_per_round": ms, "k1_launches": counts["ota_fused"],
                     "reward_first5": hist.rewards[:5].mean().item(),
                     "reward_last5": hist.rewards[-5:].mean().item()})
        log(f"{name:14s} {type(pol).__name__:21s} {ms:7.3f} ms/round, "
            f"{counts['ota_fused']} K1 launches, reward first5 "
            f"{rows[-1]['reward_first5']:.4f} last5 "
            f"{rows[-1]['reward_last5']:.4f}")
    # the exact anchor: G(PO)MDP on the card against exact_J's gradient
    mdp = dict(zoo)["tabular"]
    pol = mdp.default_policy()
    theta = pol.init(gen, "cuda")
    t = theta["theta"].clone().requires_grad_()
    (g_exact,) = torch.autograd.grad(
        mdp.exact_J(pol.action_probs({"theta": t})), t)
    trajs = rollout_batch(mdp, pol, theta, gen, mdp.horizon,
                          (ZOO_GRAD_AGENTS, ZOO_GRAD_M))
    g = gpomdp.per_agent_gradients(pol, theta, trajs, mdp.gamma)["theta"]
    se = g.std(0) / ZOO_GRAD_AGENTS ** 0.5
    z = ((g.mean(0) - g_exact).abs() / se).max().item()
    check(z <= 5.0, f"G(PO)MDP mean {z:.2f} standard errors from exact_J's "
          "gradient")
    log(f"garnet (8 states, 4 actions): G(PO)MDP mean over {ZOO_GRAD_AGENTS} "
        f"agents x {ZOO_GRAD_M} trajectories within {z:.2f} standard errors "
        f"of exact_J's autograd gradient (largest component; 5 allowed)")
    RECORD["zoo"] = {"rows": rows, "exact_grad_max_z": z}
    done("zoo", t0)
    return rows



# ---------------------------------------------------------------------------
# phases 26-28: the round-service driver, the trainer at full width, resume
# ---------------------------------------------------------------------------

DRIVER_ROUNDS, DRIVER_RPC = 32, 4
DRIVER_LARGE_ROUNDS, DRIVER_LARGE_RPC = 8, 2
DRIVER_TURNS = 5
TRAIN_STEPS, TRAIN_EXACT_STEPS = 4, 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_AGENTS = 8, 256, 4
K1_WINDOW = 2 ** 20
K1_ROW_TIMES = 10
RESUME_STEPS, LOSS_STEPS = 6, 100
EXAMPLE_BATCH, EXAMPLE_SEQ = 16, 256
FIG12_RESULTS = []             # phase 5's SweepResults, for the run ledger
SERVICE_FLOATS = ("reward", "grad_sq", "gain_mean", "participation_rate",
                  "participation_drift", "staleness_mean", "staleness_hist")


def fresh_dir(name, keep=False):
    """An empty directory for checkpoints: under ``chiprun_out/`` when
    ``keep`` (small ones, brought back), else under the gitignored
    ``build/chip_smoke/`` (``drop_scratch`` removes it)."""
    import shutil

    path = ROOT / ("chiprun_out" if keep else "build/chip_smoke") / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def drop_scratch():
    import shutil

    shutil.rmtree(ROOT / "build" / "chip_smoke", ignore_errors=True)


def recorded_rounds(torch, svc):
    """Wrap ``svc``'s round so every round's (reward, grad_sq, gain_mean)
    is kept: a service's per-round history, whatever its commit size."""
    rows, fn = [], svc._round_fn

    def round_fn(*args):
        state, m = fn(*args)
        rows.append(torch.stack(m[:3]))
        return state, m

    svc._round_fn = round_fn
    return rows


def service_state_bits(svc):
    st = svc.state
    parts = [("theta", st.theta), ("stale", st.stale.grads)]
    out = {f"{name}/{k}": v.cpu().numpy().tobytes()
           for name, tree in parts for k, v in tree.items()}
    out["age"] = st.stale.age.cpu().numpy().tobytes()
    out["seed"] = st.seed.cpu().numpy().tobytes()
    return st.round_idx, out


def driver_cell(torch, make, rounds, rpc, what):
    """A straight service against an interrupted twin (two commits ... one
    commit, a checkpoint, a FRESH service that resumes) and, at the paper's
    width, commits of 1: state, later records and per-round histories
    bitwise.  Returns the straight run's ms per round, K1 launches by body
    and records."""
    keep = what == "paper"
    ck_a = fresh_dir(f"ckpt_{what}_a", keep)
    ck_b = fresh_dir(f"ckpt_{what}_b", keep)
    ref = make(rpc, rounds, ck_a)
    hist = recorded_rounds(torch, ref)
    torch.cuda.synchronize()
    reset_counts()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    recs = ref.run()
    e.record()
    torch.cuda.synchronize()
    launches, bodies = read_counts()["ota_fused"], k1_body_counts()
    ms = s.elapsed_time(e) / rounds
    check(launches == rounds, f"{what}: {launches} K1 launches in {rounds} "
          f"stacked rounds, expected one a round")
    cut = 2 if rounds // rpc > 2 else 1
    a = make(rpc, rounds, ck_b)
    for _ in range(cut):
        a.commit()
    b = make(rpc, rounds, ck_b)
    check(b.resume() and b.state.round_idx == cut * rpc,
          f"{what}: resume did not find commit {cut}")
    tail = recorded_rounds(torch, b)
    later = b.run()
    check(service_state_bits(b) == service_state_bits(ref),
          f"{what}: the resumed service's state is not bitwise the straight "
          f"run's")
    check([{k: r[k] for k in SERVICE_FLOATS} for r in later]
          == [{k: r[k] for k in SERVICE_FLOATS} for r in recs[cut:]],
          f"{what}: later commit records differ after the resume")
    check(torch.equal(torch.stack(tail), torch.stack(hist[cut * rpc:])),
          f"{what}: per-round history differs after the resume")
    return ms, launches, bodies, recs, hist, service_state_bits(ref)


def driver_turns(torch, make, env, pol, cfg, ota, part, stale):
    """The same service rounds through a bare ``RoundService`` (no
    telemetry, checkpoint or recording hook; ``make``) and through
    ``fedpg.run`` (phase 19's stacked service round), timed with CUDA
    events in turns, ``DRIVER_TURNS`` each: ms per round."""
    from repro_torch.core import fedpg

    got = {"driver": [], "fedpg": []}
    for _ in range(DRIVER_TURNS):
        svc = make(DRIVER_RPC, cfg.n_rounds)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        svc.run()
        e.record()
        torch.cuda.synchronize()
        got["driver"].append(s.elapsed_time(e) / cfg.n_rounds)
        got["fedpg"].append(service_timed(torch, fedpg, env, pol, cfg, ota,
                                          7, part, stale)[2])
    med = {k: statistics.median(v) for k, v in got.items()}
    return {"driver_ms": med["driver"], "fedpg_ms": med["fedpg"],
            "ratio": med["driver"] / med["fedpg"],
            "driver_all": [round(x, 3) for x in got["driver"]],
            "fedpg_all": [round(x, 3) for x in got["fedpg"]]}


def phase_driver(torch, service_rows):
    from repro_torch.core.fedpg import FedPGConfig
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.service import (
        ParticipationConfig, RoundService, ServiceConfig, StalenessConfig,
    )
    from repro_torch.telemetry import (
        Ledger, TelemetryConfig, read_ledger, report, using_ledger,
    )

    t0 = phase(f"26. the round-service driver (N=10 M=10 T=20, Bernoulli "
               f"0.5, staleness (4, 0.8), {DRIVER_ROUNDS} rounds in commits "
               f"of {DRIVER_RPC}; then N=10^4 M=1 T=3)")
    env, pol = LandmarkNav(), MLPPolicy()
    cfg, ota = alg_config(10, 10, 1)
    part = ParticipationConfig(rate=0.5)
    stale = StalenessConfig(max_age=4, decay=0.8)

    def make_for(c, telemetry=TelemetryConfig()):
        def make(rpc, rounds, ckpt=""):
            return RoundService(
                env, pol, c, 7, participation=part, staleness=stale,
                ota=ota, telemetry=telemetry,
                service=ServiceConfig(rounds_per_commit=rpc,
                                      max_rounds=rounds,
                                      checkpoint_dir=str(ckpt)),
                device="cuda")
        return make

    make = make_for(cfg)
    make(1, 2).run()           # warm-up, outside the timed run
    out = ROOT / "chiprun_out"
    ledger_path = out / "ledger.jsonl"
    with Ledger(str(ledger_path)) as led, using_ledger(led):
        led.log_platform()
        for res in FIG12_RESULTS:
            led.log_sweep(res, label="fig12")
        ms, launches, bodies, recs, hist, bits = driver_cell(
            torch, make, DRIVER_ROUNDS, DRIVER_RPC, "paper")
    check(bodies["wide"] == DRIVER_ROUNDS, f"paper width: {bodies}")
    one = make(1, DRIVER_ROUNDS)
    hist_one = recorded_rounds(torch, one)
    one.run()
    check(service_state_bits(one) == bits
          and torch.equal(torch.stack(hist_one), torch.stack(hist)),
          f"rounds_per_commit 1 and {DRIVER_RPC}: states or per-round "
          f"histories differ")
    ref_row = service_rows[1]
    check(ref_row["config"] == "bernoulli 0.5 realized"
          and ref_row["staleness"], "phase 19's row order changed")
    p19 = ref_row["stacked"]["ms_per_round"]
    turns = driver_turns(torch, make_for(cfg, telemetry=None), env, pol,
                         dataclasses.replace(cfg, n_rounds=DRIVER_ROUNDS),
                         ota, part, stale)
    text = report.render(read_ledger(str(ledger_path)),
                         title="chip_smoke run ledger")
    check("## Round service" in text and "### Scenarios" in text,
          "REPORT.md lacks the round-service or the sweep section")
    (out / "REPORT.md").write_text(text)
    log(f"paper width: {ms:.3f} ms per round through the driver with "
        f"telemetry, a checkpoint a commit and the recording hook "
        f"({DRIVER_ROUNDS} rounds, {len(recs)} commits; phase 19's stacked "
        f"service round {p19:.3f} ms); bare driver against fedpg.run in "
        f"{DRIVER_TURNS} turns: medians {turns['driver_ms']:.3f} / "
        f"{turns['fedpg_ms']:.3f} ms per round ({turns['ratio']:.3f}x; "
        f"driver {turns['driver_all']}, fedpg.run {turns['fedpg_all']}); "
        f"K1 {launches} launches ({bodies}); resume "
        f"after commit 2 bitwise (state, {len(recs) - 2} records, "
        f"{DRIVER_ROUNDS - 2 * DRIVER_RPC} rounds); commits of 1 and "
        f"{DRIVER_RPC} bitwise; ledger {ledger_path.name} -> REPORT.md")
    large_cfg = FedPGConfig(n_agents=SERVICE_LARGE_N, batch_m=1, horizon=3,
                            gamma=cfg.gamma, alpha=cfg.alpha, n_rounds=1)
    make_large = make_for(large_cfg)
    make_large(1, 1).run()    # warm-up
    ms_l, launches_l, bodies_l, recs_l, _, _ = driver_cell(
        torch, make_large, DRIVER_LARGE_ROUNDS, DRIVER_LARGE_RPC, "large")
    check(bodies_l["tall"] == DRIVER_LARGE_ROUNDS,
          f"N=10^4: {bodies_l}, expected the tall body every round")
    log(f"N=10^4: {ms_l:.3f} ms per round through the driver "
        f"({DRIVER_LARGE_ROUNDS} rounds in commits of {DRIVER_LARGE_RPC}); "
        f"K1 {launches_l} launches ({bodies_l}); resume after commit 1 "
        f"bitwise; realised rate {recs_l[0]['participation_rate']:.4f}")
    RECORD["driver"] = {
        "paper": {"ms_per_round": ms, "phase19_stacked_ms_per_round": p19,
                  "bare_driver_vs_fedpg_run": turns,
                  "k1_launches": launches, "k1_per_round": 1,
                  "records": recs},
        "large": {"ms_per_round": ms_l, "k1_launches": launches_l,
                  "k1_tall_launches": bodies_l["tall"], "k1_per_round": 1,
                  "records": recs_l}}
    drop_scratch()
    done("driver", t0)
    return RECORD["driver"]


def train_config(aggregator, steps, **kw):
    from repro_torch.train import trainer

    return trainer.TrainConfig(
        aggregator=aggregator, channel="rayleigh", noise_db=-60.0,
        debias=True, n_agents=TRAIN_AGENTS, total_steps=steps, **kw)


def timed_train_steps(torch, step, state, batches, what):
    """Each of ``batches`` through ``step`` (CUDA events around each), then
    one more step under the profiler.  Asserts finite metrics and no K3 or
    K4 launch (the trainers' forward is the differentiable one).  Returns
    the state and the record: ms a step, metrics, K1 launches by body, peak
    memory since the caller's ``reset_peak_memory_stats``, the profile."""
    torch.cuda.synchronize()
    reset_counts()
    times, metrics = [], []
    for batch in batches:
        s, e = events(torch)
        s.record()
        state, m = step(state, batch)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
        metrics.append({k: v.item() for k, v in m.items()})
    counts, bodies = read_counts(), k1_body_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(not any(counts[k] for k in K34),
          f"{what}: a train step launched K3/K4: {counts}")
    for m in metrics:
        check(all(math_isfinite(v) for v in m.values()),
              f"{what}: metrics not finite: {m}")
    ms_step = statistics.median(times[1:])
    log(f"{what}: {len(batches)} steps: ms per step "
        f"{[round(t, 1) for t in times]} (median after the first "
        f"{ms_step:.1f}); loss {[round(m['loss'], 4) for m in metrics]}; "
        f"grad norm {[round(m['grad_norm'], 3) for m in metrics]}; peak "
        f"{peak_gb:.2f} GB allocated; K1 {counts['ota_fused']} launches "
        f"({bodies})")
    # where a step's time goes: the profiler over one more step; its busy
    # time against the unprofiled step (the profiled window's own length
    # holds the profiler's work)
    kernels, busy_us, (state, _) = device_kernels(
        torch, lambda: step(state, batches[0]))
    busy_share = busy_us / (ms_step * 1e3)
    top = [{"kernel": k.key[:80], "us": k.device_us, "calls": k.count,
            "share": k.device_us / busy_us} for k in kernels[:8]]
    k1_us = sum(k.device_us for k in kernels if "ota_fused" in k.key)
    log(f"{what}: profiled step: device busy {busy_us / 1e3:.1f} ms, "
        f"{busy_share:.1%} of the unprofiled {ms_step:.1f} ms step; K1 "
        f"{k1_us / 1e3:.2f} ms ({k1_us / busy_us:.1%} of busy, "
        f"{k1_us / (ms_step * 1e3):.1%} of the step); top kernels:")
    for t in top:
        log(f"  {t['us'] / 1e3:8.2f} ms {t['share']:6.1%} x{t['calls']:<5d} "
            f"{t['kernel']}")
    return state, {"steps": metrics, "ms_per_step": times,
                   "ms_per_step_median": ms_step, "peak_gb": peak_gb,
                   "profile": {"busy_us": busy_us,
                               "busy_share_of_unprofiled": busy_share,
                               "k1_us": k1_us, "top": top},
                   "k1_launches": counts["ota_fused"], "k1_bodies": bodies,
                   "k1_per_step": 1}


def k1_unit_row(torch, d, wires, windows):
    """K1 at the trainer's ``(1, d)`` unit-gain row (agg with noise), for
    each wire: bitwise its plain version on each window of the output, then
    timed (median of ``K1_ROW_TIMES``) beside its byte bound, ``torch.mv``
    (cuBLAS takes sizes below 2^31 only) and the plain version on one
    window."""
    from repro_torch.kernels import ota_fused, ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    row = torch.randn(1, d, device="cuda", generator=gen)
    ones = torch.ones(1, device="cuda")
    kw = dict(sigma=float(ref.f32(1e-3) / TRAIN_AGENTS),
              scale=1.0 / RAYLEIGH_MH, seed=123457, with_noise=True)
    rows = {}
    for wire in wires:
        g = row.to(torch.bfloat16) if wire == "bf16" else row
        wdt = torch.bfloat16 if wire == "bf16" else None
        check(ota_fused.k1_body(1, d, g.dtype, data_ptr=g.data_ptr())
              == "wide", "the rule must give (1, d) to the wide body")
        out = ota_fused.fused_aggregate(g, ones, wire_dtype=wdt, **kw)
        err = 0.0
        for lo, hi in windows:
            want = ref.ota_fused_ref(
                g[:, lo:hi], ones,
                ref.counter_noise(kw["seed"], hi - lo, "cuda", start=lo),
                sigma=kw["sigma"], scale=kw["scale"])
            check(torch.equal(out[lo:hi], want),
                  f"K1 (1, d) {wire}: window [{lo}, {hi}) not bitwise its "
                  f"plain version")
            err = max(err, (out[lo:hi] - want).abs().max().item())
        del out
        ms = device_ms(torch, lambda: ota_fused.fused_aggregate(
            g, ones, wire_dtype=wdt, **kw), iters=K1_ROW_TIMES, warmup=1,
            sleep_cycles=0)
        bound, by = k1_bound(1, d, 2 if wire == "bf16" else 4, "agg")
        lib = None
        if d < 2 ** 31:
            vec = ones.to(g.dtype)
            lib = device_ms(torch, lambda: torch.mv(g.t(), vec),
                            iters=K1_ROW_TIMES, warmup=1, sleep_cycles=0)
        lo, hi = windows[-1]
        plain = device_ms(torch, lambda: ref.ota_fused_ref(
            g[:, lo:hi], ones, ref.counter_noise(kw["seed"], hi - lo,
                                                 "cuda", start=lo),
            sigma=kw["sigma"], scale=kw["scale"]), iters=K1_ROW_TIMES,
            warmup=1, sleep_cycles=0)
        rows[wire] = {"A": 1, "P": d, "wire": wire, "ms": ms,
                      "bound_ms": bound, "bound_by": by, "library_ms": lib,
                      "plain_ms_window": plain, "window": hi - lo,
                      "max_abs_err": err}
        lib_text = ("torch.mv refuses n >= 2^31" if lib is None
                    else f"torch.mv {lib:.3f} ms")
        log(f"K1 agg (1, {d}) {wire} wire: {ms:.3f} ms (median of "
            f"{K1_ROW_TIMES}); byte bound {bound:.3f} ms ({by}, "
            f"{bound / ms:.1%} of it); {lib_text}; plain version on a "
            f"{hi - lo} window {plain:.3f} ms; {len(windows)} windows "
            f"bitwise")
        del g
    del row
    torch.cuda.empty_cache()
    return rows


def phase_train(torch):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import model as model_lib
    from repro_torch.train import trainer
    from repro_torch.utils.tree import flatten_paths

    cfg = get_config("llama3.2-3b")
    t0 = phase(f"27. train llama3.2-3b at full width ({cfg.n_layers} layers, "
               f"d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}), OTA "
               f"through K1, B={TRAIN_BATCH} S={TRAIN_SEQ}, "
               f"{TRAIN_AGENTS} agents")
    gc.collect()     # the peak below is this phase's, whatever the collector
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = model_lib.build(cfg)
    tcfg = train_config("ota", TRAIN_STEPS, lr=1e-4, warmup=2,
                        wire_dtype="bfloat16")
    state = trainer.init_state(model, tcfg, device="cuda")
    d = sum(v.numel() for v in flatten_paths(state.params).values())
    log(f"d = {d} parameters ({d / 2 ** 31:.3f} x 2^31); wire bf16")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH), "cuda")
    step = trainer.make_train_step(model, tcfg)
    batches = [data.batch(i) for i in range(TRAIN_STEPS)]
    state, res = timed_train_steps(torch, step, state, batches,
                                   "llama3.2-3b")
    check(res["k1_launches"] == res["k1_bodies"]["wide"] == TRAIN_STEPS,
          f"train: {res['k1_launches']} K1 launches ({res['k1_bodies']}), "
          f"expected one wide launch a step")
    # for phase 46: the host syncs of one more OTA step on this state, and
    # the gradient's leaves (shapes and dtype)
    state, RECORD["train_syncs"] = train_step_syncs(torch, step, state,
                                                    batches[0])
    RECORD["train_leaves"] = [
        (list(v.shape), str(v.dtype).replace("torch.", ""))
        for v in flatten_paths(state.params).values()]
    # two exact steps: Algorithm 1 makes no K1 launch
    exact = trainer.make_train_step(model, train_config(
        "exact", TRAIN_STEPS, lr=1e-4, warmup=2))
    reset_counts()
    for i in range(TRAIN_EXACT_STEPS):
        state, m = exact(state, batches[i])
        check(math_isfinite(m["loss"].item()), "exact step: loss not finite")
    torch.cuda.synchronize()
    check(read_counts()["ota_fused"] == 0, "exact steps launched K1")
    del state, step, exact, batches
    torch.cuda.empty_cache()

    # K1 at (1, d): windows against the plain version, bitwise in agg
    rows = k1_unit_row(torch, d, ("bf16", "f32"),
                       [(0, K1_WINDOW), (2 ** 31, 2 ** 31 + K1_WINDOW),
                        (d - K1_WINDOW, d)])
    res.pop("k1_bodies")
    RECORD["train"] = {"d": d, **res, "k1_row": rows}
    done("train", t0)
    return RECORD["train"]


def train_step_syncs(torch, step, state, batch):
    """One train step under ``analyze.budget.SyncCounter``: the state and
    the host-device syncs PyTorch made in it (K1's launch is invisible to
    the count)."""
    from repro_torch.analyze import budget

    torch.cuda.synchronize()
    with budget.SyncCounter() as sc:
        state, m = step(state, batch)
    torch.cuda.synchronize()
    check(all(math_isfinite(v.item()) for v in m.values()),
          "the counted train step's metrics are not finite")
    log(f"llama3.2-3b OTA train step: {sc.count} host syncs (PyTorch's own; "
        f"phase 46)")
    return state, sc.count


def math_isfinite(x):
    return x == x and abs(x) != float("inf")


def state_equal(torch, a, b):
    from repro_torch.utils.tree import flatten_paths

    trees = ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu))
    same = all(torch.equal(x[k], y[k]) for ta, tb in trees
               for x, y in [(flatten_paths(ta), flatten_paths(tb))]
               for k in x)
    return (same and torch.equal(a.opt_state.step, b.opt_state.step)
            and int(a.step) == int(b.step))


RESUME_CHILD = "--train-resume-child"


def resume_setup():
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import train as launch

    shape = InputShape("example", EXAMPLE_SEQ, EXAMPLE_BATCH, "train")
    tcfg = train_config("ota", LOSS_STEPS, microbatch=2, lr=1e-3, warmup=20)
    return launch, launch.example_config(), tcfg, shape


def phase_resume(torch):
    """Two straight runs here, without deterministic algorithms; the
    resume and the 100 steps in a child process (``resume_child``) that
    alone gets the deterministic cuBLAS workspace, so no other phase runs
    under it."""
    t0 = phase(f"28. train resume at examples/ota_llm_training.py's width "
               f"({RESUME_STEPS} steps straight against {RESUME_STEPS // 2} + "
               f"a checkpoint + {RESUME_STEPS // 2}), then {LOSS_STEPS} steps")
    launch, cfg, tcfg, shape = resume_setup()
    runs = [launch.train(cfg, tcfg, shape, steps=RESUME_STEPS,
                         device="cuda", verbose=False)[0] for _ in range(2)]
    plain_equal = state_equal(torch, *runs)
    del runs
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    try:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), RESUME_CHILD],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    finally:
        drop_scratch()
    check(proc.returncode == 0, f"train resume (child process) failed, "
          f"rc {proc.returncode}:\n{proc.stdout[-2000:]}\n"
          f"{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"resume bitwise under deterministic algorithms (child process); "
        f"two straight runs without them bitwise equal: {plain_equal}; "
        f"{LOSS_STEPS} steps: loss {res['loss_first10']:.4f} (first 10) -> "
        f"{res['loss_last10']:.4f} (last 10), {res['ms_per_step_host']:.1f} "
        f"ms a step (host clock, spans)")
    RECORD["train_resume"] = dict(
        res, straight_runs_bitwise_without_determinism=plain_equal)
    done("train resume", t0)
    return RECORD["train_resume"]


def resume_child():
    """Phase 28's deterministic part, run as its own process: prints one
    JSON line, exits 1 on a failed check."""
    import torch

    launch, cfg, tcfg, shape = resume_setup()
    kw = dict(device="cuda", verbose=False)
    torch.use_deterministic_algorithms(True)
    reset_counts()
    straight, _ = launch.train(
        cfg, tcfg, shape, steps=RESUME_STEPS,
        ckpt_dir=str(fresh_dir("ckpt_train_a")), log_every=1, **kw)
    check(read_counts()["ota_fused"] == RESUME_STEPS,
          "train resume: one K1 launch a step")
    ck = fresh_dir("ckpt_train_b")
    launch.train(cfg, tcfg, shape, steps=RESUME_STEPS // 2,
                 ckpt_dir=str(ck), **kw)
    resumed, _ = launch.train(cfg, tcfg, shape, steps=RESUME_STEPS,
                              ckpt_dir=str(ck), **kw)
    check(state_equal(torch, straight, resumed),
          "train resume: params, mu, nu or step not bitwise the straight "
          "run's")
    _, long_hist = launch.train(cfg, tcfg, shape, steps=LOSS_STEPS,
                                log_every=1, **kw)
    losses = [h["loss"] for h in long_hist]
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    check(last < first, f"{LOSS_STEPS} steps: mean loss of the last 10 "
          f"{last} not below the first 10's {first}")
    print(json.dumps({
        "resume_bitwise_deterministic": True,
        "loss_first10": first, "loss_last10": last,
        "ms_per_step_host": 1e3 * long_hist[-1]["wall_s"] / LOSS_STEPS,
        "history": long_hist}))
    return 0


# ---------------------------------------------------------------------------
# phases 29-30: streamed lanes, per-agent budgets as lanes, mode="sharded"
# ---------------------------------------------------------------------------

def streamed_specs(lanes, cfg, ota, runs, **kw):
    from repro_torch.core import fedpg

    return [lanes.LaneSpec(s, cfg.alpha, ota, **kw)
            for s in fedpg.run_seeds(0, runs)]


def lane_fold_row(torch, n_lanes, n_rows, n_params):
    """K1's lane fold alone, as a streamed round launches it: the ``(L, 1 +
    b, P)`` stack ``[acc; g_block]`` with gains ``[1; h_block]``, sigma 0,
    scale 1, no noise; bitwise its plain version; device time beside the
    byte bound, the plain version and ``torch.baddbmm`` (acc + h G)."""
    from repro_torch.kernels import ota_fused, ref

    gen = torch.Generator(device="cuda").manual_seed(n_lanes * n_rows)
    f32 = dict(device="cuda", dtype=torch.float32, generator=gen)
    g = torch.randn(n_lanes, n_rows, n_params, **f32)
    h = torch.rand(n_lanes, n_rows, **f32) + 0.1
    h[:, 0] = 1.0

    def call():
        return ota_fused.fused_aggregate_lanes(g, h, sigma=0.0, scale=1.0,
                                               with_noise=False)

    def plain():
        return ref.ota_fused_lanes_ref(g, h, None, sigma=[0.0] * n_lanes,
                                       scale=[1.0] * n_lanes)

    acc, hb, gb = g[:, :1], h[:, None, 1:], g[:, 1:]
    err = (call() - plain()).abs().max().item()
    check(err == 0.0, f"K1 lane fold {(n_lanes, n_rows, n_params)} is not "
                      f"bitwise its plain version: {err}")
    ms = device_ms(torch, call)
    plain_ms = device_ms(torch, plain, iters=10, warmup=2,
                         sleep_cycles=50_000_000)
    lib_ms = device_ms(torch, lambda: torch.baddbmm(acc, hb, gb))
    nbytes = n_lanes * (n_rows * n_params * 4 + n_rows * 4 + n_params * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_lanes * n_rows * n_params / FP32_FLOPS_PER_S * 1e3
    row = {"lanes": n_lanes, "A": n_rows, "P": n_params, "mode": "agg",
           "body": ota_fused.k1_body(n_rows, n_params, torch.float32,
                                     n_lanes, g.data_ptr()),
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_call": "torch.baddbmm(acc, h, G)",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": err}
    log(f"K1 lane fold {(n_lanes, n_rows, n_params)}, {row['body']} body: "
        f"{ms * 1e3:.2f} us; plain {plain_ms:.3f} ms; torch.baddbmm "
        f"{lib_ms * 1e3:.2f} us; {row['bound_by']} bound "
        f"{row['bound_ms'] * 1e3:.4f} us; bitwise")
    return row


def phase_streamed_lanes(torch):
    """The main cell (N=10 M=10 T=20 d=165) streamed in blocks of 4 as R =
    1, 5, 20 lanes of one batched run, K=20: ms per batched round against R
    x the one-run streamed round, in turns; 2 n_blocks + 1 K1 launches a
    batched round for every R; lanes 0 and R-1 bitwise ``fedpg.run
    (agent_blocks=4)``; the same under Bernoulli 0.5 with staleness (4,
    0.8) at R = 5 (3 n_blocks + 1); ``fig_large_n.py``'s N = 10^4 (M=1 T=3)
    in blocks of 1000 as 4 lanes against the stacked lanes (peak memory);
    K1's lane fold alone at (20, 5, 165) and (4, 1001, 165)."""
    from repro_torch.core import fedpg, lanes, ota as ota_lib
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.service.participation import ParticipationConfig
    from repro_torch.service.staleness import StalenessConfig

    t0 = phase(f"29. streamed lanes: the main cell in blocks of "
               f"{STREAMED_LANE_BLOCKS} as R = {STREAMED_LANE_RUNS} lanes "
               f"(K={STREAMED_LANE_ROUNDS})")
    env, pol = LandmarkNav(), MLPPolicy()
    cfg, ota = alg_config(10, 10, STREAMED_LANE_ROUNDS)
    blocks = STREAMED_LANE_BLOCKS
    n_blocks = ota_lib.blocked_layout(cfg.n_agents, blocks)[0]
    lanes.run_lanes(env, pol, dataclasses.replace(cfg, n_rounds=2),
                    streamed_specs(lanes, cfg, ota, 2), agent_blocks=blocks,
                    device="cuda")
    torch.cuda.synchronize()

    def batched(runs, k1):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        reset_counts()
        s.record()
        out = lanes.run_lanes(env, pol, cfg, streamed_specs(
            lanes, cfg, ota, runs), agent_blocks=blocks, device="cuda")
        e.record()
        torch.cuda.synchronize()
        k1.append(read_counts()["ota_fused"])
        return out, s.elapsed_time(e) / cfg.n_rounds

    one_ms, lane_ms, k1, outs = [], {r: [] for r in STREAMED_LANE_RUNS}, {
        r: [] for r in STREAMED_LANE_RUNS}, {}
    for _ in range(STREAMED_LANE_TURNS):
        one_ms.append(timed_run(torch, fedpg, env, pol, cfg, ota, 0,
                                agent_blocks=blocks)[2])
        for runs in STREAMED_LANE_RUNS:
            outs[runs], ms = batched(runs, k1[runs])
            lane_ms[runs].append(ms)
    one = statistics.median(one_ms)
    rows = []
    for runs in STREAMED_LANE_RUNS:
        expect = (2 * n_blocks + 1) * cfg.n_rounds
        check(all(x == expect for x in k1[runs]),
              f"R={runs}: K1 launches {k1[runs]}, expected {expect} "
              f"(2 x {n_blocks} blocks + 1 a round)")
        theta, hist = outs[runs]
        seeds = fedpg.run_seeds(0, runs)
        for i in sorted({0, runs - 1}):
            t1, h1 = fedpg.run(env, pol, cfg, seeds[i], ota=ota,
                               agent_blocks=blocks, device="cuda")
            check(history_bitwise(torch, h1, hist, i)
                  and all(torch.equal(t1[k], theta[k][i]) for k in t1),
                  f"R={runs}: lane {i} is not bitwise its fedpg.run")
        ms = statistics.median(lane_ms[runs])
        prof = profile_rounds(torch, lambda: lanes.run_lanes(
            env, pol, dataclasses.replace(cfg, n_rounds=3), streamed_specs(
                lanes, cfg, ota, runs), agent_blocks=blocks, device="cuda"),
            3, ms)
        row = {"runs": runs, "ms_per_batched_round": ms,
               "runs_x_one_run_ms": runs * one, "speedup": runs * one / ms,
               "turns_ms": lane_ms[runs],
               "k1_per_round": k1[runs][0] / cfg.n_rounds,
               "busy_share": prof["busy_share"],
               "device_launches_per_round":
                   prof["device_launches_per_round"],
               "k1_us_per_round": prof["k1_us_per_round"]}
        rows.append(row)
        log(f"R={runs:3d}: {ms:.3f} ms per batched streamed round against R "
            f"x {one:.3f} = {runs * one:.3f} ms ({row['speedup']:.2f}x); "
            f"{row['k1_per_round']:.0f} K1 launches a round; device busy "
            f"{prof['busy_share']:.2%}, "
            f"{prof['device_launches_per_round']:.0f} launches a round, K1 "
            f"{prof['k1_us_per_round']:.1f} us; lanes 0 and {runs - 1} "
            f"bitwise fedpg.run")
    # the service round streamed, as lanes
    part, stale = ParticipationConfig(rate=0.5), StalenessConfig(4, 0.8)
    runs = STREAMED_SERVICE_RUNS
    specs = streamed_specs(lanes, cfg, ota, runs, participation=part,
                           staleness=stale)
    reset_counts()
    theta, hist = lanes.run_lanes(env, pol, cfg, specs, agent_blocks=blocks,
                                  device="cuda")
    svc_k1 = read_counts()["ota_fused"]
    expect = (3 * n_blocks + 1) * cfg.n_rounds
    check(svc_k1 == expect, f"service R={runs}: {svc_k1} K1 launches, "
                            f"expected {expect} (3 folds a block + 1)")
    for i, spec in enumerate(specs):
        t1, h1 = fedpg.run(env, pol, cfg, spec.seed, ota=ota,
                           agent_blocks=blocks, participation=part,
                           staleness=stale, device="cuda")
        check(history_bitwise(torch, h1, hist, i)
              and all(torch.equal(t1[k], theta[k][i]) for k in t1),
              f"service lane {i} is not bitwise its fedpg.run")
    log(f"service (Bernoulli 0.5, staleness (4, 0.8)) R={runs}: every lane "
        f"bitwise its fedpg.run; {svc_k1 / cfg.n_rounds:.0f} K1 launches a "
        f"round")
    # fig_large_n.py's N = 10^4 as 4 lanes: streamed against stacked
    big = dataclasses.replace(alg_config(LARGE_LANE_N, 1, 1)[0], horizon=3)
    big_specs = streamed_specs(lanes, big, ota, LARGE_LANE_RUNS)
    large = {}
    for form, b in (("streamed", LARGE_LANE_BLOCKS), ("stacked", None)):
        lanes.run_lanes(env, pol, big, big_specs, agent_blocks=b,
                        device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        reset_counts()
        s.record()
        theta, hist = lanes.run_lanes(env, pol, big, big_specs,
                                      agent_blocks=b, device="cuda")
        e.record()
        torch.cuda.synchronize()
        launches = read_counts()["ota_fused"]
        expect = 1 if b is None else (
            2 * ota_lib.blocked_layout(LARGE_LANE_N, b)[0] + 1)
        check(launches == expect, f"N={LARGE_LANE_N} {form}: {launches} K1 "
                                  f"launches, expected {expect}")
        check(all(bool(torch.isfinite(x).all()) for x in hist),
              f"N={LARGE_LANE_N} {form}: not finite")
        large[form] = {"ms_per_round": s.elapsed_time(e),
                       "peak_mb": (torch.cuda.max_memory_allocated()
                                   - resident) / 1e6,
                       "k1_launches": launches}
    check(large["streamed"]["peak_mb"] < large["stacked"]["peak_mb"],
          f"N={LARGE_LANE_N} x {LARGE_LANE_RUNS} lanes: streamed peak "
          f"{large['streamed']['peak_mb']:.1f} MB not below stacked "
          f"{large['stacked']['peak_mb']:.1f} MB")
    log(f"N={LARGE_LANE_N} M=1 T=3 as {LARGE_LANE_RUNS} lanes: streamed in "
        f"{LARGE_LANE_BLOCKS}s {large['streamed']['ms_per_round']:.1f} ms, "
        f"peak {large['streamed']['peak_mb']:.1f} MB, "
        f"{large['streamed']['k1_launches']} K1 launches | stacked "
        f"{large['stacked']['ms_per_round']:.1f} ms, peak "
        f"{large['stacked']['peak_mb']:.1f} MB")
    folds = [lane_fold_row(torch, *shape) for shape in LANE_FOLD_SHAPES]
    RECORD["streamed_lanes"] = {
        "blocks": blocks, "n_blocks": n_blocks, "one_run_turns_ms": one_ms,
        "one_run_ms": one, "rounds": rows,
        "service": {"runs": runs, "k1_per_round": svc_k1 / cfg.n_rounds},
        "large": large, "lane_folds": folds}
    done("streamed lanes", t0)
    return rows, folds


def phase_sharded(torch):
    """A two-partition grid of the main cell, 4 runs, K=10: a streamed
    partition (blocks of 4, alpha 1e-3/2e-3/3e-3) and a stacked
    ``HeterogeneousBudget`` partition (p_max 1.5 and 3.0): ``mode="vmap"``
    bitwise ``"map"``, one launch a stacked round and 2 n_blocks + 1 a
    streamed one; ``mode="sharded"`` bitwise ``"vmap"`` on the default
    one-device mesh and on ``make_sweep_mesh(devices=[cuda:0] * 2)``, where
    the three streamed lanes split 2 + 2 with one pad lane masked."""
    import numpy as np

    from repro_torch.core import distribute, ota as ota_lib, sweep
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.power_control import HeterogeneousBudget
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.telemetry import trace

    t0 = phase(f"30. sweep modes: a streamed and a per-agent budget "
               f"partition, {SHARDED_RUNS} runs, K={SHARDED_ROUNDS}")
    cfg, ota = alg_config(10, 10, SHARDED_ROUNDS)
    size = dict(n_agents=10, batch_m=10, horizon=cfg.horizon,
                gamma=cfg.gamma, n_rounds=SHARDED_ROUNDS, debias=True,
                channel=RayleighChannel(), noise_sigma=ota.noise_sigma)
    scens = (sweep.grid(alpha=[1e-3, 2e-3, 3e-3],
                        agent_blocks=STREAMED_LANE_BLOCKS, **size)
             + sweep.grid(alpha=1e-3, power_control=[
                 HeterogeneousBudget(p_max=1.5),
                 HeterogeneousBudget(p_max=3.0)], **size))
    env, pol = LandmarkNav(), MLPPolicy()
    n_blocks = ota_lib.blocked_layout(10, STREAMED_LANE_BLOCKS)[0]
    res, k1s = {}, {}
    for name, kw in (("map", dict(mode="map", device="cuda")),
                     ("vmap", dict(device="cuda")),
                     ("sharded", dict(mode="sharded")),
                     ("sharded_x2", dict(mode="sharded", mesh=make_sweep_mesh(
                         devices=[torch.device("cuda", 0)] * 2)))):
        trace.reset()
        reset_counts()
        res[name] = sweep.sweep(env, pol, scens, 0, SHARDED_RUNS, **kw)
        k1s[name] = k1 = read_counts()["ota_fused"]
        spans = [sp.name for sp in trace.spans()]
        log(f"mode={name:10s}: {res[name].n_partitions} partitions on "
            f"{res[name].n_devices} device(s), K1 launches {k1}, spans "
            f"{sorted(set(spans))}, partition ms "
            + ", ".join(f"{p.wall_time_us / 1e3:.1f}"
                        for p in res[name].partitions))
    check(res["vmap"].n_partitions == 2, "two partitions expected")
    expect = (2 * n_blocks + 1 + 1) * SHARDED_ROUNDS
    check(k1s["vmap"] == expect,
          f"vmap: {k1s['vmap']} K1 launches, expected {expect}")
    cells = distribute.plan_placement(make_sweep_mesh(
        devices=[torch.device("cuda", 0)] * 2), 3, SHARDED_RUNS)
    check(cells.n_pad == 1, "the repeated-device mesh pads one lane")
    for a, b in (("map", "vmap"), ("vmap", "sharded"),
                 ("vmap", "sharded_x2")):
        check(all(np.array_equal(x, y)
                  for x, y in zip(res[a].history, res[b].history)),
              f"mode={b} is not bitwise mode={a}")
    log("vmap bitwise map; sharded bitwise vmap on the one-device mesh and "
        "on [cuda:0] x 2 (three streamed lanes padded to four, the pad lane "
        "masked)")
    RECORD["sharded"] = {name: {"k1": k1s[name], "n_devices": r.n_devices,
                                "partition_ms": [p.wall_time_us / 1e3
                                                 for p in r.partitions]}
                         for name, r in res.items()}
    done("sharded", t0)
    return k1s["vmap"]


MESH_ROUNDS, MESH_BLOCKS, MESH_TURNS, MESH_SEED = 20, 4, 2, 7
MESH_DRAW_ROUNDS = 3
MESH_LARGE_N, MESH_LARGE_ROUNDS, MESH_LARGE_BLOCKS = 10_001, 3, 32
PSUM_STEPS = 3


def mesh_forms(world):
    """Phase 31's forms of the main cell on ``world`` ranks: (name,
    ``fedpg.run`` kwargs).  The stacked form needs ranks that divide N=10
    (the JAX guard), so four ranks run only the streamed forms."""
    from repro_torch.service.participation import ParticipationConfig

    forms = [("stacked", {})] if 10 % world == 0 else []
    return forms + [("streamed", {"agent_blocks": MESH_BLOCKS}),
                    ("service", {"agent_blocks": MESH_BLOCKS,
                                 "participation": ParticipationConfig(
                                     kind="bernoulli", rate=0.5)})]


def mesh_k1_per_round(blocks):
    """K1 launches a round on a rank: the stacked mesh round's fold and
    tail; a streamed one two folds a block of its own, and the tail."""
    return 2 if blocks is None else 2 * len(blocks) + 1


def draw_checksums(torch, mesh, run):
    """Run ``run()`` with the round's draw functions wrapped, and return a
    float64 checksum of everything each round drew (initial states, policy
    and env noise, gains, kernel seeds, service masks)."""
    from unittest import mock

    from repro_torch.core import lanes

    sums = []

    def record(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            parts = out if isinstance(out, tuple) else (out,)
            sums.extend(x.double().sum() for x in parts
                        if isinstance(x, torch.Tensor))
            return out
        return wrapped

    with mock.patch.object(lanes, "_draw_rollouts",
                           record(lanes._draw_rollouts)), \
            mock.patch.object(lanes, "_uplink_draws",
                              record(lanes._uplink_draws)), \
            mock.patch.object(lanes, "_round_mask", record(lanes._round_mask)):
        run()
    return torch.stack(sums)


def mesh_rank(mesh, with_train):
    """Phase 31 on one rank of the agent mesh (``launch.mesh.run_local``):
    the main cell's forms in turns with their runs off the mesh, their K1
    launches and collectives, the draws' checksums gathered over the group,
    the N = 10,001 cell, and (``with_train``) the psum train step."""
    import torch

    from repro_torch.core import fedpg, lanes
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    env, pol = LandmarkNav(), MLPPolicy()
    cfg, ota = alg_config(10, 10, MESH_ROUNDS)
    out = {"rank": mesh.rank, "size": mesh.size, "device": str(dev),
           "forms": {}}

    def run(c, on_mesh, **kw):
        return fedpg.run(env, pol, c, MESH_SEED, ota=ota, device=dev,
                         agent_mesh=mesh if on_mesh else None, **kw)

    for name, kw in mesh_forms(mesh.size):
        _, span, blocks = lanes.rank_layout(cfg.n_agents,
                                            kw.get("agent_blocks"), mesh)
        short = dataclasses.replace(cfg, n_rounds=2)
        run(short, True, **kw)
        run(short, False, **kw)                              # warm-up
        row = {"ms": {"mesh": [], "plain": []}}
        for _ in range(MESH_TURNS):
            for which in ("mesh", "plain"):
                reset_counts()
                mesh_lib.ALL_REDUCES = mesh_lib.ALL_GATHERS = 0
                torch.cuda.synchronize(dev)
                t = time.perf_counter()
                res = run(cfg, which == "mesh", **kw)
                torch.cuda.synchronize(dev)
                row["ms"][which].append(
                    (time.perf_counter() - t) * 1e3 / MESH_ROUNDS)
                row[which] = res
                row[f"k1_{which}"] = read_counts()["ota_fused"]
                row[f"collectives_{which}"] = (mesh_lib.ALL_REDUCES,
                                               mesh_lib.ALL_GATHERS)
        row["k1_expect"] = mesh_k1_per_round(blocks) * MESH_ROUNDS
        row["local_agents"] = span
        short = dataclasses.replace(cfg, n_rounds=MESH_DRAW_ROUNDS)
        sums = draw_checksums(torch, mesh, lambda: run(short, True, **kw))
        row["draws"] = mesh.all_gather(sums.unsqueeze(0), 0)
        out["forms"][name] = row

    # fig_large_n.py's sharded cell: N = 10,001 (a short last rank)
    big = dataclasses.replace(alg_config(MESH_LARGE_N, 1, MESH_LARGE_ROUNDS)[0],
                              horizon=3)
    row = {"mesh": {"ms": []}, "plain": {"ms": []}}
    for _ in range(MESH_TURNS):
        for which in ("mesh", "plain"):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)
            reset_counts()
            t = time.perf_counter()
            res = run(big, which == "mesh", agent_blocks=MESH_LARGE_BLOCKS)
            torch.cuda.synchronize(dev)
            row[which]["ms"].append(
                (time.perf_counter() - t) * 1e3 / MESH_LARGE_ROUNDS)
            row[which].update(
                peak_mb=(torch.cuda.max_memory_allocated(dev) - resident)
                / 1e6, k1=read_counts()["ota_fused"], result=res)
    _, row["span"], blocks = lanes.rank_layout(big.n_agents,
                                               MESH_LARGE_BLOCKS, mesh)
    row["k1_expect"] = mesh_k1_per_round(blocks) * MESH_LARGE_ROUNDS
    out["large"] = row
    if with_train:
        out["train"] = psum_train(torch, mesh)
    return out


def psum_train(torch, mesh, arch="llama3.2-3b", n_steps=PSUM_STEPS):
    """``arch`` at full width, bf16, OTA with the bf16 wire: ``n_steps``
    psum steps on this one-rank mesh in turns with the plain OTA step over
    one agent, on the same state: ms a step, peak memory, K1 launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import model as model_lib
    from repro_torch.train import trainer

    cfg = get_config(arch)
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    model = model_lib.build(cfg)
    tcfg = trainer.TrainConfig(aggregator="ota", channel="rayleigh",
                               noise_db=-60.0, debias=True, n_agents=1,
                               total_steps=2 * n_steps, lr=1e-4, warmup=2,
                               wire_dtype="bfloat16")
    state = trainer.init_state(model, tcfg, device=dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH), dev)
    steps = {"psum": trainer.make_psum_train_step(model, tcfg, mesh),
             "plain": trainer.make_train_step(model, tcfg)}
    rows = {"psum": [], "plain": []}
    for i in range(n_steps):
        for name in ("psum", "plain"):
            batch = data.batch(i)
            torch.cuda.synchronize(dev)
            reset_counts()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            state, m = steps[name](state, batch)
            e.record()
            torch.cuda.synchronize(dev)
            rows[name].append({"ms": s.elapsed_time(e),
                               "k1": read_counts()["ota_fused"],
                               "bodies": k1_body_counts(),
                               "metrics": {k: v.item() for k, v in m.items()}})
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    d = sum(v.numel() for v in state.opt_state.mu.values())
    del state, steps
    torch.cuda.empty_cache()
    return {"rows": rows, "peak_gb": peak, "d": d}


def phase_agent_mesh(torch):
    """Phase 31: the agent mesh through ``launch.mesh.run_local`` (nccl) at
    world size 1, and over every visible card when there are several: the
    main cell (N=10 M=10 T=20, Rayleigh, -60 dB, debias, K=20) stacked,
    streamed in 4s and under Bernoulli 0.5 streamed in 4s, each in turns
    with its run off the mesh (bitwise it at world size 1); K1 launches and
    collectives a round asserted; every rank bitwise the same theta,
    history and draws; ``fig_large_n.py``'s N = 10,001 cell (M=1 T=3,
    blocks of 32, K=3): ms a round and peak MB per rank; and at world size
    1 the psum train step of llama3.2-3b at full width (B=8 S=256, 3
    steps, 2 K1 launches at (1, d) a step)."""
    from repro_torch.launch import mesh as mesh_lib

    t0 = phase("31. agent mesh: the main cell, N = 10,001 and the psum "
               "train step over torch.distributed ranks (nccl)")
    torch.cuda.empty_cache()
    worlds = [1] + ([torch.cuda.device_count()]
                    if torch.cuda.device_count() > 1 else [])
    rec = {}
    for w in worlds:
        t_w = time.perf_counter()
        ranks = mesh_lib.run_local(mesh_rank, w, w == 1, device="cuda",
                                   timeout=900)
        rec[w] = check_mesh_world(torch, w, ranks)
        rec[w]["seconds"] = time.perf_counter() - t_w
        log(f"world size {w}: {rec[w]['seconds']:.1f} s")
    RECORD["agent_mesh"] = {str(w): {k: v for k, v in r.items()
                                     if k != "ranks"} for w, r in rec.items()}
    done("agent mesh", t0)
    return rec[1]


def check_mesh_world(torch, w, ranks):
    """Phase 31's checks on one world size's rank results, and its log."""
    out = {"forms": {}}
    r0 = ranks[0]
    check([r["rank"] for r in ranks] == list(range(w))
          and all(r["device"] == f"cuda:{r['rank']}" for r in ranks),
          f"world {w}: ranks {[(r['rank'], r['device']) for r in ranks]}")
    for name, _ in mesh_forms(w):
        row0 = r0["forms"][name]
        for r in ranks:
            row = r["forms"][name]
            check(row["k1_mesh"] == row["k1_expect"],
                  f"world {w} {name} rank {r['rank']}: {row['k1_mesh']} K1 "
                  f"launches on the mesh, expected {row['k1_expect']}")
            check(row["collectives_mesh"] == (MESH_ROUNDS, MESH_ROUNDS),
                  f"world {w} {name} rank {r['rank']}: collectives "
                  f"{row['collectives_mesh']}, expected one all_reduce and "
                  f"one all_gather a round")
            check(row["collectives_plain"] == (0, 0),
                  f"{name}: the run off the mesh issued collectives")
            check(theta_hist_equal(torch, row["mesh"], row0["mesh"]),
                  f"world {w} {name}: rank {r['rank']} is not bitwise rank 0")
            draws = row["draws"]
            check(bool((draws == draws[0:1]).all()),
                  f"world {w} {name}: the ranks drew different draws")
        plain = row0["plain"]
        check(torch.equal(row0["mesh"][1].gain_mean, plain[1].gain_mean),
              f"world {w} {name}: gain_mean is not the run's off the mesh")
        if w == 1:
            check(theta_hist_equal(torch, row0["mesh"], plain),
                  f"{name}: the one-rank mesh run is not bitwise the run "
                  f"off the mesh")
        dev_max = max_rel_dev(torch, row0["mesh"], plain)
        ms_mesh = statistics.median(row0["ms"]["mesh"])
        ms_plain = statistics.median(row0["ms"]["plain"])
        out["forms"][name] = {
            "ms_per_round_mesh": row0["ms"]["mesh"],
            "ms_per_round_plain": row0["ms"]["plain"],
            "k1_per_round_mesh": [r["forms"][name]["k1_mesh"] / MESH_ROUNDS
                                  for r in ranks],
            "k1_per_round_plain": row0["k1_plain"] / MESH_ROUNDS,
            "local_agents": [r["forms"][name]["local_agents"] for r in ranks],
            "max_rel_dev_from_plain": dev_max}
        log(f"world {w} {name:8s}: mesh {ms_mesh:.3f} ms a round against "
            f"{ms_plain:.3f} off the mesh, in turns ({row0['ms']}); K1 "
            f"{out['forms'][name]['k1_per_round_mesh']} a round per rank "
            f"(off the mesh {row0['k1_plain'] / MESH_ROUNDS:g}); one "
            f"all_reduce + one all_gather a round; ranks bitwise, draws "
            f"equal; max relative deviation from the run off the mesh "
            f"{dev_max:.3g}" + (" (bitwise)" if w == 1 else ""))
    large = []
    for r in ranks:
        row = r["large"]
        hist = row["mesh"]["result"][1]
        check(all(bool(torch.isfinite(x).all()) for x in hist),
              f"world {w} N={MESH_LARGE_N}: not finite")
        check(theta_hist_equal(torch, row["mesh"]["result"],
                               r0["large"]["mesh"]["result"]),
              f"world {w} N={MESH_LARGE_N}: rank {r['rank']} differs")
        check(row["mesh"]["k1"] == row["k1_expect"],
              f"world {w} N={MESH_LARGE_N} rank {r['rank']}: "
              f"{row['mesh']['k1']} K1 launches, expected {row['k1_expect']}")
        large.append({"rank": r["rank"], "span": row["span"],
                      **{k: {kk: vv for kk, vv in v.items() if kk != "result"}
                         for k, v in row.items() if k in ("mesh", "plain")}})
        log(f"world {w} N={MESH_LARGE_N} rank {r['rank']} agents "
            f"{row['span']}: mesh {fmt_ms(row['mesh']['ms'])} ms a round, "
            f"peak {row['mesh']['peak_mb']:.1f} MB, K1 {row['mesh']['k1']} | "
            f"off the mesh {fmt_ms(row['plain']['ms'])} ms, "
            f"{row['plain']['peak_mb']:.1f} MB (in turns)")
    if w == 1:
        check(theta_hist_equal(torch, r0["large"]["mesh"]["result"],
                               r0["large"]["plain"]["result"]),
              f"N={MESH_LARGE_N}: the one-rank mesh run is not bitwise")
    out["large"] = large
    if "train" in r0:
        tr = r0["train"]
        for row in tr["rows"]["psum"]:
            check(row["k1"] == 2 and row["bodies"]["wide"] == 2,
                  f"psum step: {row['k1']} K1 launches ({row['bodies']}), "
                  f"expected 2 wide launches at (1, d)")
        for name in ("psum", "plain"):
            for row in tr["rows"][name]:
                check(all(math_isfinite(v) for v in row["metrics"].values()),
                      f"{name} step: metrics not finite: {row['metrics']}")
        ms = {k: [row["ms"] for row in v] for k, v in tr["rows"].items()}
        out["train"] = {"d": tr["d"], "peak_gb": tr["peak_gb"], "ms": ms,
                        "k1_per_step": tr["rows"]["psum"][-1]["k1"],
                        "loss": {k: [row["metrics"]["loss"] for row in v]
                                 for k, v in tr["rows"].items()}}
        log(f"psum train step, llama3.2-3b (d = {tr['d']}), B={TRAIN_BATCH} "
            f"S={TRAIN_SEQ}, one rank: ms {[round(x, 1) for x in ms['psum']]}"
            f" against the plain step's {[round(x, 1) for x in ms['plain']]}"
            f" in turns; 2 K1 launches at (1, d) a step; peak "
            f"{tr['peak_gb']:.2f} GB; loss "
            f"{[round(x, 4) for x in out['train']['loss']['psum']]}")
    return out


# ---------------------------------------------------------------------------
# phases 32-34: the moe family served and trained, SSM training
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-1b-a400m"
GRANITE_SERVE_STEPS = 16
GRANITE_PREFILL_K3 = 24        # one wgmma launch a layer
FAMILY_TRAIN_STEPS = 4
FAMILY_PSUM_STEPS = 2           # in turns with the plain step; the first warms up


def phase_granite_serve(torch):
    """Phase 32: granite-moe-1b-a400m at its published width (24 layers,
    d_model 1024, 32 experts top-8, vocab 49155, bf16, random weights):
    prefill B=4 S=2048 through K3 (24 wgmma launches), 16 decode steps,
    the float32 prefill (PR 12's K3) against the plain attention's within
    2e-2 of the max abs logit, the bf16 one beside its noise floor; then
    phase 13's profile of one prefill and 4 decode steps."""
    t0 = phase(f"32. serve {GRANITE} (bf16, full width) and profile it")
    served = serve(torch, GRANITE, "flash_attention_wgmma", "flash_attention",
                   GRANITE_PREFILL_K3, steps=GRANITE_SERVE_STEPS,
                   seeds=FLOOR_SEEDS[:1])
    res = served[0]
    res["profile"] = logged_serve_profile(torch, GRANITE, served,
                                          "flash_fwd_wgmma_kernel")
    del served
    torch.cuda.empty_cache()
    RECORD["serve"][GRANITE] = res
    done("granite serve", t0)
    return res


def grad_refusals(torch):
    """K3's and K4's wrappers on CUDA tensors that require grad, under grad
    mode: each raises (the kernels have no backward) and launches
    nothing."""
    from repro_torch.kernels import flash_attention, ops

    gen = torch.Generator(device="cuda").manual_seed(11)
    kw = dict(device="cuda", generator=gen)
    x = torch.randn(1, 64, 2, 32, **kw).requires_grad_()
    dt = torch.rand(1, 64, 2, **kw) * 0.1
    A = -torch.rand(2, **kw) - 0.5
    B, C = (torch.randn(1, 64, 1, 16, **kw) for _ in range(2))
    q = torch.randn(1, 64, 4, 64, **kw).to(torch.bfloat16).requires_grad_()
    k, v = (torch.randn(1, 64, 2, 64, **kw).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.arange(64, dtype=torch.int32, device="cuda")
    calls = {"ops.ssd (K4)": lambda: ops.ssd(x, dt, A, B, C, chunk=32),
             "attend_bshd (K3)": lambda: flash_attention.attend_bshd(
                 q, k, v, q_pos=pos, k_pos=pos)}
    out = {}
    for name, call in calls.items():
        reset_counts()
        try:
            call()
            msg = None
        except RuntimeError as e:
            msg = str(e)
        torch.cuda.synchronize()
        check(msg is not None and "no backward" in msg
              and not any(read_counts()[c] for c in K34),
              f"{name} on a CUDA tensor that requires grad did not refuse: "
              f"{msg}")
        out[name] = msg
        log(f"{name} with an operand that requires grad: raises "
            f"RuntimeError, no launch")
    return out


def phase_family_train(torch, arch, number, n_layers=None):
    """Phases 33-34 and 36: ``arch`` at full width (``n_layers`` layers
    where given: the published width, the depth cut to fit one card), bf16,
    OTA (Rayleigh, -60 dB, debias, bf16 wire), 4 agents, B=8 S=256, the
    vlm and encdec families with the memory stub, ``FAMILY_TRAIN_STEPS``
    steps: one wide K1 launch a step at (1, d), no K3/K4 launch, finite
    metrics, ms a step, peak memory, K1's share of a profiled step; then K1
    at (1, d) bitwise on two windows and timed beside ``torch.mv``.
    granite adds one psum step at one rank (2 K1 launches); mamba2 adds
    the refusal of K3/K4 on tensors that require grad."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    from repro_torch.train import trainer
    from repro_torch.utils.tree import flatten_paths

    cfg = get_config(arch)
    width = "full width"
    if n_layers is not None:
        width = (f"its published width, depth cut from {cfg.n_layers} to "
                 f"{n_layers} layers")
        cfg = cfg.with_(n_layers=n_layers)
    t0 = phase(f"{number}. train {arch} at {width} ({cfg.n_layers} layers, "
               f"d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}), OTA "
               f"through K1, B={TRAIN_BATCH} S={TRAIN_SEQ}, "
               f"{TRAIN_AGENTS} agents")
    gc.collect()     # the peak below is this phase's, whatever the collector
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = model_lib.build(cfg)
    tcfg = train_config("ota", FAMILY_TRAIN_STEPS + 1, lr=1e-4, warmup=2,
                        wire_dtype="bfloat16")
    state = trainer.init_state(model, tcfg, device="cuda")
    d = sum(v.numel() for v in flatten_paths(state.params).values())
    log(f"d = {d} parameters ({d / 2 ** 31:.3f} x 2^31); wire bf16")
    step = trainer.make_train_step(model, tcfg)
    shape = InputShape("train", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                       kind="train")
    batches = [make_batch(cfg, shape, i, device="cuda")
               for i in range(FAMILY_TRAIN_STEPS)]
    if model_lib.needs_memory(cfg):
        log(f"memory stub {tuple(batches[0]['memory'].shape)}")
    state, res = timed_train_steps(torch, step, state, batches, arch)
    check(res["k1_launches"] == res["k1_bodies"]["wide"]
          == FAMILY_TRAIN_STEPS,
          f"{arch}: {res['k1_launches']} K1 launches ({res['k1_bodies']}), "
          f"expected one wide launch a step")
    del state, step, batches
    torch.cuda.empty_cache()
    res["d"] = d
    res["n_layers"] = cfg.n_layers
    res["k1_row"] = k1_unit_row(torch, d, ("bf16",),
                                [(0, K1_WINDOW), (d - K1_WINDOW, d)])
    if cfg.family == "moe":
        ranks = mesh_lib.run_local(psum_rank, 1, arch, FAMILY_PSUM_STEPS,
                                   device="cuda", timeout=600)
        psum = ranks[0]
        for row in psum["rows"]["psum"]:
            check(row["k1"] == row["bodies"]["wide"] == 2
                  and all(math_isfinite(v) for v in row["metrics"].values()),
                  f"{arch} psum step: {row}")
        log(f"{arch} psum step at one rank: ms "
            f"{[round(r['ms'], 1) for r in psum['rows']['psum']]} against "
            f"the plain step's "
            f"{[round(r['ms'], 1) for r in psum['rows']['plain']]} in "
            f"turns; 2 K1 launches a step; peak {psum['peak_gb']:.2f} GB")
        res["psum"] = psum
    if cfg.family == "ssm":
        res["grad_refusals"] = grad_refusals(torch)
    res.pop("k1_bodies")
    RECORD.setdefault("family_train", {})[arch] = res
    done(f"train {arch}", t0)
    return res


# ---------------------------------------------------------------------------
# phases 35-36: the hybrid, vlm and encdec families served and trained
# ---------------------------------------------------------------------------

ZAMBA = "zamba2-7b"
VISION = "llama-3.2-vision-11b"
SEAMLESS = "seamless-m4t-large-v2"
FAMILY_SERVE_STEPS = 4         # decode is host-bound (10-18 % busy): 4 show it
FAMILY_SERVE = [  # (arch, bf16 prefill kernel, its launches, of them
    #                bidirectional (seamless's encoder: one a layer), its
    #                kernel's profiler name, float32 kernel, float32 depth,
    #                its launches)
    (ZAMBA, "ssd_scan_tc", 81, 0, "ssd_scan_tc_kernel", "ssd_scan", 13, 13),
    (VISION, "flash_attention_wgmma", 40, 0, "flash_fwd_wgmma_kernel",
     "flash_attention", 10, 10),
    (SEAMLESS, "flash_attention_wgmma", 48, 24, "flash_fwd_wgmma_kernel",
     "flash_attention", None, 48),
]
# phase 36's depth cuts at the published widths (PERF.md section 4): zamba2
# two groups of 6 mamba layers, the shared block twice and a tail of 1;
# vision two groups of 4 dense layers and a cross layer; seamless whole
FAMILY_TRAIN_DEPTH = {ZAMBA: 13, VISION: 10, SEAMLESS: None}


def phase_family_serve(torch):
    """Phase 35: zamba2-7b, llama-3.2-vision-11b and seamless-m4t-large-v2
    at their published widths (bf16, random weights), each as phase 32:
    prefill B=4 S=2048 (zamba2: 81 tensor-core K4 launches, no K3, the
    shared attention through ``attend``; vision: 40 wgmma K3 launches, the
    patch memory (4, 1601, 4096) through ``attend``; seamless: 48, 24 of
    them the encoder's bidirectional ones over (4, 512, 1024) frames, each
    count read from the one timed prefill), ``FAMILY_SERVE_STEPS`` greedy
    decode steps, peak memory, the float32 prefill (PR 12's kernels; zamba2
    at 13 layers and vision at 10 beside the bf16 weights) against the
    plain attention and scan's within 2e-2 of the max abs logit, the bf16
    one beside its noise floor; then phase 13's profile of one prefill and
    4 decode steps."""
    t0 = phase(f"35. serve {ZAMBA}, {VISION} and {SEAMLESS} (bf16, full "
               f"width) and profile them")
    out = {}
    for (arch, kernel, n, n_bidir, prof_name, kernel32, depth32,
         n32) in FAMILY_SERVE:
        log(f"-- {arch}")
        t_arch = time.perf_counter()
        served = serve(torch, arch, kernel, kernel32, n,
                       steps=FAMILY_SERVE_STEPS, seeds=FLOOR_SEEDS[:1],
                       depth32=depth32, n_launches32=n32, n_bidir=n_bidir)
        res = served[0]
        t_prof = time.perf_counter()
        res["profile"] = logged_serve_profile(torch, arch, served, prof_name)
        del served
        torch.cuda.empty_cache()
        res["seconds"] = {"serve": t_prof - t_arch,
                          "profile": time.perf_counter() - t_prof}
        log(f"{arch}: serve and checks {res['seconds']['serve']:.1f} s, "
            f"profile {res['seconds']['profile']:.1f} s")
        out[arch] = res
    RECORD["serve"].update(out)
    done("hybrid, vlm and encdec serve", t0)
    return out


# ---------------------------------------------------------------------------
# phases 37-39: Fig. 3, Figs. 4-5 and the Theorem 1/2 table held to the
# JAX package's runs on a CPU (perf/figures_reference.py)
# ---------------------------------------------------------------------------

FIG_RUNS = 20                  # the reference's runs a scenario
FIG3_SEED, FIG45_SEED, THEORY_SEED = 1, 2, 1   # the benchmarks' seeds
FIG3_ROUNDS, FIG3_AGENTS, FIG3_BATCH = 250, 10, 10
FIG45_ROUNDS, FIG45_AGENTS = 250, 10
FLOOR_DRAWS = 400              # the reference's draws a (channel, M)
FLOOR_CLAIM_DRAWS = 4000       # the port's; Fig. 5's claim is judged on all
NAKAGAMI_GAIN_DRAWS = 10 ** 6
THEORY_ROUNDS = 150


def check_setting(ref, name, **want):
    got = {k: ref["setting"][k] for k in want}
    check(got == want, f"perf/{name} holds another setting: {got}, the "
                       f"port declares {want}")


def phase_fig3(torch):
    """Fig. 3 (``benchmarks/fig3_vs_vanilla.py``): the over-the-air uplink
    against the exact one, 20 lanes each, held to ``perf/fig3_reference.
    json``."""
    from repro_torch import figures
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    ref = reference("fig3_reference.json")
    check_setting(ref, "fig3_reference.json", n_rounds=FIG3_ROUNDS,
                  n_agents=FIG3_AGENTS, batch_m=FIG3_BATCH, alpha=FIG12_ALPHA,
                  runs=FIG_RUNS, seed=FIG3_SEED)
    want = {r["tag"]: r for r in ref["rows"]}
    t0 = phase(f"37. Fig. 3: OTA against the exact uplink (N={FIG3_AGENTS} "
               f"M={FIG3_BATCH} K={FIG3_ROUNDS}, {FIG_RUNS} lanes each)")
    env, pol = LandmarkNav(), MLPPolicy()
    rows, rewards = [], {}
    for s in figures.fig3_scenarios(FIG3_ROUNDS, FIG3_AGENTS, FIG3_BATCH,
                                    FIG12_ALPHA):
        expect = FIG3_ROUNDS if s.channel is not None else 0
        res, per_g, per_r, launches, ms = sweep_partition(
            torch, env, pol, s, FIG3_SEED, FIG_RUNS, expect, s.tag)
        rewards[s.tag] = res.history.rewards[0]
        w = want[s.tag]
        rows.append({
            "tag": s.tag, "k1_launches": launches, "ms_per_round": ms,
            "seconds": res.partitions[0].wall_time_us / 1e6,
            "avg_grad_sq": hold_row(per_g, w["per_run_avg_grad_sq"],
                                    f"{s.tag} avg_grad_sq"),
            "final_reward": hold_row(per_r, w["per_run_final_reward"],
                                     f"{s.tag} final reward")})
        log(f"{s.tag}: {launches} K1 launches, {ms:.3f} ms per batched "
            f"round")
    it_ota, it_van = figures.iters_to_90pct(rewards["ota"],
                                            rewards["vanilla"], FIG3_ROUNDS)
    same = figures.same_order(it_ota, it_van)
    ref_it = ref["iters_to_90pct"]
    log(f"iters_to_90pct: ota {it_ota}, vanilla {it_van} (reference "
        f"{ref_it['ota']}, {ref_it['vanilla']}); same order: {same}")
    check(same, f"Fig. 3: OTA took {it_ota} rounds to 90 %, more than twice "
                f"the exact uplink's {it_van}")
    RECORD["fig3"] = {"rows": rows, "iters_to_90pct": {
        "ota": it_ota, "vanilla": it_van, "reference": ref_it},
        "same_order": same}
    done("fig3", t0)
    return rows


def nakagami_gains(torch):
    """The card's Nakagami(0.1, 1) power gains, through the one-run sampler
    and the lane sampler (20 lanes): mean against Omega and variance against
    Omega^2 / m, each within 5 standard errors (the variance's from the
    sample's fourth central moment)."""
    from repro_torch.core.channel import NakagamiChannel, sample_lanes
    from repro_torch.utils.device import make_generator

    ch = NakagamiChannel(m=0.1, omega=1.0)
    n = NAKAGAMI_GAIN_DRAWS
    out = {}
    for name, x in (
            ("one run", ch.sample(make_generator(5, "cuda"), (n,), "cuda")),
            (f"{FIG_RUNS} lanes", sample_lanes(
                ch, [make_generator(100 + i, "cuda") for i in range(FIG_RUNS)],
                (n // FIG_RUNS,), "cuda"))):
        x = x.double().reshape(-1)
        mean, var = x.mean().item(), x.var().item()
        m4 = torch.mean((x - x.mean()) ** 4).item()
        z_mean = (mean - ch.mean) / (ch.var / x.numel()) ** 0.5
        z_var = (var - ch.var) / ((m4 - var ** 2) / x.numel()) ** 0.5
        log(f"Nakagami(0.1, 1) gains, {name}, {x.numel()} draws: mean "
            f"{mean:.5f} (Omega 1, z {z_mean:+.2f}), variance {var:.4f} "
            f"(Omega^2/m 10, z {z_var:+.2f})")
        check(abs(z_mean) < 5 and abs(z_var) < 5,
              f"Nakagami gains ({name}) off their moments")
        out[name] = {"draws": x.numel(), "mean": mean, "var": var,
                     "z_mean": z_mean, "z_var": z_var}
    return out


def phase_fig45(torch):
    """Figs. 4-5 (``benchmarks/fig45_nakagami.py``): the four (channel, M)
    partitions and the Lemma-3 aggregation-error floor at the reference's
    policy, held to ``perf/fig45_reference.json``."""
    from repro_torch import figures
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    ref = reference("fig45_reference.json")
    check_setting(ref, "fig45_reference.json", n_rounds=FIG45_ROUNDS,
                  n_agents=FIG45_AGENTS, alpha=FIG12_ALPHA, runs=FIG_RUNS,
                  seed=FIG45_SEED, n_draws=FLOOR_DRAWS)
    want = {r["tag"]: r for r in ref["rows"]}
    t0 = phase(f"38. Figs. 4-5: Nakagami(0.1, 1) against Rayleigh at M = 1 "
               f"and 10 (N={FIG45_AGENTS} K={FIG45_ROUNDS}, {FIG_RUNS} "
               f"lanes each), the Lemma-3 floor ({FLOOR_DRAWS} draws)")
    env, pol = LandmarkNav(), MLPPolicy()
    rows, final = [], {}
    for s in figures.fig45_scenarios(FIG45_ROUNDS, FIG45_AGENTS,
                                     FIG12_ALPHA):
        res, per_g, per_r, launches, ms = sweep_partition(
            torch, env, pol, s, FIG45_SEED, FIG_RUNS, FIG45_ROUNDS, s.tag)
        w = want[s.tag]
        final[(s.tag.rsplit("_M", 1)[0], s.batch_m)] = res.final_reward(0)
        rows.append({
            "tag": s.tag, "k1_launches": launches, "ms_per_round": ms,
            "seconds": res.partitions[0].wall_time_us / 1e6,
            "avg_grad_sq": hold_row(per_g, w["per_run_avg_grad_sq"],
                                    f"{s.tag} avg_grad_sq"),
            "final_reward": hold_row(per_r, w["per_run_final_reward"],
                                     f"{s.tag} final reward")})
        log(f"{s.tag}: {launches} K1 launches, {ms:.3f} ms per batched "
            f"round")
    nak_worse = figures.fig4_claim(final)
    log(f"Fig. 4: Nakagami M=10 final reward {final[('nakagami', 10)]:.4f} "
        f"against Rayleigh's {final[('rayleigh', 10)]:.4f}: nak_worse "
        f"{nak_worse} (reference {ref['fig4_nak_worse']})")
    check(nak_worse, "Fig. 4's claim failed: Nakagami beat Rayleigh at M=10")

    # the floor's first FLOOR_DRAWS draws are held to the reference's; Fig.
    # 5's claim is a ratio of heavy-tailed means, which the reference's own
    # draws, resampled, fail at 400 draws 8.6 % of the time and at 4000
    # never (PERF.md section 6): it is judged on all FLOOR_CLAIM_DRAWS
    t1 = time.perf_counter()
    reset_counts()
    floor = figures.aggregation_error_floor(
        ref["theta"], FIG45_AGENTS, FLOOR_CLAIM_DRAWS, device="cuda")
    launches = read_counts()["ota_fused"]
    floor_s = time.perf_counter() - t1
    check(launches == len(floor) * FLOOR_CLAIM_DRAWS,
          f"the floor launched K1 {launches} times, expected one a draw, "
          f"{len(floor) * FLOOR_CLAIM_DRAWS}")
    ref_floor = {(r["channel"], r["batch_m"]): r for r in ref["floor"]}
    floor_rows, held_means = {}, {}
    for key, v in floor.items():
        first = v.per_draw[:FLOOR_DRAWS]
        held_means[key] = float(first.mean())
        floor_rows[f"{key[0]}_M{key[1]}"] = dict(
            hold_row(first, ref_floor[key]["per_draw"],
                     f"floor {key[0]} M={key[1]}, {FLOOR_DRAWS} draws"),
            floor=held_means[key], floor_all=v.mean, floor_all_se=v.se,
            ref_floor=ref_floor[key]["floor"],
            ref_floor_se=ref_floor[key]["floor_se"])
        log(f"floor {key[0]} M={key[1]}: {held_means[key]:.2f} over "
            f"{FLOOR_DRAWS} draws (reference {ref_floor[key]['floor']:.2f} "
            f"+- {ref_floor[key]['floor_se']:.2f}); {v.mean:.2f} +- "
            f"{v.se:.2f} over {FLOOR_CLAIM_DRAWS}")
    means = {k: v.mean for k, v in floor.items()}
    p1, p10 = figures.fig5_penalties(means)
    fig5 = figures.fig5_claim(means)
    q1, q10 = figures.fig5_penalties(held_means)
    log(f"floor: {launches} K1 launches in {floor_s:.1f} s; Fig. 5 penalty "
        f"Nakagami over Rayleigh over {FLOOR_CLAIM_DRAWS} draws M=1 "
        f"{p1:.2f}, M=10 {p10:.2f}: {fig5} (over the first {FLOOR_DRAWS}: "
        f"{q1:.2f}, {q10:.2f}, {figures.fig5_claim(held_means)}; reference "
        f"{ref['fig5_penalty_m1']:.2f}, {ref['fig5_penalty_m10']:.2f})")
    check(fig5, "Fig. 5's claim failed: M bought back the channel penalty")
    gains = nakagami_gains(torch)
    RECORD["fig45"] = {"rows": rows, "final_reward": {
        f"{k[0]}_M{k[1]}": v for k, v in final.items()},
        "fig4_nak_worse": nak_worse, "floor": floor_rows,
        "floor_k1_launches": launches, "floor_seconds": floor_s,
        "fig5_penalty": [p1, p10], "fig5_penalty_first": [q1, q10],
        "fig5": fig5, "nakagami_gains": gains}
    done("fig45", t0)
    return rows, launches


def phase_theory(torch):
    """The Theorem 1/2 table (``benchmarks/theory_table.py``) on the
    reference's tabular MDP: three 20-lane partitions, the bounds against
    the reference's (closed form, rtol 1e-6), each ``avg_grad_sq`` held to
    the reference's and below its bound where the reference's is."""
    import math

    from repro_torch import figures
    from repro_torch.rl.policy import TabularSoftmaxPolicy

    ref = reference("theory_reference.json")
    st = ref["setting"]
    check_setting(ref, "theory_reference.json", n_rounds=THEORY_ROUNDS,
                  runs=FIG_RUNS, seed=THEORY_SEED,
                  n_agents=figures.THEORY_AGENTS,
                  batch_m=figures.THEORY_BATCH,
                  noise_sigma=figures.THEORY_NOISE_SIGMA,
                  noise_sigma2=figures.THEORY_NOISE_SIGMA2)
    t0 = phase(f"39. the Theorem 1/2 table (benchmarks/theory_table.py: "
               f"N={st['n_agents']} M={st['batch_m']} T={st['horizon']} "
               f"K={THEORY_ROUNDS}, {FIG_RUNS} lanes each)")
    mdp = figures.tabular_mdp(ref["mdp"], st["gamma"], st["horizon"],
                              device="cuda")
    pol = TabularSoftmaxPolicy(st["n_states"], st["n_actions"])
    scens = figures.theory_scenarios(mdp, THEORY_ROUNDS)
    rows = []
    for s, b, w in zip(scens, figures.theory_bounds(scens, THEORY_ROUNDS),
                       ref["rows"]):
        check(b["tag"] == w["tag"] and b["theorem"] == w["theorem"]
              and b["alpha"] == w["alpha"]
              and math.isclose(b["bound"], w["bound"], rel_tol=1e-6),
              f"theory row {b} against the reference's {w['bound']}")
        _, per_g, _, launches, ms = sweep_partition(
            torch, mdp, pol, s, THEORY_SEED, FIG_RUNS, THEORY_ROUNDS, s.tag)
        held = hold_row(per_g, w["per_run_avg_grad_sq"],
                        f"theorem {b['theorem']} {s.tag} avg_grad_sq")
        empirical = float(per_g.mean())
        holds = empirical <= b["bound"]
        log(f"theorem {b['theorem']} {s.tag}: empirical {empirical:.4f}, "
            f"bound {b['bound']:.4f} (reference {w['bound']:.4f}), alpha "
            f"{b['alpha']:.3e}, holds {holds} (reference {w['holds']}); "
            f"{launches} K1 launches, {ms:.3f} ms per batched round")
        if w["holds"]:
            check(holds, f"theory {s.tag}: {empirical} above its bound "
                         f"{b['bound']}, which the reference's holds")
        rows.append({**b, "ref_bound": w["bound"], "empirical": empirical,
                     "holds": holds, "ref_holds": w["holds"],
                     "avg_grad_sq": held, "k1_launches": launches,
                     "ms_per_round": ms})
    RECORD["theory"] = rows
    done("theory", t0)
    return rows


# ---------------------------------------------------------------------------
# phases 42-44: the benchmarks beyond the paper (power control, the
# environment zoo, participation at N = 10^4) held to the JAX package's
# runs on a CPU (perf/beyond_reference.py)
# ---------------------------------------------------------------------------

PC_ROUNDS, PC_SEED = 120, 1    # fig_power_control.run: K=120, run_sweep(seed=1)
ZOO_REF_ROUNDS, ZOO_SEED = 120, 1   # fig_env_zoo.run: jax.random.key(1)
PART_SEED = 7                  # fig_participation.py: jax.random.key(7)


def partition_sweeps(torch, env, pol, scens, seed, runs, expect_k1, what,
                     telemetry=None):
    """Each structural partition of ``scens`` as one :func:`checked_sweep`
    (every scenario on the seeds of ``fedpg.run_seeds(seed, runs)``, as in
    one sweep of the whole list), its K1 launches checked against
    ``expect_k1(partition)``.  Returns each scenario's History (numpy,
    ``(runs, K)`` leaves) in ``scens``' order, each scenario's partition
    index, and one row a partition."""
    from repro_torch.core import sweep

    hist, where, rows = [None] * len(scens), [None] * len(scens), []
    for j, part in enumerate(sweep.partition_scenarios(scens)):
        tags = [s.tag for s in part.scenarios]
        res, launches, body, ms = checked_sweep(
            torch, env, pol, part.scenarios, seed, runs, expect_k1(part),
            f"{what} {tags}", telemetry)
        for k, i in enumerate(part.indices):
            hist[i], where[i] = res.history.lane(k), j
        rows.append({"partition": j, "tags": tags,
                     "lanes": len(tags) * runs, "k1_launches": launches,
                     "k1_body": body, "ms_per_round": ms,
                     "seconds": res.partitions[0].wall_time_us / 1e6})
        log(f"{what} partition {j} {tags}: {len(tags) * runs} lanes, "
            f"{launches} K1 launches, {ms:.3f} ms a batched round")
    return hist, where, rows


def phase_power_control_held(torch):
    """``benchmarks/fig_power_control.py`` held to ``perf/
    power_control_reference.json``: the seven policy rows on the
    reference's tabular MDP, each partition 20 lanes a scenario."""
    import math

    import numpy as np

    from repro_torch import figures
    from repro_torch.rl.policy import TabularSoftmaxPolicy

    name = "power_control_reference.json"
    ref = reference(name)
    st = ref["setting"]
    check_setting(ref, name, n_rounds=PC_ROUNDS, runs=FIG_RUNS, seed=PC_SEED,
                  n_agents=figures.PC_AGENTS, batch_m=figures.PC_BATCH,
                  noise_sigma=figures.PC_NOISE_SIGMA,
                  noise_sigma2=figures.PC_NOISE_SIGMA2)
    t0 = phase(f"42. power control (benchmarks/fig_power_control.py: "
               f"N={figures.PC_AGENTS} M={figures.PC_BATCH} "
               f"T={st['horizon']} K={PC_ROUNDS}, {FIG_RUNS} lanes a "
               f"scenario)")
    mdp = figures.tabular_mdp(ref["mdp"], st["gamma"], st["horizon"],
                              device="cuda")
    pol = TabularSoftmaxPolicy(st["n_states"], st["n_actions"])
    scens = figures.power_control_scenarios(PC_ROUNDS, mdp)
    closed = figures.power_control_rows(scens)
    for c, w in zip(closed, ref["rows"]):
        check(c["tag"] == w["tag"] and c["which"] == w["which"]
              and all(math.isclose(c[k], w[k], rel_tol=1e-6) for k in (
                  "alpha", "m_h_eff", "sigma_h2_eff", "bound", "floor")),
              f"power control row {c} against the reference's {w}")
    hist, where, parts = partition_sweeps(
        torch, mdp, pol, scens, PC_SEED, FIG_RUNS, lambda p: PC_ROUNDS,
        "power control")
    check(len(parts) == ref["n_partitions"]
          and where == [w["partition"] for w in ref["rows"]],
          f"power control: partitions {where}, the reference's "
          f"{[w['partition'] for w in ref['rows']]}")
    rows, floors = [], {}
    for s, c, w, h in zip(scens, closed, ref["rows"], hist):
        per_g, _ = per_run_values(h, FIG12_TAIL)
        held = hold_row(per_g, w["per_run_avg_grad_sq"],
                        f"{s.tag} avg_grad_sq")
        empirical = float(per_g.mean())
        holds = empirical <= c["bound"]
        if w["holds"]:
            check(holds, f"power control {s.tag}: {empirical} above its "
                         f"bound {c['bound']}, which the reference's holds")
        # mean(h) as phase 18 holds it: 5 standard errors of the mean of
        # N K runs gains plus 4 float32 ulps of m_h
        mean_h = float(np.asarray(h.gain_mean, np.float64).mean())
        n_gains = s.n_agents * s.n_rounds * FIG_RUNS
        se = (c["sigma_h2_eff"] / n_gains) ** 0.5
        allow = 5 * se + 4 * 2 ** -23 * c["m_h_eff"]
        check(abs(mean_h - c["m_h_eff"]) <= allow,
              f"power control {s.tag}: mean(h)={mean_h} vs m_h="
              f"{c['m_h_eff']} (allowed {allow})")
        # the variance of a round's mean gain over the K runs rounds
        # against figures.round_gain_variance, within 5 standard errors
        # of a sample variance (from the sample's fourth central moment);
        # const_recv's h = c (1 / c) is 1 or 1 - 2^-24 in float32, so
        # there every round's mean lies within 4 float32 ulps of m_h
        gm = np.asarray(h.gain_mean, np.float64).reshape(-1)
        var_gm = float(gm.var(ddof=1))
        want_var = figures.round_gain_variance(s, c)
        if want_var == 0.0:
            z_var = None
            dev = float(np.abs(gm - c["m_h_eff"]).max())
            check(dev <= 4 * 2 ** -23 * c["m_h_eff"],
                  f"power control {s.tag}: a round's mean gain {dev} from "
                  f"m_h, which holds every gain at its target")
        else:
            m4 = float(np.mean((gm - gm.mean()) ** 4))
            z_var = (var_gm - want_var) / ((m4 - var_gm ** 2)
                                           / gm.size) ** 0.5
            check(abs(z_var) < 5,
                  f"power control {s.tag}: Var(round mean gain)={var_gm} "
                  f"vs {want_var} (z {z_var:+.2f})")
        floors[s.tag] = c["floor"]
        rows.append({**c, "ref_bound": w["bound"], "empirical": empirical,
                     "holds": holds, "ref_holds": w["holds"],
                     "mean_h": mean_h, "mean_h_se": se,
                     "round_gain_var": var_gm, "round_gain_var_want": want_var,
                     "round_gain_var_z": z_var, "avg_grad_sq": held,
                     "partition": where[len(rows)]})
        log(f"{s.tag}: {c['which']} bound {c['bound']:.4f} floor "
            f"{c['floor']:.5f} (reference {w['floor']:.5f}), holds {holds}; "
            f"mean(h) {mean_h:.6f} m_h {c['m_h_eff']:.6f} (|diff| "
            f"{abs(mean_h - c['m_h_eff']):.2e}, se {se:.2e}); Var(round "
            f"mean gain) {var_gm:.4e} vs {want_var:.4e}"
            + ("" if z_var is None else f" (z {z_var:+.2f})"))
    moves = figures.floor_moves(floors)
    log(f"floor_moves: {moves} (reference {ref['floor_moves']}); "
        f"{len(parts)} partitions (reference {ref['n_partitions']})")
    check(moves, "power control: the floors do not fall const < trunc < "
                 "unit")
    RECORD["power_control_held"] = {"rows": rows, "partitions": parts,
                                    "floor_moves": moves}
    done("power control held", t0)
    return parts


def phase_zoo_held(torch):
    """``benchmarks/fig_env_zoo.py`` held to ``perf/env_zoo_reference.
    json``: 17 scenarios in the reference's partitions, 20 lanes a
    scenario, on the reference's garnet."""
    import math

    from repro_torch import figures

    name = "env_zoo_reference.json"
    ref = reference(name)
    check_setting(ref, name, n_rounds=ZOO_REF_ROUNDS, runs=FIG_RUNS,
                  seed=ZOO_SEED, n_agents=figures.ZOO_AGENTS,
                  batch_m=figures.ZOO_BATCH, horizon=figures.ZOO_HORIZON,
                  alpha=figures.ZOO_ALPHA,
                  noise_sigma=figures.ZOO_NOISE_SIGMA,
                  final_reward_tail=figures.ZOO_TAIL)
    t0 = phase(f"43. the environment zoo (benchmarks/fig_env_zoo.py: "
               f"N={figures.ZOO_AGENTS} M={figures.ZOO_BATCH} "
               f"T={figures.ZOO_HORIZON} K={ZOO_REF_ROUNDS}, {FIG_RUNS} "
               f"lanes a scenario)")
    scens = figures.env_zoo_scenarios(
        ZOO_REF_ROUNDS, figures.garnet_mdp(ref["garnet"], device="cuda"))
    check([s.tag for s in scens] == [r["tag"] for r in ref["rows"]],
          "the zoo's scenarios are not the reference's")
    hist, where, parts = partition_sweeps(
        torch, None, None, scens, ZOO_SEED, FIG_RUNS,
        lambda p: 0 if p.proto.channel is None else ZOO_REF_ROUNDS, "zoo")
    check(len(parts) == ref["n_partitions"] < len(scens)
          and where == [w["partition"] for w in ref["rows"]],
          f"zoo: partitions {where}, the reference's "
          f"{[w['partition'] for w in ref['rows']]}")
    rows = []
    for s, w, h, j in zip(scens, ref["rows"], hist, where):
        per_g, per_r = per_run_values(h, figures.ZOO_TAIL)
        rows.append({
            "tag": s.tag, "partition": j,
            "final_reward": hold_row(per_r, w["per_run_final_reward"],
                                     f"{s.tag} final reward"),
            "avg_grad_sq": hold_row(per_g, w["per_run_avg_grad_sq"],
                                    f"{s.tag} avg_grad_sq")})
    lbar, want = figures.lbar_row(), ref["lbar"]
    check(lbar["pass"] and want["pass"]
          and all(math.isclose(lbar[k], want[k], rel_tol=1e-6)
                  for k in ("l_bar_T10", "l_bar_T20", "V")),
          f"l_bar row {lbar} against the reference's {want}")
    log(f"{len(parts)} partitions for {len(scens)} scenarios (reference "
        f"{ref['n_partitions']}); l_bar T={figures.ZOO_HORIZON} "
        f"{lbar['l_bar_T10']:.4f}, T=20 {lbar['l_bar_T20']:.4f}, V "
        f"{lbar['V']:.1f}: {lbar['pass']}")
    RECORD["zoo_held"] = {"rows": rows, "partitions": parts, "lbar": lbar}
    done("zoo held", t0)
    return parts


def run_means(tel, name):
    """Each run's NaN-aware mean of probe ``name`` over its rounds (None
    for a run with no finite value; None where the sweep has no field)."""
    import numpy as np

    arr = getattr(tel, name)
    if arr is None:
        return None
    out = []
    for x in np.asarray(arr, np.float64):
        x = x[np.isfinite(x)]
        out.append(float(x.mean()) if x.size else None)
    return out


def age_against_closed_form(rates, ages, ref_rates, ref_ages, max_age,
                            n_rounds, what):
    """Each run's mean replayed age less ``figures.expected_replay_age`` at
    that run's realised rate: the port's mean difference within 4 of its
    standard errors of 0, the reference's logged beside it."""
    import numpy as np

    from repro_torch import figures

    def gap(rates, ages):
        d = np.array([a - figures.expected_replay_age(r, max_age, n_rounds)
                      for r, a in zip(rates, ages)])
        mean, se = float(d.mean()), float(d.std(ddof=1) / d.size ** 0.5)
        return {"gap": mean, "se": se, "z": mean / se}

    port, ref = gap(rates, ages), gap(ref_rates, ref_ages)
    log(f"{what} mean age against its closed form at the realised rate: "
        f"port {port['gap']:+.5f} (z {port['z']:+.2f}), reference "
        f"{ref['gap']:+.5f} (z {ref['z']:+.2f})")
    check(abs(port["z"]) < 4, f"{what}: the mean replayed age is "
                              f"{port['gap']} from its closed form "
                              f"(z {port['z']:+.2f})")
    return {"port": port, "reference": ref}


def histories_bitwise(a, b):
    """Two scenario Histories (numpy) bit for bit, telemetry included."""
    import numpy as np

    def same(x, y):
        if x is None or y is None:
            return x is None and y is None
        x, y = np.asarray(x), np.asarray(y)
        return x.shape == y.shape and x.tobytes() == y.tobytes()

    tel = (a.telemetry is None) == (b.telemetry is None) and (
        a.telemetry is None or all(
            same(x, y) for x, y in zip(a.telemetry, b.telemetry)))
    return tel and all(same(x, y) for x, y in zip(a, b))


def phase_participation_held(torch):
    """``benchmarks/fig_participation.py`` at N = 10^4 held to ``perf/
    participation_reference.json``: the rate x staleness sweeps as 20
    runs a lane, the baseline against the participation-off sweep, and
    the round-service driver."""
    import numpy as np

    from repro_torch import figures
    from repro_torch.core import ota as ota_lib
    from repro_torch.rl.envs import make_env
    from repro_torch.service import RoundService
    from repro_torch.service import participation as svc_part
    from repro_torch.telemetry.probes import TelemetryConfig

    name = "participation_reference.json"
    ref = reference(name)
    runs, n, k = FIG_RUNS, figures.PART_AGENTS, figures.PART_ROUNDS
    check_setting(ref, name, n_rounds=k, runs=FIG_RUNS, seed=PART_SEED,
                  n_agents=n, agent_blocks=figures.PART_BLOCKS,
                  rates=list(figures.PART_RATES),
                  driver_rounds=figures.PART_DRIVER_ROUNDS)
    t0 = phase(f"44. participation at N = 10^4 (benchmarks/"
               f"fig_participation.py: blocks of {figures.PART_BLOCKS}, M=1 "
               f"T=3 K={k}, {runs} runs a lane)")
    env = make_env("landmark")
    pol = env.default_policy()
    n_blocks = ota_lib.blocked_layout(n, figures.PART_BLOCKS)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    rows, parts = [], {}
    for (stale, scens), w in zip(figures.participation_grids(),
                                 ref["sweeps"]):
        age = 0 if stale is None else stale.max_age
        per_round = (2 if stale is None else 3) * n_blocks + 1
        hist, _, p = partition_sweeps(
            torch, env, pol, scens, PART_SEED, runs,
            lambda _: per_round * k, f"stale {age}",
            telemetry=TelemetryConfig())
        check(len(p) == w["n_partitions"], f"stale {age}: {len(p)} "
              f"partitions, the reference's {w['n_partitions']}")
        parts[f"stale{age}"] = p[0]
        for s, h, wr in zip(scens, hist, w["rows"]):
            rate = s.participation.rate
            what = f"rate {rate:g} stale {age}"
            check(wr["rate"] == rate and wr["max_age"] == age,
                  f"{what}: the reference's row is rate {wr['rate']} stale "
                  f"{wr['max_age']}")
            per_g, _ = per_run_values(h, FIG12_TAIL)
            row = {"rate": rate, "max_age": age, "avg_grad_sq": hold_row(
                per_g, wr["per_run_avg_grad_sq"], f"{what} avg_grad_sq")}
            for probe in ("participation_rate", "participation_drift",
                          "staleness_mean"):
                got = run_means(h.telemetry, probe)
                want = wr[f"per_run_{probe}"]
                check((got is None) == (want is None),
                      f"{what}: {probe} {got}, the reference's {want}")
                if want is not None:
                    row[probe] = hold_row(got, want, f"{what} {probe}")
            realised = row["participation_rate"]["mean"]
            row["rate_se"] = rate_within(realised, rate, n * k * runs, what)
            if stale is not None:
                row["age_closed_form"] = age_against_closed_form(
                    run_means(h.telemetry, "participation_rate"),
                    run_means(h.telemetry, "staleness_mean"),
                    wr["per_run_participation_rate"],
                    wr["per_run_staleness_mean"], age, k, what)
            rows.append(row)

    base = figures.participation_baseline()
    off = [dataclasses.replace(s, participation=None) for s in base]
    plain = (2 * n_blocks + 1) * k
    hb, _, pb = partition_sweeps(torch, env, pol, base, PART_SEED, runs,
                                 lambda _: plain, "baseline",
                                 telemetry=TelemetryConfig())
    ho, _, po = partition_sweeps(torch, env, pol, off, PART_SEED, runs,
                                 lambda _: plain, "participation off",
                                 telemetry=TelemetryConfig())
    check(histories_bitwise(hb[0], ho[0]), "the full-participation "
          "baseline is not bitwise the participation-off sweep")
    per_g, _ = per_run_values(hb[0], FIG12_TAIL)
    baseline = hold_row(per_g, ref["baseline"]["per_run_avg_grad_sq"],
                        "baseline avg_grad_sq")
    log("baseline: bitwise the participation-off sweep (rewards, grad_sq, "
        "gain_mean, telemetry)")
    parts["baseline"] = pb[0]
    parts["participation_off"] = po[0]
    sweep_peak = (torch.cuda.max_memory_allocated() - resident) / 1e6

    kw = figures.participation_driver()
    cfg = kw.pop("cfg")
    rounds = kw["service"].max_rounds
    reset_counts()
    t1 = time.perf_counter()
    records = RoundService(env, pol, cfg, PART_SEED, device="cuda",
                           **kw).run()
    driver_s = time.perf_counter() - t1
    launches = read_counts()["ota_fused"]
    check(launches == (3 * n_blocks + 1) * rounds,
          f"driver: {launches} K1 launches, expected "
          f"{(3 * n_blocks + 1) * rounds}")
    expect = svc_part.expected_count(kw["participation"], n) / n
    rate = float(np.mean([r["participation_rate"] for r in records]))
    se = rate_within(rate, expect, n * rounds, "driver")
    last, ref_last = records[-1], ref["driver"]["last"]
    log(f"driver: {len(records)} commits of {rounds} rounds in "
        f"{driver_s:.1f} s, {launches} K1 launches; rate {rate:.5f} "
        f"(expected {expect:.5f} with stragglers, se {se:.1e}); last commit "
        f"rate {last['participation_rate']:.5f} drift "
        f"{last['participation_drift']:.3g} staleness_hist "
        f"{last['staleness_hist']} (reference "
        f"{ref_last['participation_rate']:.5f}, "
        f"{ref_last['participation_drift']:.3g}, "
        f"{ref_last['staleness_hist']})")
    peak = (torch.cuda.max_memory_allocated() - resident) / 1e6
    log(f"peak memory above the resident {resident / 1e6:.1f} MB: sweeps "
        f"{sweep_peak:.1f} MB, with the driver {peak:.1f} MB")
    RECORD["participation_held"] = {
        "rows": rows, "partitions": parts, "baseline": baseline,
        "baseline_bitwise_off": True, "sweep_peak_mb": sweep_peak,
        "peak_mb": peak, "driver": {
            "records": records, "rate": rate, "expected": expect, "se": se,
            "k1_launches": launches, "seconds": driver_s,
            "reference_last": ref_last}}
    done("participation held", t0)
    return parts, launches / rounds


def psum_rank(mesh, arch, n_steps):
    """One rank of phase 33's psum step (``launch.mesh.run_local``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return psum_train(torch, mesh, arch, n_steps)


# ---------------------------------------------------------------------------
# phase 40: the tensor-parallel serve path on a ("data", "model") mesh
# ---------------------------------------------------------------------------

SHARD_SERVE = (   # (arch, bf16 prefill's K3/K4 kernel, float32's, launches)
    ("llama3.2-3b", "flash_attention_wgmma", "flash_attention", 28),
    (GRANITE, "flash_attention_wgmma", "flash_attention", 24),
    ("mamba2-130m", "ssd_scan_tc", "ssd_scan", 24))
SHARD_FAMILIES = (  # bf16 only: (arch, depth (None: published), prefill's
    #                   K3/K4 kernel, its launches, of them bidirectional);
    #                   phases 35-36's depth cuts
    (ZAMBA, 13, "ssd_scan_tc", 13, 0),
    (VISION, 10, "flash_attention_wgmma", 10, 0),
    (SEAMLESS, None, "flash_attention_wgmma", 48, 24))
SHARD_STEPS = 4
SHARD_MESHES = ((1, 4), (2, 2))   # llama3.2-3b where there are four cards


def cache_fields(cache):
    """(name, tensor) of every tensor field of a cache, DTensors local."""
    out = []
    for name, value in cache._asdict().items():
        if name == "pos" or value is None:
            continue
        for i, t in enumerate(value):
            out.append((f"{name}.{i}", t.to_local() if hasattr(
                t, "to_local") else t))
    return out


def caches_equal(torch, a, b):
    fa, fb = cache_fields(a), cache_fields(b)
    return a.pos == b.pos and [n for n, _ in fa] == [n for n, _ in fb] and \
        all(torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


def timed(torch, fn):
    s0, s1 = events(torch)
    s0.record()
    out = fn()
    s1.record()
    torch.cuda.synchronize()
    return out, s0.elapsed_time(s1)


def serve_pass(torch, m, prefill, step, init_full, prompt):
    """One prefill and ``SHARD_STEPS`` greedy decode steps from a cache of
    ``S + SHARD_STEPS`` slots (the prefill's KV copied in); the K3/K4
    launches and CUDA-event ms of the prefill and of the steps."""
    reset_counts()
    (logits, cache), pre_ms = timed(torch, lambda: prefill(prompt))
    counts = dict(read_counts(), bidirectional=sum(
        k3_bidir_counts().values()))
    full = init_full(cache)

    def steps():
        nonlocal full
        tok = torch.argmax(local_of(logits)[:, -1:, :], -1)
        out = []
        for _ in range(SHARD_STEPS):
            tok, lg, full = step(full, tok)
            tok = local_of(tok)
            out.append(local_of(lg))
        return out

    step_logits, dec_ms = timed(torch, steps)
    return dict(logits=local_of(logits), cache=cache, steps=step_logits,
                final=full, counts=counts, prefill_ms=pre_ms,
                decode_ms=dec_ms / SHARD_STEPS)


def local_of(x):
    return x.to_local() if hasattr(x, "to_local") else x


BREAKDOWN_STEPS = 3    # decode steps a variant a round of the breakdown
BREAKDOWN_ROUNDS = 3   # rounds over the variants, in turns


def step_breakdown(torch, m, params, srv, plain_step, sharded_step,
                   plain_full, sharded_full, tok):
    """Host ms of one bf16 decode step (the device is mostly idle in
    decode), each from the same cache at the same position: the median
    over ``BREAKDOWN_ROUNDS`` rounds, in turns, of the mean of
    ``BREAKDOWN_STEPS`` steps, with the sharded path's pieces removed in
    turn: the
    unsharded step; the sharded step; it with its collectives made no-ops
    (the identity at one rank, so every variant's logits are asserted
    bitwise the sharded step's); the model inside the hints context on
    local tensors, without the server's DTensor wrapping; that with no-op
    collectives."""
    import types

    import torch.distributed as dist

    from repro_torch.models import transformer
    from repro_torch.utils import shard_hints

    cfg = m.cfg
    local_cache = {name: [local_of(t) for t in value]
                   for name, value in sharded_full._asdict().items()
                   if name != "pos" and value is not None}
    local_full = sharded_full._replace(**{
        k: type(getattr(sharded_full, k))(*v) for k, v in local_cache.items()})

    def bare():
        with srv.hints("decode"):
            return transformer.decode(srv.local, cfg, local_full, tok)[0]

    no_op = types.SimpleNamespace(
        all_reduce=lambda x, op=None, group=None: None,
        ReduceOp=dist.ReduceOp, get_world_size=dist.get_world_size)
    variants = (
        ("unsharded", lambda: plain_step(params, plain_full, tok)[1], False),
        ("sharded", lambda: local_of(sharded_step(sharded_full, tok)[1]),
         False),
        ("sharded, no-op collectives",
         lambda: local_of(sharded_step(sharded_full, tok)[1]), True),
        ("model in hints, no DTensor wrapping", bare, False),
        ("model in hints, no wrapping, no-op collectives", bare, True))
    times, ref = {name: [] for name, _, _ in variants}, None
    for rnd in range(BREAKDOWN_ROUNDS):
        for name, fn, stub in variants:
            real = (shard_hints.dist, shard_hints._gather_single)
            if stub:
                shard_hints.dist = no_op
                shard_hints._gather_single = \
                    lambda o, x, group=None: o.copy_(x)
            try:
                if rnd == 0:
                    fn()                              # warm-up
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(BREAKDOWN_STEPS):
                    got = fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3
                                   / BREAKDOWN_STEPS)
            finally:
                shard_hints.dist, shard_hints._gather_single = real
            if name != "unsharded":
                ref = got if ref is None else ref
                check(torch.equal(got, ref), f"{cfg.arch_id}: the step "
                                             f"breakdown's {name} logits "
                                             f"differ")
    return {name: statistics.median(ts) for name, ts in times.items()}


def widen_sharded(srv, cache, capacity, device="cuda"):
    """:func:`widen_cache` of a ``ShardedServer``'s prefill cache into a
    cache of ``capacity`` slots from ``srv.init_cache``, placed by global
    slot: the local tensors copied where neither cache's sequence is
    sharded, else each rank gathers the prompt's cache and keeps its block
    of the wide one (``server.cache_specs``)."""
    from repro_torch.models.param import local_shard
    from repro_torch.train import server

    if srv.cfg.family in ("ssm", "hybrid"):
        return cache
    fields = [f for f in KV_FIELDS if getattr(cache, f) is not None]
    b, s = getattr(cache, fields[0]).k.shape[-4:-2]      # the whole cache's
    mem_len = 0 if cache.cross_kv is None else cache.cross_kv[0].shape[2]
    full = srv.init_cache(b, capacity, mem_len, device=device)
    by_slot = srv.slot_span(b, s) or srv.slot_span(b, capacity)
    specs = server._cache_specs(srv.cfg, b, capacity, srv.mesh)
    for f in fields:
        for dst, src, spec in zip(getattr(full, f), getattr(cache, f),
                                  getattr(specs, f)):
            if by_slot is None:
                local_of(dst)[..., :s, :, :] = local_of(src)
                continue
            whole = src.full_tensor()
            wide = whole.new_zeros(dst.shape)
            wide[..., :s, :, :] = whole
            local_of(dst).copy_(local_shard(wide, spec, srv.mesh))
    return full._replace(pos=cache.pos, cross_kv=cache.cross_kv)


def sharded_serve_one(torch, mesh, arch, dtype, kernel, n_launches,
                      floor=False, n_layers=None, n_bidir=0,
                      breakdown=True):
    """Phase 40 for one config and dtype on this rank: the same weights
    served unsharded (a warm-up pass, then a timed one) and through
    ``shard_for_serving`` on the (1, 1) mesh, in turns; every logit and
    cache field bitwise, K3/K4 launches as the unsharded prefill's
    (``n_bidir`` of them bidirectional).  ``n_layers`` cuts the depth; the
    vlm and encdec families take the memory stub of the prompt.
    ``floor``: also the bf16 prefill against the kernel's plain version
    and that against a plain version that sums in another order (phase
    10's noise floor); ``breakdown``: the bf16 decode step's host time
    with the sharded path's pieces removed in turn."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import local_params
    from repro_torch.train import server
    from repro_torch.utils import shard_hints
    from repro_torch.utils.tree import flatten_paths

    cfg = get_config(arch).with_(dtype=dtype)
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    m = model_lib.build(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, prompt = model_and_prompt(torch, m, 0)
    memory = model_memory(m, prompt)
    srv = server.shard_for_serving(m, params, mesh)
    same_storage = all(a.data_ptr() == b.data_ptr() for a, b in zip(
        flatten_paths(params).values(),
        flatten_paths(local_params(srv.params)).values()))
    check(same_storage, f"{arch} {dtype}: the sharded weights are not the "
                        f"unsharded ones (one set of weights on one rank)")
    b, s = SERVE_BATCH, SERVE_PROMPT
    cap = s + SHARD_STEPS
    shape = InputShape("serve", seq_len=cap, global_batch=b, kind="decode")
    plain_step = server.make_serve_step(m, shape)

    def sharded_full(cache):
        return widen_sharded(srv, cache, cap)

    with torch.no_grad():
        plain = lambda p: m.prefill(params, p, memory)   # noqa: E731
        plain_full = lambda c: widen_cache(m, c, cap)   # noqa: E731
        step = lambda c, t: plain_step(params, c, t)   # noqa: E731
        ref = serve_pass(torch, m, plain, step, plain_full, prompt)
        sh = serve_pass(torch, m, lambda p: srv.prefill(p, memory),
                        srv.make_serve_step(shape), sharded_full, prompt)
        again = serve_pass(torch, m, plain, step, plain_full, prompt)
        collectives = (shard_hints.ALL_REDUCES, shard_hints.ALL_GATHERS)
        if dtype != "bfloat16" or not breakdown:
            breakdown = None
        else:
            tok = torch.argmax(ref["logits"][:, -1:, :], -1)
            breakdown = step_breakdown(
                torch, m, params, srv, plain_step, srv.make_serve_step(shape),
                plain_full(again["cache"]), sharded_full(sh["cache"]), tok)
    peak = torch.cuda.max_memory_allocated() / 1e9
    for name, x in (("sharded", sh), ("unsharded, second pass", again)):
        check(torch.equal(x["logits"], ref["logits"]),
              f"{arch} {dtype}: {name} prefill logits not bitwise")
        check(caches_equal(torch, x["cache"], ref["cache"]),
              f"{arch} {dtype}: {name} prefill cache not bitwise")
        check(all(torch.equal(a, c) for a, c in zip(x["steps"],
                                                    ref["steps"])),
              f"{arch} {dtype}: {name} decode logits not bitwise")
        check(caches_equal(torch, x["final"], ref["final"]),
              f"{arch} {dtype}: {name} final cache not bitwise")
        check(x["counts"] == ref["counts"] and x["counts"][kernel]
              == n_launches and sum(x["counts"][k] for k in K34)
              == n_launches and x["counts"]["bidirectional"] == n_bidir,
              f"{arch} {dtype}: {name} prefill K3/K4 launches "
              f"{x['counts']}, expected {n_launches} of {kernel}, "
              f"{n_bidir} bidirectional")
    check(bool(torch.isfinite(sh["logits"].float()).all()),
          f"{arch} {dtype}: logits not finite")
    noise = None
    if floor:
        noise = bf16_cross_check(torch, m, params, prompt, kernel,
                                 sh["logits"])
    return {"prefill_ms": sh["prefill_ms"], "decode_ms": sh["decode_ms"],
            "bf16_floor": noise,
            "plain_prefill_ms": again["prefill_ms"],
            "plain_decode_ms": again["decode_ms"], "peak_gb": peak,
            "step_breakdown_ms": breakdown, "collectives_at": collectives,
            "launches": sh["counts"][kernel], "kernel": kernel,
            "n_layers": cfg.n_layers,
            "logits_cpu": sh["logits"].float().cpu(),
            "steps_cpu": [x.float().cpu() for x in sh["steps"]],
            "fed_tokens": torch.cat([torch.argmax(x[:, -1:, :], -1) for x in
                                     [sh["logits"]] + sh["steps"][:-1]],
                                    1).cpu()}


def warm_mesh(torch, mesh):
    """One collective on each axis' group: nccl sets a communicator up at
    its first collective (hundreds of ms), which no timing should hold."""
    import torch.distributed as dist

    for name in mesh.mesh_dim_names:
        dist.all_reduce(torch.zeros(1, device=mesh.device_type),
                        group=mesh.get_group(name))
    if mesh.device_type == "cuda":
        torch.cuda.synchronize()
    return mesh


def sharded_serve_rank(mesh_unused):
    """Phase 40 on one nccl rank (``launch.mesh.run_local``): a (1, 1)
    ``("data", "model")`` mesh, each config and dtype."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.utils import shard_hints

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = warm_mesh(torch, mesh_lib.make_tiny_mesh(1, 1))
    out = {}
    several = torch.cuda.device_count() >= 4
    runs = [(arch, dtype, kernel, n, {"floor": several and (
        arch, dtype) == ("llama3.2-3b", "bfloat16")})
        for arch, k16, k32, n in SHARD_SERVE
        for dtype, kernel in (("bfloat16", k16), ("float32", k32))]
    runs += [(arch, "bfloat16", kernel, n, {
        "n_layers": depth, "n_bidir": bidir, "breakdown": False})
        for arch, depth, kernel, n, bidir in SHARD_FAMILIES]
    for arch, dtype, kernel, n, kw in runs:
        before = (shard_hints.ALL_REDUCES, shard_hints.ALL_GATHERS)
        r = out[(arch, dtype)] = sharded_serve_one(torch, mesh, arch, dtype,
                                                   kernel, n, **kw)
        r["collectives"] = tuple(a - b for a, b in zip(
            r.pop("collectives_at"), before))
    return out


def sharded_multi_rank(mesh_unused, data, model_, dtype, fed):
    """Phase 40 over several cards: llama3.2-3b on a ``(data, model_)``
    mesh, the prefill and ``SHARD_STEPS`` decode steps fed the one-rank
    run's greedy tokens; the gathered logits on the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    from repro_torch.train import server

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = warm_mesh(torch, mesh_lib.make_tiny_mesh(data, model_))
    m = model_lib.build(get_config("llama3.2-3b").with_(dtype=dtype))
    params, prompt = model_and_prompt(torch, m, 0)
    srv = server.shard_for_serving(m, params, mesh)
    del params
    b, s = SERVE_BATCH, SERVE_PROMPT
    cap = s + SHARD_STEPS
    with torch.no_grad():
        srv.prefill(prompt)     # warm-up: cuBLAS, the kernels' first calls
        reset_counts()
        (logits, cache), pre_ms = timed(torch, lambda: srv.prefill(prompt))
        counts = read_counts()
        full = widen_sharded(srv, cache, cap)
        del cache
        step = srv.make_serve_step(InputShape("serve", cap, b, "decode"))
        fed = fed.cuda()
        out = [logits.full_tensor().float().cpu()]
        s0, s1 = events(torch)
        s0.record()
        for i in range(SHARD_STEPS):
            _, lg, full = step(full, fed[:, i:i + 1])
            out.append(lg.full_tensor().float().cpu())
        s1.record()
        torch.cuda.synchronize()
    return {"logits": out, "prefill_ms": pre_ms,
            "decode_ms": s0.elapsed_time(s1) / SHARD_STEPS,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "k3_launches": counts["flash_attention_wgmma"]
            + counts["flash_attention"]}


DEEPSEEK = "deepseek-67b"
DEEPSEEK_CUT = 4               # layers of the one-card cross-check
SHARDED_ACROSS_CARDS = "--sharded-serve-across-cards"


def layerwise_params(torch, plan, dtype, seed, device, mesh=None,
                     rules=None):
    """Random weights of ``plan`` drawn leaf by leaf and, along a stacked
    'layers' axis, layer by layer, each draw in float32 from
    ``index_generator(seed, 1000 * leaf + layer)`` and then cast (the
    JAX package's normal / ones / zeros inits and the SSM's uniform ones;
    a two-axis stack drawn a group at a time).  With a ``DeviceMesh``
    each rank keeps only its shards (DTensors under ``rules``) and never
    holds a whole stacked leaf; a plan cut in depth draws the same first
    layers."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.param import (
        P, NamedSharding, local_shard, map_plan, spec_for,
    )
    from repro_torch.utils.device import index_generator

    leaf_no = [0]

    def one(d):
        leaf = leaf_no[0]
        leaf_no[0] += 1
        dt = getattr(torch, d.dtype or dtype)
        spec = P() if mesh is None else spec_for(d, rules, mesh)

        def draw(shape, i, spec):
            if d.init in ("ones", "zeros"):
                x = (torch.ones if d.init == "ones" else torch.zeros)(
                    shape, dtype=dt, device=device)
            elif d.init == "normal":
                g = index_generator(seed, 1000 * leaf + i, device)
                x = (torch.randn(shape, generator=g, device=device)
                     * d.stddev()).to(dt)
            elif d.init in ("uniform", "dt_bias", "a_log"):
                g = index_generator(seed, 1000 * leaf + i, device)
                u = torch.rand(shape, generator=g, device=device)
                if d.init == "uniform":
                    x = (u * 2.0 - 1.0) * d.stddev()
                elif d.init == "dt_bias":   # softplus^-1 of U[1e-3, 1e-1]
                    x = torch.log(torch.expm1(u * (1e-1 - 1e-3) + 1e-3))
                else:                       # log of U[1, 16]
                    x = torch.log(u * 15.0 + 1.0)
                x = x.to(dt)
            else:
                raise ValueError(f"layerwise_params: init {d.init!r}")
            return x if mesh is None else local_shard(x, spec, mesh)

        if d.axes[:1] != ("layers",):
            local = draw(d.shape, 0, spec)
        else:
            sub = P(*spec[1:])
            first = draw(d.shape[1:], 0, sub)
            local = first.new_empty((d.shape[0],) + tuple(first.shape))
            local[0] = first
            del first
            for i in range(1, d.shape[0]):
                local[i] = draw(d.shape[1:], i, sub)
        if mesh is None:
            return local
        return DTensor.from_local(local, mesh, NamedSharding(
            mesh, spec).placements, run_check=False)

    return map_plan(one, plan)


def sync_ms(torch, fn, device):
    """``fn()`` and its milliseconds on the host clock, the device
    synchronised before and after."""
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def layerwise_serve(torch, cfg, mesh, device, fed=None, batch=SERVE_BATCH,
                    prompt_len=SERVE_PROMPT, floor=False):
    """``cfg`` served from ``layerwise_params`` (seed 0) over ``mesh``
    (None: unsharded): the prefill (the vlm and encdec families with the
    memory stub of the prompt) and ``SHARD_STEPS`` decode steps, fed
    ``fed`` (B, SHARD_STEPS) or the greedy tokens; every logit on the CPU,
    ms, peak GB, K3 launches and the fed tokens.  ``floor`` (unsharded,
    bf16): also the prefill against K3's plain version and that against a
    plain version that sums in another order (``bf16_cross_check``)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import serve_rules
    from repro_torch.train import server
    from repro_torch.utils.device import index_generator

    m = model_lib.build(cfg)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params, init_ms = sync_ms(torch, lambda: layerwise_params(
        torch, m.plan, cfg.dtype, 0, device, mesh, serve_rules()), device)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), device=device,
                           generator=index_generator(0, -1, device))
    memory = model_memory(m, prompt)
    cap = prompt_len + SHARD_STEPS
    shape = InputShape("serve", seq_len=cap, global_batch=batch,
                       kind="decode")
    with torch.no_grad():
        if mesh is None:
            m.prefill(params, prompt, memory)          # warm-up
            reset_counts()
            (logits, cache), pre_ms = sync_ms(
                torch, lambda: m.prefill(params, prompt, memory), device)
            full = widen_cache(m, cache, cap, device)
            plain = server.make_serve_step(m, shape)

            def step(c, t):
                return plain(params, c, t)
        else:
            srv = server.shard_for_serving(m, params, mesh)
            srv.prefill(prompt, memory)                # warm-up
            reset_counts()
            (logits, cache), pre_ms = sync_ms(
                torch, lambda: srv.prefill(prompt, memory), device)
            full = widen_sharded(srv, cache, cap, device)
            step = srv.make_serve_step(shape)
        k3 = read_counts()
        del cache

        def whole(x):
            return (x.full_tensor() if hasattr(x, "full_tensor") else x
                    ).float().cpu()

        out = [whole(logits)]
        toks = []
        tok = torch.argmax(out[0][:, -1:, :], -1)

        def steps():
            nonlocal tok, full
            for i in range(SHARD_STEPS):
                t_in = (tok if fed is None else fed[:, i:i + 1]).to(device)
                toks.append(t_in.cpu())
                _, lg, full = step(full, t_in)
                out.append(whole(lg))
                tok = torch.argmax(out[-1][:, -1:, :], -1)

        _, dec_ms = sync_ms(torch, steps, device)
    noise = None
    if floor:
        noise = bf16_cross_check(torch, m, params, prompt,
                                 "flash_attention_wgmma", logits)
    return {"logits": out, "fed": torch.cat(toks, 1), "init_ms": init_ms,
            "bf16_floor": noise,
            "prefill_ms": pre_ms, "decode_ms": dec_ms / SHARD_STEPS,
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if device == "cuda" else None),
            "k3_launches": k3["flash_attention_wgmma"]
            + k3["flash_attention"],
            "n_layers": cfg.n_layers}


def deepseek_rank(mesh_unused, cfg, device, full_depth=True):
    """deepseek-67b over a (1, 4) mesh on this rank: at full depth (where
    ``full_depth``), then cut to ``DEEPSEEK_CUT`` layers; rank 0 also
    serves the cut model unsharded, fed the same tokens."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = warm_mesh(torch, mesh_lib.make_tiny_mesh(1, 4))
    out = {}
    if full_depth:
        out["full"] = layerwise_serve(torch, cfg, mesh, device)
        out["full"]["logits_finite"] = all(
            bool(torch.isfinite(x).all()) for x in out["full"]["logits"])
        out["full"]["logits"] = None
    cut = cfg.with_(n_layers=DEEPSEEK_CUT)
    out["cut"] = layerwise_serve(torch, cut, mesh, device)
    if dist.get_rank() == 0:
        out["cut_plain"] = layerwise_serve(torch, cut, None, device,
                                          fed=out["cut"]["fed"])
    return out


def check_deepseek(torch, ranks):
    """The sharded cut model's logits against the unsharded one's (2e-2 of
    the max abs logit), every rank the same, the full-depth run finite."""
    cut, plain = ranks[0]["cut"], ranks[0]["cut_plain"]
    errs = [rel_err(a, b) for a, b in zip(cut["logits"], plain["logits"])]
    check(max(errs) < 2e-2, f"{DEEPSEEK} cut to {DEEPSEEK_CUT} layers: "
                            f"sharded against unsharded {errs}")
    for r in ranks:
        check(all(torch.equal(a, b) for a, b in zip(r["cut"]["logits"],
                                                    cut["logits"])),
              f"{DEEPSEEK}: the ranks' logits differ")
        if "full" in r:
            check(r["full"]["logits_finite"],
                  f"{DEEPSEEK}: full-depth logits not finite")
    return errs


def phase_sharded_serve(torch):
    """Phase 40: the tensor-parallel serve path (``train.server.
    shard_for_serving``) at full width on a one-rank nccl ``("data",
    "model")`` mesh (1, 1): llama3.2-3b, granite-moe-1b-a400m and
    mamba2-130m, bf16 and float32, then bf16 zamba2-7b (13 layers),
    llama-3.2-vision-11b (10 layers, its patch memory) and
    seamless-m4t-large-v2 (its frame memory), prefill B=4 S=2048 and 4
    greedy decode steps on the same weights as the unsharded path, in
    turns: logits and every cache field (``cross_kv`` included) bitwise,
    K3/K4 launches a prefill 28 / 24 / 24 / 13 (K4) / 10 / 48 (24
    bidirectional) as the unsharded prefill's; ms a prefill and a step,
    peak GB.  Where there are
    four cards, llama3.2-3b over (1, 4) and (2, 2) against the one-rank
    logits: float32 within 1e-4 of the max abs logit, bf16 within 2e-2
    (the row-parallel products' partial sums kept in float32 and rounded
    once, ``shard_hints.row_parallel``), both asserted; bf16 also beside
    phase 10's noise floor on the one rank (the prefill against K3's plain
    version, and that against a plain version that sums in another
    order).  On one rank, bf16, a decode step's host time with the sharded
    path's pieces removed in turn (``step_breakdown``)."""
    from repro_torch.launch import mesh as mesh_lib

    t0 = phase("40. the sharded serve path: every family at full width "
               "on a (1, 1) nccl mesh, bitwise the unsharded path")
    torch.cuda.empty_cache()
    res = mesh_lib.run_local(sharded_serve_rank, 1, device="cuda",
                             timeout=600)[0]
    rec = {}
    for (arch, dtype), r in res.items():
        log(f"{arch} {dtype} ({r['n_layers']} layers): sharded prefill "
            f"{r['prefill_ms']:.2f} ms "
            f"(unsharded {r['plain_prefill_ms']:.2f}), decode "
            f"{r['decode_ms']:.2f} ms a step (unsharded "
            f"{r['plain_decode_ms']:.2f}), peak {r['peak_gb']:.2f} GB; "
            f"{r['launches']} {r['kernel']} launches a prefill; "
            f"collectives {r['collectives']}; logits and every cache field "
            f"bitwise the unsharded path")
        if r["step_breakdown_ms"]:
            log(f"{arch} {dtype}: a decode step's host ms, pieces removed in "
                f"turn: " + "; ".join(f"{k} {v:.2f}" for k, v in
                                      r["step_breakdown_ms"].items()))
        rec[f"{arch} {dtype}"] = {k: v for k, v in r.items()
                                  if not k.endswith("_cpu")
                                  and k != "fed_tokens"}
    split = {}
    for dtype in ("float32", "bfloat16"):
        split[dtype] = r = split_slot_decode(torch, dtype)
        log(f"llama3.2-3b {dtype} split-slot decode, one attention layer, "
            f"{r['capacity']} slots at position {r['pos']}: unsharded "
            f"{r['unsharded_ms']:.4f} ms; " + "; ".join(
                f"{n} shards max abs err {r[f'{n} shards']['max_abs_err']:.3e}"
                f" (of {r[f'{n} shards']['max_abs']:.3e}), split layer "
                f"{r[f'{n} shards']['split_ms']:.4f} ms, combine "
                f"{r[f'{n} shards']['combine_ms']:.4f} ms"
                for n in SPLIT_SHARDS))
    multi = {}
    if torch.cuda.device_count() >= 4:
        floor = res[("llama3.2-3b", "bfloat16")]["bf16_floor"]
        log(f"llama3.2-3b bfloat16, one rank: prefill against K3's plain "
            f"version {floor['rel_err']:.3e}, beside a noise floor of "
            f"{floor['noise_floor']:.3e} (plain against plain with "
            f"{floor['floor_by']})")
        for dtype in ("bfloat16", "float32"):
            one = res[("llama3.2-3b", dtype)]
            want = [one["logits_cpu"]] + one["steps_cpu"]
            for data, model_ in SHARD_MESHES:
                ranks = mesh_lib.run_local(
                    sharded_multi_rank, 4, data, model_, dtype,
                    one["fed_tokens"], device="cuda", timeout=600)
                errs = [rel_err(g, w) for g, w in zip(ranks[0]["logits"],
                                                      want)]
                check(max(errs) < (1e-4 if dtype == "float32" else 2e-2),
                      f"llama3.2-3b {dtype} ({data}, {model_}): {errs} "
                      f"against one rank")
                check(all(torch.equal(a, b) for r in ranks for a, b in
                          zip(r["logits"], ranks[0]["logits"])),
                      f"({data}, {model_}): the ranks' logits differ")
                row = {"max_rel_err": max(errs), "rel_errs": errs, **{
                    k: [r[k] for r in ranks] for k in (
                        "prefill_ms", "decode_ms", "peak_gb",
                        "k3_launches")}}
                multi[f"llama3.2-3b {dtype} ({data}, {model_})"] = row
                log(f"llama3.2-3b {dtype} on ({data}, {model_}): max rel err "
                    f"{max(errs):.3e} against one rank; prefill "
                    f"{fmt_ms(row['prefill_ms'])} ms, decode "
                    f"{fmt_ms(row['decode_ms'])} ms a step, peak "
                    f"{row['peak_gb']} GB, K3 {row['k3_launches']} a rank")
    RECORD["sharded_serve"] = {"one_rank": rec, "multi": multi,
                               "split_slot": split}
    done("sharded serve", t0)
    return rec


SPLIT_SHARDS = (2, 4)    # phase 40's slot shards of one long_500k cache
SPLIT_SPIN = 20_000_000  # a spin past the host's enqueue of a whole layer


def split_slot_decode(torch, dtype):
    """Phase 40's split-slot decode: one attention layer of llama3.2-3b at
    full width (random weights from seed 0) and ``long_500k``'s cache
    (batch 1, ``serve_capacity`` = 8192 slots of random K/V, a ring), the
    token at ``long_500k``'s last position (524287, past the wrap).  The
    unsharded ``decode_self_attention`` output against ``decode_partials``
    over n = 2 and 4 slot shards of the same cache, merged by
    ``combine_partials`` (no collective: the shards are stacked in one
    process), then ``wo``: float32 within rtol 1e-5 (atol 1e-5 of the max
    abs value), bf16 within 2e-2 of it (asserted); CUDA-event medians of
    the unsharded layer, of the split layer (its projections, rope, the
    shards' partials, the combine and ``wo``) and of the combine alone."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import LONG_500K
    from repro_torch.models import attention
    from repro_torch.models.model import serve_capacity
    from repro_torch.models.param import init_params

    cfg = get_config("llama3.2-3b").with_(dtype=dtype)
    dt = getattr(torch, dtype)
    cap, pos = serve_capacity(cfg, LONG_500K.seq_len), LONG_500K.seq_len - 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = init_params(attention.attn_plan(cfg), dtype, generator=gen,
                    device="cuda")
    x = torch.randn(1, 1, cfg.d_model, generator=gen, device="cuda").to(dt)
    shape = (1, cap, cfg.n_kv_heads, cfg.head_dim)
    kv = attention.KVCache(*(torch.randn(shape, generator=gen,
                                         device="cuda").to(dt)
                             for _ in range(2)))
    rec = {"capacity": cap, "pos": pos}
    with torch.no_grad():
        want = attention.decode_self_attention(p, x, kv, pos, cfg)[0]
        rec["unsharded_ms"] = device_ms(torch, lambda: (
            attention.decode_self_attention(p, x, kv, pos, cfg)),
            sleep_cycles=SPLIT_SPIN)
        top = want.float().abs().max().item()
        for n in SPLIT_SHARDS:
            split = split_decode_in_process(torch, n)
            got = split(p, x, kv, pos, cfg)[0]
            err = (got.float() - want.float()).abs().max().item()
            if dtype == "float32":
                ok = bool(((got - want).abs() <= 1e-5 * top
                           + 1e-5 * want.abs()).all())
            else:
                ok = err < 2e-2 * top
            check(ok, f"split-slot decode {dtype}, {n} shards: max abs err "
                      f"{err:.3e} of max abs {top:.3e}")
            q_pos, q, _, _ = attention.decode_qkv(p, x, pos, cfg)
            parts = slot_partials(torch, q, q_pos, kv, pos, n)
            rec[f"{n} shards"] = {
                "max_abs_err": err, "max_abs": top,
                "split_ms": device_ms(torch, lambda: split(p, x, kv, pos,
                                                           cfg),
                                      sleep_cycles=SPLIT_SPIN),
                "combine_ms": device_ms(torch, lambda: (
                    attention.combine_partials(*parts, dt)),
                    sleep_cycles=SPLIT_SPIN)}
    return rec


LONG_MESHES = ((4, 1), (2, 2))   # batch 1 in long_500k's cache, four cards
LONG_STEPS = 4


def slot_partials(torch, q, q_pos, cache, pos, n, window=None):
    """``attention.decode_partials`` of q over ``n`` slot shards of a whole
    ring ``cache`` (its K/V of ``pos`` written), stacked (n, ...)."""
    from repro_torch.models import attention

    c = cache.capacity
    k_pos = attention.slot_positions(pos, 0, c, c, q.device)
    per = c // n
    parts = [attention.decode_partials(
        q, cache.k[:, i * per:(i + 1) * per],
        cache.v[:, i * per:(i + 1) * per], q_pos=q_pos,
        k_pos=k_pos[i * per:(i + 1) * per],
        window=window if window is not None and window < c else None,
        k_valid=k_pos[i * per:(i + 1) * per] >= 0) for i in range(n)]
    return [torch.stack(t) for t in zip(*parts)]


def split_decode_in_process(torch, n):
    """``attention.decode_self_attention`` computed as ``n`` sequence
    shards would compute it, in one process: the rank's projections, rope
    and write, :func:`slot_partials` and ``combine_partials`` without
    collectives, then ``wo`` (phase 40's split-slot decode; a replacement
    for the unsharded function in the bf16 floor of
    :func:`long_context_cards`)."""
    from repro_torch.models import attention

    def decode(params, x, cache, pos, cfg, *, window=None, slots=None):
        q_pos, q, k, v = attention.decode_qkv(params, x, pos, cfg)
        c = cache.capacity
        cache.k[:, pos % c:pos % c + 1] = k
        cache.v[:, pos % c:pos % c + 1] = v
        o = attention.combine_partials(*slot_partials(
            torch, q, q_pos, cache, pos, n, window), q.dtype)
        return attention._out_proj(params, o), cache

    return decode


def long_context_rank(mesh_unused, dims, dtype, fed, split=0):
    """llama3.2-3b at full width and depth, batch 1, served in
    ``long_500k``'s cache (``serve_capacity`` = 8192 slots) over a ``dims``
    mesh of this host's cards (None: unsharded on this rank's card; with
    ``split``, its decode attention computed over that many slot shards in
    one process, :func:`split_decode_in_process`): a prompt of 8192 tokens
    through K3, which fills the ring, then ``LONG_STEPS`` steps of
    ``make_serve_step(long_500k)`` at positions 8192.. (the ring wraps into
    slots 0.., rank 0's), fed ``fed`` (None: greedy).  Every logit on the
    CPU, ms, the collectives of each step, the cache GB this rank holds,
    its slot span and K3's launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import LONG_500K
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models.model import serve_capacity
    from repro_torch.train import server
    from repro_torch.utils import shard_hints
    from repro_torch.utils.device import index_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    if split:
        from repro_torch.models import attention

        attention.decode_self_attention = split_decode_in_process(torch,
                                                                  split)
    cfg = get_config("llama3.2-3b").with_(dtype=dtype)
    m = model_lib.build(cfg)
    cap = serve_capacity(cfg, LONG_500K.seq_len)
    params = m.init(torch.Generator(device="cuda").manual_seed(0),
                    device="cuda")
    prompt = torch.randint(0, cfg.vocab, (1, cap), device="cuda",
                           generator=index_generator(0, -1, "cuda"))
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        if dims is None:
            plain = server.make_serve_step(m, LONG_500K)
            span = None

            def prefill():
                return m.prefill(params, prompt)

            def step(c, t):
                return plain(params, c, t)
        else:
            mesh = warm_mesh(torch, mesh_lib.make_tiny_mesh(*dims))
            srv = server.shard_for_serving(m, params, mesh)
            del params
            span = srv.slot_span(1, cap)
            step = srv.make_serve_step(LONG_500K)

            def prefill():
                return srv.prefill(prompt)

        prefill()                                   # warm-up
        reset_counts()
        (logits, cache), pre_ms = sync_ms(torch, prefill, "cuda")
        k3 = read_counts()
        check(cache.pos == cap, f"prefill of {cap} left pos {cache.pos}")
        cache_gb = sum(local_of(t).numel() * local_of(t).element_size()
                       for t in cache.kv) / 1e9

        def whole(x):
            return local_of(x).float().cpu()        # replicated logits

        out, toks, ms, coll = [whole(logits)], [], [], []
        tok = torch.argmax(out[0][:, -1:, :], -1)
        # warm-up: the first step, whose write the timed one repeats
        step(cache, (tok if fed is None else fed[:, :1]).cuda())
        for i in range(LONG_STEPS):
            t_in = (tok if fed is None else fed[:, i:i + 1]).cuda()
            toks.append(t_in.cpu())
            c0 = shard_hints.counts()
            (_, lg, cache), t = sync_ms(torch, lambda: step(cache, t_in),
                                        "cuda")
            c1 = shard_hints.counts()
            coll.append(tuple(c1[k] - c0[k] for k in ("all_reduce",
                                                      "all_gather")))
            ms.append(t)
            out.append(whole(lg))
            tok = torch.argmax(out[-1][:, -1:, :], -1)
    return {"logits": out, "fed": torch.cat(toks, 1), "prefill_ms": pre_ms,
            "step_ms": ms, "collectives": coll, "cache_gb": cache_gb,
            "span": None if span is None else tuple(span),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "k3_launches": k3["flash_attention_wgmma"]
            + k3["flash_attention"]}


def long_context_cards(torch):
    """Phase 40e: llama3.2-3b batch 1 in ``long_500k``'s cache over
    ``LONG_MESHES`` of four cards, float32 and bf16, against one card's
    unsharded run fed the same tokens (:func:`long_context_rank`): every
    rank bitwise the others, float32 logits within 1e-4 of one card's max
    abs logit, 28 K3 launches a prefill, the ring wrapped into rank 0's
    slots, the cache a rank 1/4 of the whole, 113 all-reduces and 1
    all-gather a step (asserted); bf16 logged beside its floor, one card
    with the decode attention merged over 4 slot shards in one process (at
    28 layers of random bf16 weights any other rounding of the attention,
    the exact float32 one included, lands about 2e-2 from ``attend``'s);
    ms a step, collectives a step, cache GB a rank."""
    from repro_torch.launch import mesh as mesh_lib

    t0 = phase("40e. llama3.2-3b batch 1 in long_500k's cache (8192 slots) "
               f"over {LONG_MESHES[0]} and {LONG_MESHES[1]}")
    rec = {}
    for dtype in ("float32", "bfloat16"):
        one = mesh_lib.run_local(long_context_rank, 1, None, dtype, None,
                                 device="cuda", timeout=900)[0]
        rec[f"one_card {dtype}"] = {k: v for k, v in one.items()
                                    if k not in ("logits", "fed")}
        log(f"llama3.2-3b {dtype} batch 1, one card: prefill of 8192 "
            f"{one['prefill_ms']:.2f} ms, steps {fmt_ms(one['step_ms'])} "
            f"ms, cache {one['cache_gb']:.3f} GB, peak "
            f"{one['peak_gb']:.2f} GB, K3 {one['k3_launches']}")
        floor = None
        if dtype == "bfloat16":
            split = mesh_lib.run_local(long_context_rank, 1, None, dtype,
                                       one["fed"], 4, device="cuda",
                                       timeout=900)[0]
            floor = [rel_err(g, w) for g, w in zip(split["logits"],
                                                   one["logits"])]
            rec[f"one_card {dtype}"]["floor_rel_errs"] = floor
            log(f"llama3.2-3b {dtype} batch 1, one card, the attention "
                f"merged over 4 slot shards in one process: rel err "
                f"{[f'{e:.3e}' for e in floor]} (prefill, steps), the floor")
        for dims in LONG_MESHES:
            ranks = mesh_lib.run_local(long_context_rank, 4, dims, dtype,
                                       one["fed"], device="cuda",
                                       timeout=900)
            errs = [rel_err(g, w) for g, w in zip(ranks[0]["logits"],
                                                  one["logits"])]
            check(all(torch.equal(a, b) for r in ranks for a, b in
                      zip(r["logits"], ranks[0]["logits"])),
                  f"batch 1 {dtype} {dims}: the ranks' logits differ")
            check(all(bool(torch.isfinite(x).all()) for x in
                      ranks[0]["logits"]), f"batch 1 {dtype} {dims}: "
                                           f"logits not finite")
            # float32 is held to one card; bf16 is logged beside its floor
            if dtype == "float32":
                check(max(errs) < 1e-4, f"batch 1 {dtype} {dims}: {errs} "
                                        f"against one card")
            check(all(r["k3_launches"] == 28 for r in ranks),
                  f"batch 1 {dtype} {dims}: K3 launches "
                  f"{[r['k3_launches'] for r in ranks]}, expected 28")
            # a step: the embedding's all-reduce; a layer: wo's, down's and
            # the combine's max and sum over the one sequence axis; the
            # vocabulary gather
            check(all(r["collectives"] == [(1 + 4 * 28, 1)] * LONG_STEPS
                      for r in ranks), f"batch 1 {dtype} {dims}: "
                                       f"collectives {ranks[0]['collectives']}")
            check(ranks[0]["span"][0] == 0 and all(
                abs(r["cache_gb"] * 4 - one["cache_gb"]) < 1e-6
                for r in ranks), f"batch 1 {dtype} {dims}: spans "
                                 f"{[r['span'] for r in ranks]}, cache GB "
                                 f"{[r['cache_gb'] for r in ranks]}")
            rows = [{k: v for k, v in r.items() if k not in ("logits",
                                                             "fed")}
                    for r in ranks]
            rec[f"{dims} {dtype}"] = {"rel_errs": errs, "ranks": rows}
            log(f"llama3.2-3b {dtype} batch 1 over {dims}: rel err against "
                f"one card {[f'{e:.3e}' for e in errs]} (prefill, steps)"
                f"{'' if floor is None else ' beside the floor'}; "
                f"prefill {fmt_ms([r['prefill_ms'] for r in rows])} ms; "
                f"steps (rank 0) {fmt_ms(rows[0]['step_ms'])} ms; "
                f"collectives a step {rows[0]['collectives'][-1]}; cache "
                f"{rows[0]['cache_gb']:.3f} GB a rank (spans "
                f"{[r['span'][:2] for r in rows]}); peak "
                f"{fmt_ms([r['peak_gb'] for r in rows])} GB")
    RECORD["long_context_cards"] = rec
    done("batch 1 in long_500k's cache over four cards", t0)
    return rec


# ---------------------------------------------------------------------------
# phase 41: the sharded train step on a ("data", "model") mesh
# ---------------------------------------------------------------------------

# vision at 5 layers (one group of 4 dense layers and a cross layer), not
# phase 36's 10: two states of 10 layers (33.2 GB each) and the step's
# 30 GB above them (phase 36) do not fit one card
SHARD_TRAIN = (("llama3.2-3b", 8), (GRANITE, None), ("mamba2-130m", None),
               (ZAMBA, 13), (VISION, 5), (SEAMLESS, None))
SHARD_TRAIN_STEPS = 3
SHARD_TRAIN_PEAK = 1.05        # the sharded step's peak against the plain's
SHARD_TRAIN_MESHES = ((4, 1), (2, 2), (1, 4))   # llama3.2-3b on four cards
TRAIN_ACROSS_CARDS = "--sharded-train-across-cards"
K1_MAP_WINDOW = 2 ** 22


def shard_train_setup(torch, arch, n_layers):
    """The model (bf16, full width, cut to ``n_layers`` where given), the
    OTA train config (``TRAIN_AGENTS`` agents, bf16 wire) and the batches
    (B = ``TRAIN_BATCH``, S = ``TRAIN_SEQ``; the vlm and encdec families'
    with the memory stub of the tokens) of phase 41."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, memory_stub
    from repro_torch.models import model as model_lib

    cfg = get_config(arch).with_(dtype="bfloat16")
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    m = model_lib.build(cfg)
    tcfg = train_config("ota", SHARD_TRAIN_STEPS, lr=1e-4, warmup=2,
                        wire_dtype="bfloat16")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH), "cuda")
    batches = [data.batch(i) for i in range(SHARD_TRAIN_STEPS)]
    if model_lib.needs_memory(cfg):
        for b in batches:
            b["memory"] = memory_stub(cfg, b["tokens"], TRAIN_SEQ)
    return m, tcfg, batches


def local_state(state):
    """A sharded train state's local tensors, as a plain state."""
    from repro_torch.models.param import local_params

    st = state.opt_state
    return state._replace(params=local_params(state.params),
                          opt_state=st._replace(mu=local_params(st.mu),
                                                nu=local_params(st.nu)))


class StepRun(NamedTuple):
    state: object
    metrics: dict
    ms: float             # CUDA events around the step
    host_ms: float        # the host's time until the step returned
    peak_gb: float        # the step's peak above what was allocated before
    k1: int               # K1 launches
    k1_mapped: int        # of them with a counter map
    collectives: dict     # ``shard_hints.counts()``: what the model issued


def train_step_on_card(torch, step, state, batch):
    """One train step, timed and counted (a ``StepRun``)."""
    from repro_torch.kernels import ota_fused
    from repro_torch.utils import shard_hints

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    shard_hints.reset_counts()
    host = []

    def run():
        t = time.perf_counter()
        out = step(state, batch)
        host.append((time.perf_counter() - t) * 1e3)
        return out

    (state, met), ms = timed(torch, run)
    return StepRun(state, met, ms, host[0],
                   (torch.cuda.max_memory_allocated() - base) / 1e9,
                   read_counts()["ota_fused"], ota_fused.LAUNCHES_MAPPED,
                   shard_hints.counts())


def sharded_train_one(torch, mesh, arch, n_layers):
    """Phase 41 for one config on this rank: the plain step and the sharded
    step on a (1, 1) mesh from the same weights, in turns, the same
    batches and draws; params, moments and metrics bitwise, one (mapped)
    K1 launch a sharded step, ms and peak GB of each."""
    from repro_torch.train import trainer

    m, tcfg, batches = shard_train_setup(torch, arch, n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    plain = trainer.init_state(m, tcfg, device="cuda")
    sharded, step = trainer.shard_for_training(
        m, tcfg, trainer.init_state(m, tcfg, device="cuda"), mesh)
    plain_step = trainer.make_train_step(m, tcfg)
    rec = {k: [] for k in ("plain_ms", "ms", "plain_peak_gb", "peak_gb",
                           "metrics", "collectives")}
    k1 = mapped = 0
    for i, batch in enumerate(batches):
        p = train_step_on_card(torch, plain_step, plain, batch)
        plain = p.state
        check(p.k1 == 1, f"{arch}: the plain step made {p.k1} K1 launches")
        check(not any(p.collectives.values()),
              f"{arch}: the plain step issued collectives {p.collectives}")
        s = train_step_on_card(torch, step, sharded, batch)
        sharded = s.state
        check(s.k1 == 1 and s.k1_mapped == 1,
              f"{arch}: the sharded step made {s.k1} K1 launches "
              f"({s.k1_mapped} mapped), expected one mapped launch")
        check(state_equal(torch, plain, local_state(sharded)),
              f"{arch}: step {i}: the sharded state is not bitwise the "
              f"plain step's")
        check(all(torch.equal(p.metrics[k], s.metrics[k])
                  for k in p.metrics),
              f"{arch}: step {i}: metrics differ: {p.metrics} {s.metrics}")
        k1, mapped = k1 + s.k1, mapped + s.k1_mapped
        rec["plain_ms"].append(p.ms)
        rec["ms"].append(s.ms)
        rec["plain_peak_gb"].append(p.peak_gb)
        rec["peak_gb"].append(s.peak_gb)
        rec["metrics"].append({k: v.item() for k, v in s.metrics.items()})
        rec["collectives"].append(s.collectives)
    ratio = max(rec["peak_gb"]) / max(rec["plain_peak_gb"])
    check(ratio <= SHARD_TRAIN_PEAK,
          f"{arch}: the sharded step's peak {max(rec['peak_gb']):.2f} GB is "
          f"{ratio:.3f} x the plain step's")
    rec.update(peak_ratio=ratio, k1_launches=k1, k1_mapped=mapped,
               n_layers=m.cfg.n_layers,
               held_gb=torch.cuda.memory_allocated() / 1e9)
    del plain, sharded, step, plain_step, p, s
    gc.collect()
    torch.cuda.empty_cache()
    return rec


class Rank0Of22:
    """Rank 0 of a ("data", "model") (2, 2) mesh, for the layout alone
    (``models.param.shard_block`` reads these three)."""

    shape = {"data": 2, "model": 2}
    mesh_dim_names = ("data", "model")

    @staticmethod
    def get_coordinate():
        return [0, 0]


def k1_map_row(torch):
    """K1's mapped instance at llama3.2-3b's (full width and depth) rank-0
    row of a (2, 2) ``train_rules`` layout, the map built from the plan:
    its noise bitwise the unmapped launch's over the whole (1, d) row at
    the same elements and its plain version's, on windows (the first, one
    across each of two segment joins, the last); agg with noise over a
    random row (f32 and the bf16 wire) bitwise its plain version there;
    then timed against the unmapped launch of the same row, its byte bound,
    ``torch.mv`` and the plain version on a window."""
    from repro_torch.configs import get_config
    from repro_torch.core import ota
    from repro_torch.kernels import ota_fused, ref
    from repro_torch.models import model as model_lib
    from repro_torch.models.param import shard_block, spec_for, train_rules
    from repro_torch.utils.tree import flatten_paths

    mesh = Rank0Of22()
    decls = flatten_paths(flatten_paths(model_lib.build(
        get_config("llama3.2-3b")).plan))
    cmap = ota.shard_counter_map(
        [dc.shape for dc in decls.values()],
        [shard_block(dc.shape, spec_for(dc, train_rules(), mesh), mesh)
         for dc in decls.values()])
    d = sum(v.numel() for v in (torch.empty(dc.shape, device="meta")
                                for dc in decls.values()))
    n, w = cmap.n, K1_MAP_WINDOW
    table = cmap.table("cuda")
    offs = cmap.host[:, 0].tolist()
    joins = [o for o in offs[1:] if w // 2 <= o <= n - w // 2]
    windows = [(0, w)] + [(o - w // 2, o + w // 2) for o in joins[:2]] + \
        [(n - w, n)]
    ones = torch.ones(1, device="cuda")
    seed = 123457
    kw = dict(sigma=float(ref.f32(1e-3) / TRAIN_AGENTS),
              scale=1.0 / RAYLEIGH_MH, seed=seed, with_noise=True)
    idx = [ref.counter_map_index(table, n, lo, hi) for lo, hi in windows]
    whole = ota_fused.fused_aggregate(torch.zeros(1, d, device="cuda"), ones,
                                      sigma=1.0, scale=1.0, seed=seed)
    want_noise = [whole[i] for i in idx]
    del whole
    torch.cuda.empty_cache()
    noise = ota_fused.fused_aggregate(torch.zeros(1, n, device="cuda"), ones,
                                      sigma=1.0, scale=1.0, seed=seed,
                                      counter_map=cmap)
    for (lo, hi), i, wn in zip(windows, idx, want_noise):
        check(torch.equal(noise[lo:hi], wn),
              f"K1 mapped: noise of [{lo}, {hi}) not the unmapped (1, {d}) "
              f"launch's at the same elements")
        check(torch.equal(noise[lo:hi], ref.counter_noise_at(seed, i)),
              f"K1 mapped: noise of [{lo}, {hi}) not its plain version's")
    del noise, want_noise
    gen = torch.Generator(device="cuda").manual_seed(3)
    row = torch.randn(1, n, device="cuda", generator=gen)
    rows = {}
    for wire in ("f32", "bf16"):
        g = row.to(torch.bfloat16) if wire == "bf16" else row
        out = ota_fused.fused_aggregate(g, ones, counter_map=cmap, **kw)
        err = 0.0
        for (lo, hi), i in zip(windows, idx):
            want = ref.ota_fused_ref(g[:, lo:hi], ones,
                                     ref.counter_noise_at(seed, i),
                                     sigma=kw["sigma"], scale=kw["scale"])
            check(torch.equal(out[lo:hi], want),
                  f"K1 mapped {wire}: [{lo}, {hi}) not bitwise its plain "
                  f"version")
            err = max(err, (out[lo:hi] - want).abs().max().item())
        del out
        ms = device_ms(torch, lambda: ota_fused.fused_aggregate(
            g, ones, counter_map=cmap, **kw), iters=K1_ROW_TIMES, warmup=1,
            sleep_cycles=0)
        unmapped = device_ms(torch, lambda: ota_fused.fused_aggregate(
            g, ones, **kw), iters=K1_ROW_TIMES, warmup=1, sleep_cycles=0)
        vec = ones.to(g.dtype)
        lib = device_ms(torch, lambda: torch.mv(g.t(), vec),
                        iters=K1_ROW_TIMES, warmup=1, sleep_cycles=0)
        lo, hi = windows[-1]
        plain = device_ms(torch, lambda: ref.ota_fused_ref(
            g[:, lo:hi], ones, ref.counter_noise_at(seed, idx[-1]),
            sigma=kw["sigma"], scale=kw["scale"]), iters=K1_ROW_TIMES,
            warmup=1, sleep_cycles=0)
        bound, by = k1_bound(1, n, 2 if wire == "bf16" else 4, "agg")
        rows[wire] = {"A": 1, "P": n, "d": d, "segments": len(cmap),
                      "wire": wire, "ms": ms, "unmapped_ms": unmapped,
                      "bound_ms": bound, "bound_by": by, "library_ms": lib,
                      "plain_ms_window": plain, "window": hi - lo,
                      "max_abs_err": err}
        log(f"K1 mapped agg (1, {n}) {wire} wire, llama3.2-3b's rank-0 row "
            f"of (2, 2) ({len(cmap)} segments, d = {d}): {ms:.3f} ms "
            f"against {unmapped:.3f} ms unmapped; byte bound {bound:.3f} ms "
            f"({by}, {bound / ms:.1%} of it); torch.mv {lib:.3f} ms; plain "
            f"version on a {hi - lo} window {plain:.3f} ms; "
            f"{len(windows)} windows bitwise, noise bitwise the unmapped "
            f"launch's")
        del g
    del row
    # counters past 2^32 (zamba2-7b's rank rows at full depth) wrap modulo
    # 2^32: the kernel bitwise its plain version at such a map
    wrap = ota.shard_counter_map([(2 ** 33,)], [((2 ** 32 - 3000,),
                                                 (6000,))])
    g = torch.randn(1, wrap.n, device="cuda", generator=gen)
    got = ota_fused.fused_aggregate(g, ones, counter_map=wrap, **kw)
    want = ref.ota_fused_ref(g, ones, ref.counter_noise_at(
        seed, wrap.counters("cuda")), sigma=kw["sigma"], scale=kw["scale"])
    check(torch.equal(got, want), "K1 mapped: counters past 2^32 not "
                                  "bitwise its plain version")
    rows["wrap"] = {"n": wrap.n, "bitwise": True}
    log(f"K1 mapped agg (1, {wrap.n}) with counters from 2^32 - 3000 "
        f"wrapping modulo 2^32: bitwise its plain version")
    torch.cuda.empty_cache()
    return rows


def sharded_train_rank(mesh_unused):
    """Phase 41 on one nccl rank (``launch.mesh.run_local``)."""
    import torch

    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = warm_mesh(torch, mesh_lib.make_tiny_mesh(1, 1))
    out = {arch: sharded_train_one(torch, mesh, arch, n)
           for arch, n in SHARD_TRAIN}
    out["map"] = k1_map_row(torch)
    return out


def phase_sharded_train(torch):
    """Phase 41: the sharded train step (``train.trainer.
    shard_for_training``: FSDP over data, tensor parallelism over model,
    each data shard one agent) on a one-rank nccl (1, 1) mesh at full
    width, bf16, B=8 S=256, 4 agents: llama3.2-3b (cut to 8 layers, so
    two states fit beside a step), granite-moe-1b-a400m, mamba2-130m,
    zamba2-7b (13 layers), llama-3.2-vision-11b (5 layers) and
    seamless-m4t-large-v2 (the last two with the memory stub), 3 steps in
    turns with the plain step on the same weights and draws:
    params, moments and metrics bitwise, one mapped K1 launch a step, the
    step's peak within 1.05x the plain step's; then K1's mapped instance
    at a non-trivial map (``k1_map_row``)."""
    from repro_torch.launch import mesh as mesh_lib

    t0 = phase("41. the sharded train step: every family at full width "
               "on a (1, 1) nccl mesh, bitwise the plain step")
    gc.collect()
    torch.cuda.empty_cache()
    res = mesh_lib.run_local(sharded_train_rank, 1, device="cuda",
                             timeout=900)[0]
    for arch, _ in SHARD_TRAIN:
        r = res[arch]
        log(f"{arch} ({r['n_layers']} layers): sharded step "
            f"{fmt_ms(r['ms'])} ms (plain {fmt_ms(r['plain_ms'])}), step "
            f"peak {max(r['peak_gb']):.2f} GB above the held "
            f"{r['held_gb']:.2f} GB (plain {max(r['plain_peak_gb']):.2f}, "
            f"{r['peak_ratio']:.4f}x); {r['k1_launches']} K1 launches "
            f"({r['k1_mapped']} mapped); collectives a step "
            f"{r['collectives'][-1]}; params, moments and metrics "
            f"bitwise the plain step; loss "
            f"{[round(m['loss'], 4) for m in r['metrics']]}")
    RECORD["sharded_train"] = res
    done("sharded train", t0)
    return res


def layerwise_state(torch, m, tcfg, mesh):
    """A train state of ``layerwise_params`` (seed 0) on the ``mesh``
    under ``train_rules(fsdp=True)``, each rank drawing layer by layer and
    keeping its shards (a rank never holds the whole state), zero moments
    laid out alike, step 0."""
    from repro_torch.models.param import train_rules
    from repro_torch.train import trainer
    from repro_torch.utils.tree import flatten_paths

    params = layerwise_params(torch, m.plan, m.cfg.dtype, 0, "cuda", mesh,
                              train_rules(fsdp=True))
    return trainer.TrainState(
        params=params, opt_state=trainer.make_optimizer(tcfg).init(
            flatten_paths(params)), step=torch.zeros((), dtype=torch.int32))


def train_on_cards(torch, mesh, arch, n_layers=None, layerwise=False,
                   profile=True):
    """``arch`` at full width (``n_layers`` deep where given) on the
    ``mesh`` of this host's cards: the weights drawn whole on every rank
    (the same seed) and laid out, or (``layerwise``) drawn layer by layer,
    each rank keeping its shards; ``SHARD_TRAIN_STEPS`` sharded steps; ms a
    step, metrics, K1 launches, the collectives each step issued, the
    host's time until each step returned (the launches issued), GB held
    between steps and peak GB a rank; then (``profile``) one more step
    under the profiler: this rank's device time in kernels and copies, its
    share of the median step, the nccl kernels' part of it, the rest and
    the top kernels."""
    from repro_torch.train import trainer

    m, tcfg, batches = shard_train_setup(torch, arch, n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = (layerwise_state(torch, m, tcfg, mesh) if layerwise
             else trainer.init_state(m, tcfg, device="cuda"))
    state, step = trainer.shard_for_training(m, tcfg, state, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ms, host_ms, metrics, collectives = [], [], [], []
    for batch in batches:
        r = train_step_on_card(torch, step, state, batch)
        check(r.k1 == r.k1_mapped == 1,
              f"{arch} {tuple(mesh.shape)}: {r.k1} K1 launches "
              f"({r.k1_mapped} mapped), expected one mapped launch")
        state = r.state
        ms.append(r.ms)
        host_ms.append(r.host_ms)
        metrics.append({k: v.item() for k, v in r.metrics.items()})
        collectives.append(r.collectives)
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = {"arch": arch, "n_layers": m.cfg.n_layers, "ms": ms,
           "host_ms": host_ms, "metrics": metrics,
           "collectives": collectives, "held_gb": held, "peak_gb": peak}
    if profile:
        kernels, _, _ = device_kernels(torch, lambda: step(state,
                                                           batches[0]))
        # the profiler also puts each collective's "nccl:..." annotation on
        # the device's timeline, spanning its kernel: kernels and copies
        # only here
        kernels = [k for k in kernels if not k.key.startswith("nccl:")]
        nccl = [k for k in kernels if "nccl" in k.key.lower()]
        busy_us = sum(k.device_us for k in kernels)
        nccl_us = sum(k.device_us for k in nccl)
        ms_step = statistics.median(ms)
        out["profile"] = {
            "busy_ms": busy_us / 1e3, "busy_share": busy_us / (ms_step * 1e3),
            "nccl_ms": nccl_us / 1e3,
            "nccl_launches": sum(k.count for k in nccl),
            "compute_ms": (busy_us - nccl_us) / 1e3,
            "compute_share": (busy_us - nccl_us) / (ms_step * 1e3),
            "top": [{"kernel": k.key[:80], "ms": k.device_us / 1e3,
                     "calls": k.count} for k in kernels[:8]]}
    del state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_train_cards_rank(mesh_unused, dims, runs):
    """``train_on_cards`` of each ``(arch, n_layers, layerwise, profile)``
    of ``runs`` on one ``dims`` mesh of this host's cards."""
    import torch

    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = warm_mesh(torch, mesh_lib.make_tiny_mesh(*dims))
    return [train_on_cards(torch, mesh, *run) for run in runs]


TRAIN_ACROSS_ARCHS = ("llama3.2-3b", ZAMBA)
ZAMBA_CARD_MESHES = ((4, 1), (2, 2))
ZAMBA_CARD_CUT = 13            # the one-card cross-check's depth (phase 36's)


def check_cards(ranks, one, what):
    """Every rank's metrics bitwise the others'; loss, grad norm and update
    norm against ``one`` (a one-card run; None: none) within 2e-2."""
    check(all(r["metrics"] == ranks[0]["metrics"] for r in ranks),
          f"{what}: the ranks' metrics differ")
    if one is None:
        return None
    errs = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(
        ranks[0]["metrics"], one["metrics"]))
        for k in ("loss", "grad_norm", "update_norm")}
    check(max(errs.values()) < 2e-2, f"{what}: against one card {errs}")
    return errs


def log_cards(what, ranks, errs):
    log(f"{what}: {fmt_ms(ranks[0]['ms'])} ms a step; held "
        f"{fmt_ms([r['held_gb'] for r in ranks])} GB, peak "
        f"{fmt_ms([r['peak_gb'] for r in ranks])} GB a rank; metrics "
        f"bitwise across ranks"
        + ("" if errs is None else f"; against one card {errs}"))


def sharded_train_across_cards(only=()):
    """Phases 1 and 2, then, of ``only`` (default both): llama3.2-3b at
    full width and depth trained through the sharded step on one card's
    (1, 1) mesh and over four cards at (4, 1), (2, 2) and (1, 4), the same
    weights, batches and draws: every rank's metrics bitwise the same,
    loss, grad norm and update norm within 2e-2 of the one card's; ms a
    step, GB held and peak GB a rank, the collectives a step and a
    profiled step a rank.  zamba2-7b at full width and depth (81 layers,
    weights drawn layer by layer on each rank, its shards only) over (4, 1)
    and (2, 2), 3 steps: the same numbers and every rank's metrics
    bitwise; no card holds its whole train state, so the cross-check is
    the same mesh at 13 layers against one card's 13-layer step (2e-2)."""
    import torch

    from repro_torch.launch import mesh as mesh_lib

    only = tuple(only) or TRAIN_ACROSS_ARCHS
    check(set(only) <= set(TRAIN_ACROSS_ARCHS),
          f"{TRAIN_ACROSS_CARDS} takes {TRAIN_ACROSS_ARCHS}, got {only}")
    smi = phase_card(torch)
    phase_build()
    w = torch.cuda.device_count()
    check(w >= 4, f"{TRAIN_ACROSS_CARDS} needs four cards, found {w}")
    rec = {}
    if "llama3.2-3b" in only:
        t0 = phase("41b. llama3.2-3b trained over (4, 1), (2, 2) and (1, 4)")
        one = mesh_lib.run_local(sharded_train_cards_rank, 1, (1, 1), [
            ("llama3.2-3b", None, False, True)], device="cuda",
            timeout=900)[0][0]
        rec["(1, 1)"] = one
        log(f"llama3.2-3b (1, 1), one card: {fmt_ms(one['ms'])} ms a step, "
            f"{one['held_gb']:.2f} GB held, peak {one['peak_gb']:.2f} GB")
        log_train_profile("(1, 1)", 0, one)
        for dims in SHARD_TRAIN_MESHES:
            ranks = [r[0] for r in mesh_lib.run_local(
                sharded_train_cards_rank, 4, dims, [
                    ("llama3.2-3b", None, False, True)], device="cuda",
                timeout=900)]
            errs = check_cards(ranks, one, f"llama3.2-3b {dims}")
            rec[str(dims)] = {"ranks": ranks, "rel_err_vs_one_card": errs}
            log_cards(f"llama3.2-3b {dims}", ranks, errs)
            for i, r in enumerate(ranks):
                log_train_profile(str(dims), i, r)
        done("sharded train over four cards", t0)
    if ZAMBA in only:
        t0 = phase(f"41c. {ZAMBA} at full width and depth trained over "
                   f"{ZAMBA_CARD_MESHES[0]} and {ZAMBA_CARD_MESHES[1]}")
        one = mesh_lib.run_local(sharded_train_cards_rank, 1, (1, 1), [
            (ZAMBA, ZAMBA_CARD_CUT, True, False)], device="cuda",
            timeout=900)[0][0]
        zrec = {"(1, 1) cut": one}
        log(f"{ZAMBA} at {ZAMBA_CARD_CUT} layers, one card: "
            f"{fmt_ms(one['ms'])} ms a step, {one['held_gb']:.2f} GB held, "
            f"peak {one['peak_gb']:.2f} GB")
        for dims in ZAMBA_CARD_MESHES:
            full, cut = zip(*mesh_lib.run_local(
                sharded_train_cards_rank, 4, dims, [
                    (ZAMBA, None, True, False),
                    (ZAMBA, ZAMBA_CARD_CUT, True, False)],
                device="cuda", timeout=900))
            check_cards(full, None, f"{ZAMBA} {dims}")
            errs = check_cards(cut, one, f"{ZAMBA} {ZAMBA_CARD_CUT} layers "
                                         f"{dims}")
            zrec[str(dims)] = {"full": full, "cut": cut,
                               "rel_err_vs_one_card": errs}
            log_cards(f"{ZAMBA} {dims}, {full[0]['n_layers']} layers",
                      full, None)
            log_cards(f"{ZAMBA} {dims}, {ZAMBA_CARD_CUT} layers", cut, errs)
            for i, r in enumerate(full):
                log(f"  {dims} rank {i}: collectives a step "
                    f"{r['collectives'][-1]}; the host returned from the "
                    f"step after {fmt_ms(r['host_ms'])} ms")
        rec[ZAMBA] = zrec
        done(f"{ZAMBA} over four cards", t0)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sharded_train_cards.json").write_text(json.dumps(
        {"card": smi, "world": w, **rec, **RECORD}, indent=1, default=str))
    log(smi)
    return 0


def fmt_ms(xs):
    return "/".join(f"{x:.1f}" for x in xs)


def log_train_profile(mesh, rank, r):
    """One rank's collectives a step and its profiled step."""
    p = r["profile"]
    log(f"  {mesh} rank {rank}: collectives a step {r['collectives'][-1]}; "
        f"the host returned from the step after {fmt_ms(r['host_ms'])} ms; "
        f"profiled step: device busy {p['busy_ms']:.1f} ms "
        f"({p['busy_share']:.1%} of the median step), nccl kernels "
        f"{p['nccl_ms']:.1f} ms in {p['nccl_launches']} launches (their "
        f"wait for the other ranks included), the rest "
        f"{p['compute_ms']:.1f} ms ({p['compute_share']:.1%})"
        + ("; top kernels:" if rank == 0 else ""))
    if rank == 0:
        for t in p["top"]:
            log(f"    {t['ms']:8.2f} ms x{t['calls']:<5d} {t['kernel']}")


def theta_hist_equal(torch, a, b):
    (ta, ha), (tb, hb) = a, b
    return all(torch.equal(ta[k], tb[k]) for k in ta) and all(
        torch.equal(x, y) for x, y in zip(ha, hb))


def max_rel_dev(torch, a, b):
    """The largest relative difference of theta_K and the history fields."""
    (ta, ha), (tb, hb) = a, b
    pairs = [(ta[k], tb[k]) for k in ta] + list(zip(ha, hb))
    return max(float(((x.double() - y.double()).abs()
                      / y.double().abs().clamp(min=1e-6)).max())
               for x, y in pairs)


# ---------------------------------------------------------------------------
# Phase 45: the dry run against the card
# ---------------------------------------------------------------------------

# (c): pod-scale dry runs through the CLI, one process each, all at once
# after (a) and (b): FSDP with tensor parallelism, experts and K1 mapped
# (granite), a MoE prefill and an encdec decode.  ``--dryrun-against-card``
# adds the dense train steps, which trace for minutes (deepseek-67b's about
# 440 s of a host core).
DRYRUN_POD = (("granite-moe-1b-a400m", "train_4k"),
              ("mixtral-8x22b", "prefill_32k"),
              ("seamless-m4t-large-v2", "decode_32k"))
DRYRUN_POD_ALONE = DRYRUN_POD + (("llama3.2-3b", "train_4k"),
                                 ("deepseek-67b", "train_4k"))
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun_torch"
# s phase 45 waits for (c) at most: in the whole run, and alone
DRYRUN_POD_WAIT = {DRYRUN_POD: 60, DRYRUN_POD_ALONE: 700}
# the card's step peak over MemTracker's: 1.0001 on an H100 80GB HBM3 at
# 700 W (the caching allocator's 512-byte blocks); the band is set from it
DRYRUN_MEM_BAND = (0.99, 1.01)
DRYRUN_PREFILL = (("llama3.2-3b", "flash_attention_wgmma", 28),
                  ("mamba2-130m", "ssd_scan_tc", 24))
DRYRUN_ALONE = "--dryrun-against-card"


def start_pod_dryruns(combos):
    """Start phase 45(c): ``python -m repro_torch.launch.dryrun --arch A
    --shape S`` for each of ``combos``, each its own process (its own
    fake group of 256 ranks), writing to ``chiprun_out/dryrun_torch``.
    Returns ``(arch, shape, log file, start time, process)`` of each."""
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape in combos:
        logf = open(DRYRUN_OUT / f"{arch}_{shape}.log", "w")
        procs.append((arch, shape, logf, time.perf_counter(),
                      subprocess.Popen(
                          [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--out", str(DRYRUN_OUT)],
                          cwd=ROOT, env=env, stdout=logf,
                          stderr=subprocess.STDOUT)))
    return procs


def stop_pod_dryruns(procs):
    """Kill what is left of phase 45(c)'s processes."""
    for _, _, logf, _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        logf.close()


def dry_train_shape():
    from repro_torch.configs.base import InputShape

    return InputShape(name="train_b8_s256", seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, kind="train")


def dry_prefill_shape():
    from repro_torch.configs.base import InputShape

    return InputShape(name="prefill_b4_s2048", seq_len=SERVE_PROMPT,
                      global_batch=SERVE_BATCH, kind="prefill")


def dryrun_child(path):
    """Phase 45's dry runs of (a) and (b) on a fake (1, 1) group, in their
    own process (its fake group never meets the card's nccl group)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    arch, n_layers = SHARD_TRAIN[0]
    cfg = get_config(arch).with_(dtype="bfloat16", n_layers=n_layers)
    out = {"train": dryrun.run_one(
        arch, dry_train_shape(), mesh_shape="1x1", cfg=cfg, out_dir="",
        train_kw=dict(n_agents=TRAIN_AGENTS, lr=1e-4, warmup=2,
                      wire_dtype="bfloat16"))}
    for arch, _, _ in DRYRUN_PREFILL:
        out[arch] = dryrun.run_one(
            arch, dry_prefill_shape(), mesh_shape="1x1", out_dir="",
            cfg=get_config(arch).with_(dtype="bfloat16"))
    Path(path).write_text(json.dumps(out))
    return 0


def card_flops(torch, fn):
    """``fn()`` under ``FlopCounterMode``: (result, aten FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        out = fn()
    torch.cuda.synchronize()
    return out, fc.get_total_flops()


def dryrun_card_rank(mesh_unused):
    """Phase 45's card side on one nccl rank: (a) the sharded train step of
    phase 41 (llama3.2-3b at 8 layers) counted, then timed; (b) the sharded
    prefills of phase 10's cell, counted."""
    import torch

    from repro_torch.kernels import ota_fused
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    from repro_torch.train import server, trainer
    from repro_torch.utils.roofline import k1_cost, k3_cost, k4_cost
    from repro_torch.utils.tree import tree_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = warm_mesh(torch, mesh_lib.make_tiny_mesh(1, 1))
    arch, n_layers = SHARD_TRAIN[0]
    m, tcfg, batches = shard_train_setup(torch, arch, n_layers)
    state, step = trainer.shard_for_training(
        m, tcfg, trainer.init_state(m, tcfg, device="cuda"), mesh)
    st = state.opt_state
    out = {"arg_bytes": tree_bytes(state.params)
           + tree_bytes((st.mu, st.nu, st.step)),
           "batch_bytes": tree_bytes(batches[0])}
    state = train_step_on_card(torch, step, state, batches[0]).state  # warm
    reset_counts()
    state, aten = card_flops(torch, lambda: step(state, batches[1])[0])
    mapped = ota_fused.LAUNCHES_MAPPED
    # K1's row: every local element of the gradient, one unit-gain agent
    row = sum(v.to_local().numel() for v in st.mu.values())
    k1_f, _ = k1_cost(row, 1, wire_bytes=2, with_noise=True, mode="agg",
                      map_bytes=step.sharded.counter_map.host.numel() * 8)
    s = train_step_on_card(torch, step, state, batches[2])
    out["train"] = {"aten_flops": aten, "k1_mapped": mapped,
                    "k1_launches": read_counts()["ota_fused"],
                    "k1_flops": k1_f, "ms": s.ms, "host_ms": s.host_ms,
                    "peak_bytes": s.peak_gb * 1e9,
                    "timed_k1_mapped": s.k1_mapped}
    del state, step, s, batches
    gc.collect()
    torch.cuda.empty_cache()
    for arch, kernel, _ in DRYRUN_PREFILL:
        from repro_torch.configs import get_config

        m = model_lib.build(get_config(arch).with_(dtype="bfloat16"))
        params, prompt = model_and_prompt(torch, m, 45)
        srv = server.shard_for_serving(m, params, mesh)
        srv.prefill(prompt)                                   # warm
        reset_counts()
        _, aten = card_flops(torch, lambda: srv.prefill(prompt))
        cfg = m.cfg
        if kernel.startswith("flash"):
            per = k3_cost(SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads,
                          SERVE_PROMPT, SERVE_PROMPT, cfg.head_dim, 2,
                          causal=True, window=cfg.window)[0]
        else:
            d_in = cfg.ssm.expand * cfg.d_model
            per = k4_cost(SERVE_BATCH, SERVE_PROMPT, d_in // cfg.ssm.headdim,
                          cfg.ssm.headdim, cfg.ssm.n_groups, cfg.ssm.state,
                          cfg.ssm.chunk, 2, tensor_cores=True)[0]
        out[arch] = {"aten_flops": aten, "launches": read_counts(),
                     "kernel_flops_each": per}
        del m, params, prompt, srv
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dryrun_alone():
    """Phases 1, 2 and 45 alone (``--dryrun-against-card``)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 1
    smi = phase_card(torch)
    phase_build()
    res = phase_dryrun(torch, smi, DRYRUN_POD_ALONE)
    out = ROOT / "chiprun_out"
    (out / "dryrun_against_card.json").write_text(json.dumps(
        res, indent=1, default=str))
    return 0


def pod_dryruns(smi, combos):
    """Phase 45(c): the dry runs of ``combos`` on a fake ``pod16x16``, one
    process each, all at once; each must succeed within
    ``DRYRUN_POD_WAIT``.  Returns their records by ``"arch shape"`` and
    the seconds they took together."""
    pod = {}
    t_c = time.perf_counter()
    procs = start_pod_dryruns(combos)
    try:
        for arch, shape, logf, t_start, proc in procs:
            left = DRYRUN_POD_WAIT[combos] - (time.perf_counter() - t_c)
            try:
                rc = proc.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                rc = None
            logf.flush()
            log_text = (DRYRUN_OUT / f"{arch}_{shape}.log").read_text()
            check(rc == 0, f"(c) {arch} x {shape}: the dry run "
                           f"{'timed out' if rc is None else f'exited {rc}'}"
                           f": {log_text[-2000:]}")
            rec = json.loads((DRYRUN_OUT / f"{arch}_{shape}_pod16x16.json")
                             .read_text())
            pod[f"{arch} {shape}"] = rec
            log(f"(c) {arch} x {shape} x pod16x16: "
                f"{rec['memory']['total'] / 1e9:.3f} GB a rank (arguments "
                f"{rec['memory']['argument_total'] / 1e9:.3f}), dominant "
                f"{rec['roofline']['dominant']} (compute "
                f"{rec['roofline']['compute_s'] * 1e3:.2f} ms, memory "
                f"{rec['roofline']['memory_s'] * 1e3:.2f}, collectives "
                f"{rec['roofline']['collective_s'] * 1e3:.2f}), traced in "
                f"{rec['t_trace_s']:.1f} s "
                f"({time.perf_counter() - t_start:.1f} s since its start) "
                f"on the host [{smi}]")
    finally:
        stop_pod_dryruns(procs)
    seconds = time.perf_counter() - t_c
    log(f"(c): {seconds:.1f} s")
    return pod, seconds


def phase_dryrun(torch, smi, pod_combos=DRYRUN_POD):
    """Phase 45: the dry run (``launch/dryrun.py``) against the card.  (a)
    llama3.2-3b's sharded train step of phase 41 (bf16, 8 layers, B=8
    S=256, 4 agents, bf16 wire) on a one-rank nccl (1, 1) mesh against its
    dry run on a fake (1, 1) group: argument bytes equal, FLOPs equal
    (aten count plus each kernel's formula times its launches on both
    sides), one abstract K1 launch for the one mapped launch, the card's
    step peak within ``DRYRUN_MEM_BAND`` of MemTracker's; the measured ms a
    step beside the roofline's and the MFU; (b) the bf16 prefills of
    phase 10's cell (llama3.2-3b, mamba2-130m, B=4 S=2048): abstract K3/K4
    launches equal the card's (28, 24), FLOPs equal; (c) the pod-scale dry
    runs of ``pod_combos``, started together once (a) and (b) are done,
    must each succeed within ``DRYRUN_POD_WAIT``: bytes a rank, dominant
    term, trace seconds."""
    import multiprocessing as mp

    from repro_torch.launch import mesh as mesh_lib

    t0 = phase("45. dry run against the card")
    path = DRYRUN_OUT / "phase45_dry.json"
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    child = mp.get_context("spawn").Process(target=dryrun_child,
                                            args=(str(path),))
    child.start()
    try:
        card = mesh_lib.run_local(dryrun_card_rank, 1, device="cuda",
                                  timeout=600)[0]
    finally:
        child.join(timeout=300)
        if child.is_alive():
            child.kill()
    check(child.exitcode == 0, f"the dry-run process exited "
                               f"{child.exitcode}")
    dry = json.loads(path.read_text())
    res = {"card": card, "dry": dry, "nvidia_smi": smi}

    # (a) the train step
    d, c = dry["train"], card["train"]
    dry_args = (d["memory"]["argument_bytes"]["params"]
                + d["memory"]["argument_bytes"]["opt_state"])
    check(dry_args == card["arg_bytes"],
          f"argument bytes: dry run {dry_args}, card {card['arg_bytes']}")
    want = c["aten_flops"] + c["k1_flops"] * c["k1_mapped"]
    check(d["flops"]["total"] == want,
          f"train FLOPs: dry run {d['flops']['total']}, card {want} "
          f"(aten {c['aten_flops']} + K1 {c['k1_flops']} x "
          f"{c['k1_mapped']})")
    check(d["launches"]["by_name"] == {"ota_fused_mapped": 1}
          and c["k1_mapped"] == 1 == c["k1_launches"],
          f"K1: dry run {d['launches']}, card {c['k1_mapped']} mapped of "
          f"{c['k1_launches']}")
    mem_ratio = c["peak_bytes"] / d["memory"]["step_peak"]
    check(DRYRUN_MEM_BAND[0] <= mem_ratio <= DRYRUN_MEM_BAND[1],
          f"the card's step peak {c['peak_bytes'] / 1e9:.4f} GB is "
          f"{mem_ratio:.4f} x MemTracker's "
          f"{d['memory']['step_peak'] / 1e9:.4f} GB")
    r = d["roofline"]
    mfu = r["model_flops"] / (c["ms"] * 1e-3 * 989e12)
    log(f"(a) llama3.2-3b sharded train step, 8 layers, (1, 1): argument "
        f"bytes {dry_args} equal; FLOPs {d['flops']['total']:.6g} equal "
        f"(aten {c['aten_flops']:.6g} + K1 {c['k1_flops']:.6g}); 1 abstract "
        f"K1 launch = 1 mapped; step peak {c['peak_bytes'] / 1e9:.4f} GB on "
        f"the card against MemTracker's "
        f"{d['memory']['step_peak'] / 1e9:.4f} GB ({mem_ratio:.5f}x); "
        f"{c['ms']:.2f} ms a step (host {c['host_ms']:.2f}) against the "
        f"roofline's {r['step_time_s'] * 1e3:.3f} ms ({r['dominant']}), MFU "
        f"{mfu:.4f} of 989 TFLOP/s; dry run traced in {d['t_trace_s']:.1f} "
        f"s [{smi}]")
    res["train_mfu"] = mfu
    res["train_mem_ratio"] = mem_ratio

    # (b) the prefills
    for arch, kernel, n in DRYRUN_PREFILL:
        d, c = dry[arch], card[arch]
        got = c["launches"][kernel]
        check(d["launches"]["by_name"] == {kernel: n} and got == n,
              f"{arch} prefill: dry run {d['launches']['by_name']}, card "
              f"{got} {kernel}, expected {n}")
        want = c["aten_flops"] + c["kernel_flops_each"] * got
        check(d["flops"]["total"] == want,
              f"{arch} prefill FLOPs: dry run {d['flops']['total']}, card "
              f"{want}")
        log(f"(b) {arch} prefill B={SERVE_BATCH} S={SERVE_PROMPT}: {n} "
            f"{kernel} launches on both sides; FLOPs "
            f"{d['flops']['total']:.6g} equal; roofline "
            f"{d['roofline']['step_time_s'] * 1e3:.3f} ms "
            f"({d['roofline']['dominant']}) [{smi}]")

    res["ab_seconds"] = time.perf_counter() - t0
    log(f"(a) and (b): {res['ab_seconds']:.1f} s")

    # (c) the pod-scale dry runs
    pod, res["c_seconds"] = pod_dryruns(smi, pod_combos)
    res["pod"] = {k: {"memory": v["memory"], "roofline": v["roofline"],
                      "t_trace_s": v["t_trace_s"]} for k, v in pod.items()}
    RECORD["dryrun"] = res
    done("dry run", t0)
    return res


ANALYZE_WAIT = 150             # s: the analyzer's subprocess, all contracts
ANALYZE_ALONE = "--analyze-against-card"


def wire_at_full_width(torch, leaves):
    """Phase 46(c): ``ota.add_awgn`` on a gradient of ``leaves`` (phase
    27's llama3.2-3b leaves: bf16, the norm scales float32) with the bf16
    wire and the native one,
    under an op recorder and a launch log; the index of each K1 launch in
    the op list splits the row's ops from the update's."""
    from repro_torch.analyze.contracts import narrowing_ops
    from repro_torch.core import ota
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.kernels import abstract, ota_fused
    from repro_torch.utils.optrace import OpRecorder

    gen = torch.Generator(device="cuda").manual_seed(46)
    grad = {f"leaf{i:04d}": torch.randn(shape, generator=gen, device="cuda",
                                        dtype=getattr(torch, dtype))
            for i, (shape, dtype) in enumerate(leaves)}
    d = sum(v.numel() for v in grad.values())
    n_f32 = sum(v.dtype == torch.float32 for v in grad.values())
    f32_numel = sum(v.numel() for v in grad.values()
                    if v.dtype == torch.float32)
    rows = {}
    for wire in ("bfloat16", ""):
        cfg = ota.OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True,
                            wire_dtype=wire)
        at = []
        orig = ota_fused.fused_aggregate

        def marked(*a, **k):
            at.append(len(rec.ops))
            return orig(*a, **k)

        torch.cuda.synchronize()
        ta = time.perf_counter()
        ota_fused.fused_aggregate = marked
        try:
            with abstract.launch_log() as launches, OpRecorder() as rec:
                out = ota.add_awgn(cfg, 123457, grad, TRAIN_AGENTS,
                                   backend="cuda")
        finally:
            ota_fused.fused_aggregate = orig
        torch.cuda.synchronize()
        secs = time.perf_counter() - ta
        check(all(torch.isfinite(v).all().item() for v in out.values()),
              f"add_awgn ({wire or 'native'} wire): a non-finite update")
        del out
        tag = wire or "native"
        pre = narrowing_ops(rec.ops[:at[0]]) if at else None
        post = narrowing_ops(rec.ops) if at else None
        rows[tag] = {"d": d, "launches": [l._asdict() for l in launches],
                     "aten_narrowing_of_row": pre,
                     "aten_narrowing_after_launch": len(post) - len(pre)
                     if at else None, "ops": len(rec.ops), "seconds": secs}
        want = "bfloat16" if wire else "float32"
        check(len(launches) == 1 and not launches[0].abstract
              and launches[0].wire == want
              and launches[0].shape == (1, d),
              f"add_awgn ({tag} wire) at d = {d}: launches {launches}, "
              f"expected one real (1, d) K1 launch read in {want}")
        # the only narrowing before the launch is the wire hop itself:
        # each float32 leaf (the norm scales) read in bf16, as K1 reads
        # the bf16 leaves; with the native wire, none
        hop = [("float32", "bfloat16")] * n_f32 if wire else []
        check(pre == hop, f"add_awgn ({tag} wire) at d = {d}: aten "
                          f"narrowed the row before K1: {pre}, expected "
                          f"the wire hop {hop} alone")
        log(f"add_awgn at d = {d} ({tag} wire): one K1 launch "
            f"{launches[0].shape} read in {launches[0].wire}; aten "
            f"narrowing of the row: {len(pre)} (the wire hop of the "
            f"{n_f32} float32 leaves, {f32_numel} elements)"
            if wire else
            f"add_awgn at d = {d} ({tag} wire): one K1 launch "
            f"{launches[0].shape} read in {launches[0].wire}; aten "
            f"narrowing of the row: none")
        log(f"    {len(rec.ops)} aten ops, "
            f"{rows[tag]['aten_narrowing_after_launch']} of them the "
            f"update's casts back to the leaves' dtype; {secs:.2f} s")
    del grad
    torch.cuda.empty_cache()
    return rows


def phase_analyze(torch):
    """Phase 46: ``repro_torch.analyze`` on the card (module docstring)."""
    from repro_torch.analyze import contracts
    from repro_torch.analyze.findings import Report
    from repro_torch.kernels import abstract

    t0 = phase("46. the static contract checker on the card")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    res = {}
    # (a) the CLI, every contract on the cuda backend
    report_path = out / "analyze_torch_report.json"
    ta = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analyze", "--strict", "--json",
         str(report_path)], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        timeout=ANALYZE_WAIT)
    res["cli_seconds"] = time.perf_counter() - ta
    log(proc.stdout[-2000:])
    check(proc.returncode == 0,
          f"python -m repro_torch.analyze --strict exited "
          f"{proc.returncode}:\n{proc.stdout[-6000:]}\n{proc.stderr[-6000:]}")
    rep = json.loads(report_path.read_text())
    check(not rep["findings"] and not rep["skipped"],
          f"the analyzer on the card: findings {rep['findings']}, skipped "
          f"{rep['skipped']}")
    res["cli"] = {"counts": rep["counts"],
                  "files_scanned": rep["files_scanned"]}
    log(f"(a) python -m repro_torch.analyze --strict: exit 0 in "
        f"{res['cli_seconds']:.1f} s; {rep['counts']}, nothing skipped")
    # the wire-dtype contract in-process: its K1 launches are real
    with abstract.launch_log() as launches:
        r = Report()
        contracts.check_wire_dtype(r, device="cuda")
    check(not r.findings, f"wire-dtype on the card: {r.findings}")
    check(launches and not any(x.abstract for x in launches),
          f"wire-dtype on the card: launches {launches}")
    res["wire_dtype_launches"] = {
        w: sum(x.wire == w for x in launches)
        for w in sorted({x.wire for x in launches})}
    log(f"    wire-dtype in-process: {len(launches)} real K1 launches by "
        f"wire {res['wire_dtype_launches']}")
    # (b) host syncs a round
    counts = contracts.sync_counts(torch.device("cuda"))
    r = Report()
    contracts.judge_syncs(r, counts)
    check(not r.findings, f"host syncs: {[f.message for f in r.findings]}")
    res["syncs_per_round"] = counts
    for label, per_round in counts.items():
        log(f"(b) host syncs a round, {label}: {per_round}")
    if "train_syncs" in RECORD:
        res["syncs_train_step_llama"] = RECORD["train_syncs"]
        log(f"    llama3.2-3b OTA train step (phase 27's state): "
            f"{RECORD['train_syncs']}")
    # (c) the wire at full width
    if "train_leaves" in RECORD:
        res["wire_full_width"] = wire_at_full_width(torch,
                                                    RECORD["train_leaves"])
    RECORD["analyze"] = res
    done("analyze", t0)
    return res


def analyze_alone():
    """Phases 1, 2, 27 and 46 alone (``--analyze-against-card``)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 1
    smi = phase_card(torch)
    phase_build()
    phase_train(torch)
    res = phase_analyze(torch)
    out = ROOT / "chiprun_out"
    (out / "analyze_against_card.json").write_text(json.dumps(
        {"card": smi, **res, "phase_seconds": RECORD["phase_seconds"]},
        indent=1, default=str))
    log(smi)
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch import figures  # fails outside a checkout

    t_all = time.perf_counter()
    smi = phase_card(torch)
    phase_build()
    k1_err = phase_k1(torch)
    launches, main_res = phase_main(torch)
    fig12_rows = phase_fig12(torch)
    rows = phase_times(torch)
    phase_profile(torch, main_res["alg2"]["ms_per_round"])
    k3_err = phase_k3(torch)
    k4_err = phase_k4(torch)
    llama, mamba = phase_serve(torch)
    k3, k4 = phase_k34_times(torch)
    phase_serve_profile(torch, llama, mamba)
    llama, mamba = llama[0], mamba[0]   # free the served models' weights
    torch.cuda.empty_cache()
    k2_launches = phase_k2(torch)
    k2_rows = phase_k2_times(torch)
    phase_streamed(torch)
    phase_large_fleet(torch)
    phase_power_control(torch)
    service_rows = phase_service(torch)
    large_rows, k1_large = phase_service_large(torch)
    phase_et(torch)
    zoo_rows = phase_zoo(torch)
    phase_lanes(torch)
    _, lane_rows = phase_batching(
        torch, main_res["alg2"]["ms_per_round"])
    phase_telemetry(torch)
    driver = phase_driver(torch, service_rows)
    train = phase_train(torch)
    phase_resume(torch)
    stream_rows, fold_rows = phase_streamed_lanes(torch)
    sharded_k1 = phase_sharded(torch)
    mesh = phase_agent_mesh(torch)
    granite = phase_granite_serve(torch)
    fam = {arch: phase_family_train(torch, arch, n)
           for arch, n in ((GRANITE, 33), ("mamba2-130m", 34))}
    fam_serve = phase_family_serve(torch)
    for arch, depth in FAMILY_TRAIN_DEPTH.items():
        fam[arch] = phase_family_train(torch, arch, 36, depth)
    fig3_rows = phase_fig3(torch)
    fig45_rows, floor_k1 = phase_fig45(torch)
    theory_rows = phase_theory(torch)
    sharded = phase_sharded_serve(torch)
    sharded_train = phase_sharded_train(torch)
    pc_parts = phase_power_control_held(torch)
    zoo_parts = phase_zoo_held(torch)
    part_parts, driver_k1 = phase_participation_held(torch)
    phase_dryrun(torch, smi)
    phase_analyze(torch)
    train_phase = {GRANITE: "33", "mamba2-130m": "34", ZAMBA: "36",
                   VISION: "36", SEAMLESS: "36"}
    RECORD["seconds"] = time.perf_counter() - t_all

    # K1's two bodies.  The wide body runs the main path (Algorithm 2 at
    # the paper's width: fused sgd at (10, 165), phase 4's launches); the
    # tall body runs this slice's path, the stacked round at N = 10^4
    # (phase 20's stacked service rounds, counted there) and is timed at
    # its shape, agg (10^4, 165), beside the wide body in the same run.
    main_row = rows[0]   # (10, 165) f32
    sgd_bound, sgd_by = k1_bound(main_row["A"], main_row["P"], 4, "sgd")
    big_row = next(r for r in rows
                   if (r["A"], r["P"], r["wire"]) == (10_000, 165, "f32"))
    per_path = {
        "service stacked (10, 165)":
            service_rows[0]["stacked"]["k1_per_round"],
        "service streamed, agent_blocks 1, staleness (10, 165)":
            service_rows[1]["streamed_1"]["k1_per_round"],
        "service stacked (10^4, 165)":
            large_rows[0]["stacked"]["k1_per_round"],
        "service streamed in 64s, staleness (10^4, 165)":
            large_rows[1]["streamed"]["k1_per_round"],
        "zoo, each family": zoo_rows[0]["k1_launches"] / ZOO_ROUNDS,
        f"sweep lanes, {FIG12_RUNS} runs ({FIG12_RUNS}, 10, 165)":
            fig12_rows[2]["k1_launches"] / FIG12_ROUNDS,
        "round-service driver (10, 165)":
            driver["paper"]["k1_launches"] / DRIVER_ROUNDS,
        "OTA train step, llama3.2-3b (1, d)":
            train["k1_launches"] / TRAIN_STEPS,
        f"streamed lanes in {STREAMED_LANE_BLOCKS}s, R = "
        f"{STREAMED_LANE_RUNS[-1]} (10, 165)": stream_rows[-1]["k1_per_round"],
        f"sweep vmap, streamed + budget partitions, {SHARDED_ROUNDS} rounds":
            sharded_k1 / SHARDED_ROUNDS,
        "agent mesh, one rank, stacked (10, 165): fold + tail":
            mesh["forms"]["stacked"]["k1_per_round_mesh"][0],
        f"agent mesh, one rank, streamed in {MESH_BLOCKS}s (10, 165)":
            mesh["forms"]["streamed"]["k1_per_round_mesh"][0],
        f"agent mesh, one rank, service streamed in {MESH_BLOCKS}s":
            mesh["forms"]["service"]["k1_per_round_mesh"][0],
        "psum train step, llama3.2-3b, one rank (1, d)":
            mesh["train"]["k1_per_step"],
        f"OTA train step, {GRANITE} (1, d)":
            fam[GRANITE]["k1_launches"] / FAMILY_TRAIN_STEPS,
        f"psum train step, {GRANITE}, one rank (1, d)":
            fam[GRANITE]["psum"]["rows"]["psum"][0]["k1"],
        **{f"OTA train step, {arch} at {fam[arch]['n_layers']} layers "
           f"(1, d)": fam[arch]["k1_launches"] / FAMILY_TRAIN_STEPS
           for arch in ("mamba2-130m", ZAMBA, VISION, SEAMLESS)},
        f"ET's OTA partition, {ET_REF_RUNS} lanes (20, 165)":
            RECORD["et"][0]["k1_launches"] / RECORD["et"][0]["rounds"],
        **{f"Fig. 3 {r['tag']} partition, {FIG_RUNS} lanes":
           r["k1_launches"] / FIG3_ROUNDS for r in fig3_rows},
        **{f"Figs. 4-5 {r['tag']} partition, {FIG_RUNS} lanes":
           r["k1_launches"] / FIG45_ROUNDS for r in fig45_rows},
        "Lemma-3 floor, a draw (10, 165)":
            floor_k1 / (4 * FLOOR_CLAIM_DRAWS),
        **{f"Theorem {r['theorem']} {r['tag']} partition, {FIG_RUNS} lanes "
           f"(8, 6)": r["k1_launches"] / THEORY_ROUNDS for r in theory_rows},
        **{f"power control partition {r['tags']}, {r['lanes']} lanes (8, 6)":
           r["k1_launches"] / PC_ROUNDS for r in pc_parts},
        **{f"zoo partition {r['tags']}, {r['lanes']} lanes":
           r["k1_launches"] / ZOO_REF_ROUNDS for r in zoo_parts},
        **{f"participation {key}, {r['lanes']} lanes, streamed in "
           f"{LARGE_SERVICE_BLOCKS}s (10^4, 165)":
           r["k1_launches"] / figures.PART_ROUNDS
           for key, r in part_parts.items()},
        "participation driver, streamed in 64s, staleness (10^4, 165)":
            driver_k1}
    kernels = {"kernels": [{
        "name": "ota_fused_wide", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ota_fused.cu",
        "replaces": "src/repro/kernels/ota_fused.py:85",
        "parity": "ok", "launches": launches,
        "launches_from": "Algorithm 2, K=100, (10, 165) (phase 4)",
        "max_abs_err": k1_err["wide"],
        "ms": main_row["sgd_ms"], "plain_ms": main_row["plain_sgd_ms"],
        "bound_ms": sgd_bound, "bound_by": sgd_by,
        "library_ms": main_row["library_ms"],
        "shape": [main_row["A"], main_row["P"]], "mode": "sgd",
        "timings": rows, "sweep": RECORD["k1_sweep"],
        "lane_timings": lane_rows,
        "stream_fold_lane_timings": fold_rows,
        "launches_per_round_by_path": per_path,
        "train_row": dict(train["k1_row"]["bf16"],
                          launches=train["k1_launches"],
                          launches_from=f"{TRAIN_STEPS} OTA train steps, "
                                        f"llama3.2-3b (phase 27)"),
        "train_row_f32": train["k1_row"]["f32"],
        "mapped_row": dict(
            sharded_train["map"]["bf16"],
            launches=sum(sharded_train[a]["k1_mapped"]
                         for a, _ in SHARD_TRAIN),
            launches_from=f"{SHARD_TRAIN_STEPS} sharded train steps of "
                          f"each of {[a for a, _ in SHARD_TRAIN]} on a (1, "
                          f"1) mesh (phase 41)"),
        "mapped_row_f32": sharded_train["map"]["f32"],
        "train_rows_by_arch": {
            arch: dict(r["k1_row"]["bf16"], launches=r["k1_launches"],
                       launches_from=f"{FAMILY_TRAIN_STEPS} OTA train "
                                     f"steps, {arch} at {r['n_layers']} "
                                     f"layers (phase {train_phase[arch]})")
            for arch, r in fam.items()}}, {
        "name": "ota_fused_tall", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ota_fused.cu",
        "replaces": "src/repro/kernels/ota_fused.py:85",
        "parity": "ok",
        "launches": sum(r["stacked"]["k1_tall_launches"] for r in large_rows),
        "launches_from": "stacked service rounds at N = 10^4 (phase 20)",
        "driver_launches": driver["large"]["k1_tall_launches"],
        "max_abs_err": k1_err["tall"],
        "ms": big_row["agg_ms"]["tall"], "plain_ms": big_row["plain_agg_ms"],
        "bound_ms": big_row["bound_ms"], "bound_by": big_row["bound_by"],
        "library_ms": big_row["library_ms"],
        "shape": [big_row["A"], big_row["P"]], "mode": "agg",
        "ms_wide_body": big_row["agg_ms"]["wide"],
        "service_shape_timing": k1_large}]}
    k2_row = k2_rows[-1]  # (2^26,) float32: past the L2, the bound's shape
    kernels["kernels"].append({
        "name": "ota_channel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ota_channel.cu",
        "replaces": "src/repro/kernels/ota_channel.py:40", "parity": "ok",
        "launches": k2_launches,
        "max_abs_err": RECORD["k2_parity"]["max_abs_err"],
        "ms": k2_row["ms"], "plain_ms": k2_row["plain_ms"],
        "bound_ms": k2_row["bound_ms"], "bound_by": k2_row["bound_by"],
        "library_ms": None, "shape": k2_row["shape"], "timings": k2_rows})
    # K3 and K4: the tensor-core kernels run the bf16 prefills; PR 12's
    # f32-core kernels run the float32 prefills (their launches are counted
    # there) and are timed on the bf16 serve inputs beside the new ones
    for name, src, body, res, err, t, new in (
            ("flash_attention_wgmma", "flash_attention_wgmma.cu",
             "flash_attention.py:33", llama, k3_err, k3, True),
            ("flash_attention", "flash_attention.cu", "flash_attention.py:33",
             llama, k3_err, k3, False),
            ("ssd_scan_tc", "ssd_scan_tc.cu", "ssd_scan.py:33", mamba, k4_err,
             k4, True),
            ("ssd_scan", "ssd_scan.cu", "ssd_scan.py:33", mamba, k4_err, k4,
             False)):
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{body}", "parity": "ok",
            "launches": res["launches" if new else "launches_f32"][name],
            "launches_from": ("bf16 prefill" if new else "float32 prefill"),
            "max_abs_err": max(err[name].values()),
            "max_abs_err_by_dtype": err[name],
            "ms": t["ms" if new else "ms_pr12_kernel"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"]})
        # the hybrid, vlm and encdec prefills (phase 35), their launches
        # counted there and the kernel timed at their shapes in phase 12
        for arch, rows in (
                [(VISION, [t[VISION]]),
                 (SEAMLESS, [t[SEAMLESS], t[SEAMLESS + " decoder"]])]
                if name.startswith("flash_attention") else [(ZAMBA,
                                                             [t[ZAMBA]])]):
            r = fam_serve[arch]
            entry = {
                "launches": r["launches" if new else "launches_f32"][name],
                "launches_from": (
                    "bf16 prefill (phase 35)" if new else
                    f"float32 prefill at {r['f32_layers']} layers (phase "
                    f"35)"),
                "timings": [{
                    "what": row.get("what", "prefill"), "shape": row["shape"],
                    **({"causal": row["causal"]} if "causal" in row else {}),
                    "ms": row["ms" if new else "ms_pr12_kernel"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                    **({"max_abs_err": row["max_abs_err"]}
                       if new and "max_abs_err" in row else {})}
                    for row in rows]}
            if name.startswith("flash_attention"):
                entry["bidirectional_launches"] = r[
                    "bidirectional_launches" if new
                    else "bidirectional_launches_f32"][name]
            kernels["kernels"][-1][f"{arch} prefill"] = entry
        if name.startswith("flash_attention"):
            # this slice's path: granite's prefill (Dh = 64), its launches
            # counted there and the kernel timed at its shape in phase 12
            g = t["granite"]
            kernels["kernels"][-1][f"{GRANITE} prefill"] = {
                "launches": granite["launches" if new else "launches_f32"][
                    name],
                "launches_from": ("bf16 prefill (phase 32)" if new
                                  else "float32 prefill (phase 32)"),
                "ms": g["ms" if new else "ms_pr12_kernel"],
                "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
                "bound_by": g["bound_by"], "library_ms": g["library_ms"],
                "shape": g["shape"],
                **({"max_abs_err": g["max_abs_err"]} if new else {})}
    # phase 40: the sharded prefill's launches on its one rank
    for entry in kernels["kernels"]:
        for key, r in sharded.items():
            if r["kernel"] == entry["name"]:
                entry[f"sharded prefill on a (1, 1) mesh, {key}"] = {
                    "launches": r["launches"],
                    "launches_from": "one sharded prefill, one rank "
                                     "(phase 40)",
                    "prefill_ms": r["prefill_ms"],
                    "plain_prefill_ms": r["plain_prefill_ms"]}
    RECORD["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    log(f"\ntotal {RECORD['seconds']:.1f} s")
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


MESH_ACROSS_CARDS = "--agent-mesh-across-cards"


def mesh_across_cards():
    """Phase 31's mesh over every visible card alone (no psum step), then
    the card test of the mesh over every card: the one path that needs
    several cards, for a machine with two or more."""
    import torch

    from repro_torch.launch import mesh as mesh_lib

    smi = phase_card(torch)
    phase_build()
    w = torch.cuda.device_count()
    check(w > 1, f"{MESH_ACROSS_CARDS} needs two or more cards, found {w}")
    t0 = phase(f"31. agent mesh over {w} cards")
    rec = check_mesh_world(torch, w, mesh_lib.run_local(
        mesh_rank, w, False, device="cuda", timeout=600))
    done("agent mesh", t0)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "agent_mesh_cards.json").write_text(json.dumps(
        {"card": smi, "world": w, **rec}, indent=1, default=str))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         str(ROOT / "tests" / "test_torch_cuda.py"), "-k",
         "agent_mesh_over_every_card"], timeout=600).returncode


SERVE_ACROSS_ARCHS = ("llama3.2-3b", DEEPSEEK, VISION)
VISION_CARD_MESHES = ((1, 4), (2, 2))


def vision_serve_rank(mesh_unused, dims, dtype, fed):
    """llama-3.2-vision-11b at full width and depth in ``dtype`` from
    ``layerwise_params`` over a ``dims`` mesh of this host's cards (None:
    unsharded on this rank's card, in bf16 with the noise floor), fed
    ``fed`` (None: greedy)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = None if dims is None else warm_mesh(
        torch, mesh_lib.make_tiny_mesh(*dims))
    return layerwise_serve(torch, get_config(VISION).with_(dtype=dtype), mesh,
                           "cuda", fed=fed,
                           floor=dims is None and dtype == "bfloat16")


def sharded_across_cards(only=()):
    """Phases 1 and 2, then, of ``only`` (default all three): phase 40
    (llama3.2-3b over (1, 4) and (2, 2) against one rank) and 40e
    (llama3.2-3b batch 1 in ``long_500k``'s sequence-sharded cache over (4,
    1) and (2, 2), :func:`long_context_cards`); deepseek-67b at
    full width over (1, 4) (prefill B=4 S=2048, 4 decode steps: ms, peak
    GB a rank, finite logits) and cut to ``DEEPSEEK_CUT`` layers against
    one card's unsharded run; llama-3.2-vision-11b at full width and depth
    (weights drawn layer by layer, each rank keeping its shards) over (1,
    4) and (2, 2), fed one card's unsharded greedy tokens, in float32
    within 1e-4 of that card's max abs logit (asserted) and in bf16 beside
    the one card's noise floor (logged); then K3 and K4 at the ranks'
    local prefill shapes (as phase 12) and, with no ``only``, the card
    test of the sharded serve over every card: the paths that need four
    cards, for a machine with four."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib

    only = tuple(only) or SERVE_ACROSS_ARCHS
    check(set(only) <= set(SERVE_ACROSS_ARCHS),
          f"{SHARDED_ACROSS_CARDS} takes {SERVE_ACROSS_ARCHS}, got {only}")
    smi = phase_card(torch)
    phase_build()
    w = torch.cuda.device_count()
    check(w >= 4, f"{SHARDED_ACROSS_CARDS} needs four cards, found {w}")
    if "llama3.2-3b" in only:
        phase_sharded_serve(torch)
        long_context_cards(torch)
    if DEEPSEEK in only:
        t0 = phase(f"40b. {DEEPSEEK} at full width over a (1, 4) nccl mesh")
        ranks = mesh_lib.run_local(deepseek_rank, 4, get_config(DEEPSEEK),
                                   "cuda", device="cuda", timeout=1200)
        errs = check_deepseek(torch, ranks)
        rec = {"cut_rel_err": errs,
               "cut_plain": {k: v for k, v in ranks[0]["cut_plain"].items()
                             if k not in ("logits", "fed")}}
        for name in ("full", "cut"):
            rec[name] = [{k: v for k, v in r[name].items()
                          if k not in ("logits", "fed")} for r in ranks]
            for r in rec[name]:
                log(f"{DEEPSEEK} {name} ({r['n_layers']} layers) over (1, "
                    f"4): init {r['init_ms']:.0f} ms, prefill "
                    f"{r['prefill_ms']:.2f} ms, decode {r['decode_ms']:.2f} "
                    f"ms a step, peak {r['peak_gb']:.2f} GB, K3 "
                    f"{r['k3_launches']} a prefill")
        p = rec["cut_plain"]
        log(f"{DEEPSEEK} cut, one card unsharded: prefill "
            f"{p['prefill_ms']:.2f} ms, decode {p['decode_ms']:.2f} ms, peak "
            f"{p['peak_gb']:.2f} GB; sharded against it {max(errs):.3e} of "
            f"the max abs logit")
        RECORD["deepseek"] = rec
        done("deepseek", t0)
    if VISION in only:
        t0 = phase(f"40d. {VISION} at full width and depth over "
                   f"{VISION_CARD_MESHES[0]} and {VISION_CARD_MESHES[1]}")
        rec = {}
        for dtype in ("bfloat16", "float32"):
            one = mesh_lib.run_local(vision_serve_rank, 1, None, dtype, None,
                                     device="cuda", timeout=900)[0]
            rec[f"one_card {dtype}"] = {k: v for k, v in one.items()
                                        if k not in ("logits", "fed")}
            log(f"{VISION} {dtype} one card unsharded ({one['n_layers']} "
                f"layers): prefill {one['prefill_ms']:.2f} ms, decode "
                f"{one['decode_ms']:.2f} ms a step, peak "
                f"{one['peak_gb']:.2f} GB, K3 {one['k3_launches']} a prefill")
            if one["bf16_floor"]:
                f = one["bf16_floor"]
                log(f"{VISION} bf16 one card: prefill against K3's plain "
                    f"version {f['rel_err']:.3e}, beside a noise floor of "
                    f"{f['noise_floor']:.3e} (plain against plain with "
                    f"{f['floor_by']})")
            for dims in VISION_CARD_MESHES:
                ranks = mesh_lib.run_local(vision_serve_rank, 4, dims, dtype,
                                           one["fed"], device="cuda",
                                           timeout=900)
                errs = [rel_err(g, w_) for g, w_ in zip(ranks[0]["logits"],
                                                        one["logits"])]
                check(all(torch.equal(a, b) for r in ranks for a, b in
                          zip(r["logits"], ranks[0]["logits"])),
                      f"{VISION} {dtype} {dims}: the ranks' logits differ")
                rows = [{k: v for k, v in r.items()
                         if k not in ("logits", "fed")} for r in ranks]
                rec[f"{dims} {dtype}"] = {"rel_errs": errs, "ranks": rows}
                log(f"{VISION} {dtype} over {dims}: rel err against one "
                    f"card {[f'{e:.3e}' for e in errs]} (prefill, steps); "
                    f"prefill {fmt_ms([r['prefill_ms'] for r in rows])} ms, "
                    f"decode {fmt_ms([r['decode_ms'] for r in rows])} ms a "
                    f"step, peak {fmt_ms([r['peak_gb'] for r in rows])} GB, "
                    f"K3 {[r['k3_launches'] for r in rows]} a rank")
                # float32 is held to one card; bf16 is logged beside its
                # noise floor: at 40 layers of random weights any two bf16
                # summation orders part by about 2e-2
                if dtype == "float32":
                    check(max(errs) < 1e-4, f"{VISION} float32 {dims}: "
                                            f"{errs} against one card")
        RECORD["vision_cards"] = rec
        done(f"{VISION} over four cards", t0)
    t0 = phase("40c. K3 and K4 at the ranks' local prefill shapes")
    RECORD["k3_local"] = {
        "llama3.2-3b (1, 4)": k3_times(torch, 6, 2, 128, 5, "llama3.2-3b "
                                       "(1, 4) rank"),
        "llama3.2-3b (2, 2)": k3_times(torch, 12, 4, 128, 5, "llama3.2-3b "
                                       "(2, 2) rank", b=SERVE_BATCH // 2),
        f"{DEEPSEEK} (1, 4)": k3_times(torch, 16, 2, 128, 5, f"{DEEPSEEK} "
                                       f"(1, 4) rank"),
        f"{VISION} (1, 4)": k3_times(torch, 8, 2, 128, 9, f"{VISION} (1, 4) "
                                     f"rank"),
        f"{VISION} (2, 2)": k3_times(torch, 16, 4, 128, 9, f"{VISION} (2, 2) "
                                     f"rank", b=SERVE_BATCH // 2),
        f"{SEAMLESS} encoder (1, 4)": k3_times(
            torch, 4, 4, 64, 10, f"{SEAMLESS} (1, 4) rank",
            s=SERVE_PROMPT // 4, causal=False, what="encoder")}
    RECORD["k4_local"] = {f"{ZAMBA} (1, 4)": k4_times(
        torch, 28, 64, 13, f"{ZAMBA} (1, 4) rank")}
    done("K3 and K4 at local shapes", t0)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sharded_serve_cards.json").write_text(json.dumps(
        {"card": smi, "world": w, **RECORD}, indent=1, default=str))
    if only != SERVE_ACROSS_ARCHS:
        log(smi)
        return 0
    return subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         str(ROOT / "tests" / "test_torch_cuda.py"), "-k",
         "sharded_serve_over_every_card"], timeout=600).returncode


if __name__ == "__main__":
    if sys.argv[1:] == [ANALYZE_ALONE]:
        sys.exit(analyze_alone())
    if sys.argv[1:] == [DRYRUN_ALONE]:
        sys.exit(dryrun_alone())
    if sys.argv[1:] == [RESUME_CHILD]:
        sys.exit(resume_child())
    if sys.argv[1:2] == [SHARDED_ACROSS_CARDS]:
        sys.exit(sharded_across_cards(sys.argv[2:]))
    if sys.argv[1:2] == [TRAIN_ACROSS_CARDS]:
        sys.exit(sharded_train_across_cards(sys.argv[2:]))
    sys.exit(mesh_across_cards() if sys.argv[1:] == [MESH_ACROSS_CARDS]
             else main())
