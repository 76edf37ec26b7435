#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernel to its
plain version.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. card     — versions, ``nvidia-smi`` name and power limit, TF32 off;
2. build    — nvcc builds every ``src/repro_torch/kernels/csrc/*.cu``;
3. K1       — the fused uplink kernel against its plain PyTorch version on
              the card: agg/sgd/adam, f32 and bf16 wire, at the paper's width
              and beyond; bitwise where the contract says so;
4. main     — Algorithm 2 at the paper's width through ``fedpg.run`` with
              ``ota_backend="auto"``: every round must launch K1 once; then
              Algorithm 1; then a small run where the kernel path and the
              plain chain must agree;
5. fig12    — the Fig. 1-2 (N, M) table, K=250, 5 Monte-Carlo runs;
6. times    — K1's device time beside its byte bound, the plain version's
              time and ``torch.mv`` (the matvec alone);
7. profile  — torch.profiler over 10 Algorithm-2 rounds: device time by
              kernel and the device's busy share of a round.

It prints the card line, then one ``{"kernels": [...]}`` line, and as its last
line ``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
K1_SHAPES = [(1, 165), (10, 165), (7, 1000), (10_000, 165), (8, 2 ** 21 + 3)]
FIG12_SETTINGS = [(1, 10), (5, 10), (10, 10), (10, 1), (10, 5)]  # (N, M)
MAIN_ROUNDS = 100
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
        log(f"{name}: {b.path.name}")
        log("\n".join(line for line in b.log.splitlines()
                      if "registers" in line or "spill" in line))
    check("ota_fused" in built, "K1 source missing")
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
    from repro_torch.kernels import ota_fused, ref

    t0 = phase("3. K1 against its plain version")
    max_err = 0.0
    checks = 0

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
        for wire in (None, torch.bfloat16):
            gw = g if wire is None else g.to(wire)
            # agg: bitwise, noisy and noiseless, and invariant to threads
            a128 = ota_fused.fused_aggregate(g, h, wire_dtype=wire,
                                             threads=128, **kw)
            a512 = ota_fused.fused_aggregate(g, h, wire_dtype=wire,
                                             threads=512, **kw)
            want = ref.ota_fused_ref(gw, h, noise, **rkw)
            check(torch.equal(a128, a512), "agg depends on threads")
            check(torch.equal(a128, want),
                  f"agg not bitwise at {(n_agents, n_params)} wire={wire}: "
                  f"max err {(a128 - want).abs().max().item()}")
            a0 = ota_fused.fused_aggregate(g, h, wire_dtype=wire,
                                           with_noise=False, **kw)
            check(torch.equal(a0, ref.ota_fused_ref(gw, h, None, **rkw)),
                  "noiseless agg not bitwise")
            # sgd and adam: rtol 1e-6
            s128 = ota_fused.fused_aggregate_sgd(g, h, p, alpha=0.05,
                                                 wire_dtype=wire, threads=128,
                                                 **kw)
            s512 = ota_fused.fused_aggregate_sgd(g, h, p, alpha=0.05,
                                                 wire_dtype=wire, threads=512,
                                                 **kw)
            want_s = ref.ota_fused_sgd_ref(gw, h, p, noise, alpha=0.05, **rkw)
            check(torch.equal(s128, s512), "sgd depends on threads")
            torch.testing.assert_close(s128, want_s, rtol=1e-6, atol=1e-7)
            akw = dict(alpha=1e-3, step=7, b1=0.9, b2=0.999, eps=1e-8)
            ad = ota_fused.fused_aggregate_adam(g, h, p, mu, nu,
                                                wire_dtype=wire, **akw, **kw)
            ad512 = ota_fused.fused_aggregate_adam(g, h, p, mu, nu,
                                                   wire_dtype=wire,
                                                   threads=512, **akw, **kw)
            want_a = ref.ota_fused_adam_ref(gw, h, p, mu, nu, noise, **akw,
                                            **rkw)
            for x, y, z in zip(ad, ad512, want_a):
                check(torch.equal(x, y), "adam depends on threads")
                torch.testing.assert_close(x, z, rtol=1e-6, atol=1e-7)
            errs = [(s128 - want_s).abs().max().item()] + [
                (x - z).abs().max().item() for x, z in zip(ad, want_a)]
            max_err = max(max_err, *errs)
            checks += 1
            log(f"K1 (A={n_agents}, P={n_params}) wire="
                f"{'bf16' if wire else 'f32'}: agg bitwise, threads "
                f"128==512, sgd/adam max abs err {max(errs):.3e}")
        del g, p, mu, nu
    torch.cuda.synchronize()
    RECORD["k1_parity"] = {"checks": checks, "max_abs_err": max_err}
    done("K1", t0)
    return max_err


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


def timed_run(torch, fedpg, env, pol, cfg, ota, seed, backend="auto"):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    theta, hist = fedpg.run(env, pol, cfg, seed, ota=ota, ota_backend=backend,
                            device="cuda")
    e.record()
    torch.cuda.synchronize()
    return theta, hist, s.elapsed_time(e) / cfg.n_rounds


def phase_main(torch):
    from repro_torch.core import fedpg
    from repro_torch.kernels import ota_fused
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
        ota_fused.LAUNCHES = 0
        theta, hist, ms = timed_run(torch, fedpg, env, pol, cfg, o, 0)
        launches = ota_fused.LAUNCHES
        expect = cfg.n_rounds if o is not None else 0
        check(launches == expect,
              f"{name}: {launches} K1 launches, expected {expect}")
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
    from repro_torch.core import fedpg
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    t0 = phase("5. Fig. 1-2 table (K=250, 5 Monte-Carlo runs)")
    env, pol = LandmarkNav(), MLPPolicy()
    g, table = {}, []
    for n, m in FIG12_SETTINGS:
        cfg, ota = alg_config(n, m, 250)
        hist = fedpg.monte_carlo(env, pol, cfg, 0, 5, ota=ota, device="cuda")
        check(all(bool(torch.isfinite(x).all()) for x in hist),
              f"fig12 N={n} M={m} not finite")
        g[(n, m)] = fedpg.avg_grad_sq(hist).mean().item()
        reward = hist.rewards[:, -10:].mean().item()
        table.append({"N": n, "M": m, "avg_grad_sq": g[(n, m)],
                      "final_reward": reward})
        log(f"N={n:2d} M={m:2d}: avg_grad_sq={g[(n, m)]:.4f} "
            f"final_reward={reward:.4f}")
    flags = {"decreases_in_N": g[(1, 10)] > g[(5, 10)] > g[(10, 10)],
             "decreases_in_M": g[(10, 1)] > g[(10, 10)]}
    log(f"g[(1,10)] > g[(5,10)] > g[(10,10)]: {flags['decreases_in_N']}; "
        f"g[(10,1)] > g[(10,10)]: {flags['decreases_in_M']}")
    RECORD["fig12"] = {"table": table, "flags": flags}
    done("fig12", t0)


def phase_times(torch):
    from repro_torch.kernels import ota_fused, ref

    t0 = phase("6. K1 times (median of 60, CUDA events)")
    rows = []
    for n_agents, n_params in ((10, 165), (8, 2 ** 21)):
        g, h, p, _, _ = k1_inputs(torch, n_agents, n_params, 1)
        kw = dict(sigma=1e-3, scale=1.0 / (n_agents * 1.2533141373155),
                  seed=17)
        for wire in (torch.float32, torch.bfloat16):
            gw = g.to(wire).contiguous()
            wb = gw.element_size()
            hw = h.to(wire)
            ms = device_ms(torch, lambda: ota_fused.fused_aggregate_sgd(
                gw, h, p, alpha=1e-3, **kw))
            ms_agg = device_ms(torch, lambda: ota_fused.fused_aggregate(
                gw, h, with_noise=False, scale=kw["scale"]))
            plain_ms = device_ms(torch, lambda: ref.ota_fused_sgd_ref(
                gw, h, p, ref.counter_noise(17, n_params, "cuda"),
                alpha=1e-3, sigma=kw["sigma"], scale=kw["scale"]),
                sleep_cycles=20_000_000)
            lib_ms = device_ms(torch, lambda: torch.mv(gw.T, hw))
            bound, by = k1_bound(n_agents, n_params, wb, "sgd")
            bound_agg, _ = k1_bound(n_agents, n_params, wb, "agg")
            row = {"A": n_agents, "P": n_params,
                   "wire": "bf16" if wb == 2 else "f32", "mode": "sgd",
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by, "ms_agg_noiseless": ms_agg,
                   "bound_agg_ms": bound_agg, "library_ms": lib_ms,
                   "library_call": "torch.mv(G.T, h)"}
            rows.append(row)
            log(f"(A={n_agents}, P={n_params}) {row['wire']}: sgd "
                f"{ms * 1e3:.2f} us (bound {bound * 1e3:.4f} us, {by}; "
                f"{bound / ms:.2%} of it) | plain {plain_ms * 1e3:.2f} us | "
                f"noiseless agg {ms_agg * 1e3:.2f} us vs torch.mv "
                f"{lib_ms * 1e3:.2f} us")
        del g, p
    RECORD["times"] = rows
    done("times", t0)
    return rows


def phase_profile(torch, ms_per_round):
    """torch.profiler over 10 Algorithm-2 rounds at the paper's width:
    device time by kernel, launches per round, and the device's busy share
    of an unprofiled round (``ms_per_round`` from the main phase)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fedpg
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    t0 = phase("7. where the time goes: torch.profiler, 10 Algorithm-2 "
               "rounds")
    rounds = 10
    cfg, ota = alg_config(10, 10, rounds)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 2, ota=ota, device="cuda")
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    check(kernels, "the profiler recorded no device activity")

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    kernels.sort(key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / rounds
    launches = sum(e.count for e in kernels) / rounds
    k1 = sum(dev_us(e) for e in kernels if "ota_fused" in e.key) / rounds
    top = [{"name": e.key[:90], "device_us_per_round": dev_us(e) / rounds,
            "launches_per_round": e.count / rounds} for e in kernels[:12]]
    for t in top:
        log(f"{t['device_us_per_round']:9.1f} us/round "
            f"x{t['launches_per_round']:6.1f}  {t['name']}")
    share = busy / (ms_per_round * 1e3)
    log(f"per round: device busy {busy:.1f} us over {launches:.0f} device "
        f"launches ({len(kernels)} kernel names); K1 {k1:.1f} us; busy "
        f"share of an unprofiled {ms_per_round:.3f} ms round {share:.2%}")
    RECORD["profile"] = {"device_busy_us_per_round": busy,
                         "device_launches_per_round": launches,
                         "k1_us_per_round": k1, "busy_share": share,
                         "top": top}
    done("profile", t0)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t_all = time.perf_counter()
    smi = phase_card(torch)
    phase_build()
    max_err = phase_k1(torch)
    launches, main_res = phase_main(torch)
    phase_fig12(torch)
    rows = phase_times(torch)
    phase_profile(torch, main_res["alg2"]["ms_per_round"])
    RECORD["seconds"] = time.perf_counter() - t_all

    main_row = rows[0]   # (10, 165) f32 sgd: the shape of the main path
    kernels = {"kernels": [{
        "name": "ota_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ota_fused.cu",
        "replaces": "src/repro/kernels/ota_fused.py:85",
        "parity": "ok", "launches": launches, "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": [main_row["A"], main_row["P"]], "timings": rows}]}
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


if __name__ == "__main__":
    sys.exit(main())
