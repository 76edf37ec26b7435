#!/usr/bin/env python3
"""The bf16 floor of llama3.2-3b's batch-1 decode in ``long_500k``'s cache:
how far other roundings of the same attention move the logits.

``chip_smoke.long_context_rank`` on one card (full width and depth, bf16,
a prompt of 8192 that fills the 8192-slot ring, 4 steps fed the same
tokens), first as it is (``attend``), then with each layer's decode
attention replaced by another rounding of the same function: ``again``
(the same code, run-to-run), ``expand`` (``attend``'s expanded form),
and, over 4 slot shards merged in one process, ``A`` (the port's
``decode_partials``/``combine_partials``: unnormalised probabilities in
bf16, a bf16 PV product a shard), ``A2`` (those probabilities, the PV
product in float32), ``C`` (float32 probabilities and PV product: the
exact attention rounded once) and ``B`` (the global softmax first, the
normalised probabilities in bf16 as ``attend`` casts them, the PV product
in float32).  Each run's logits against the first as max|a - b| /
max|b|, the prefill's and each step's.  Run from the root of a checkout
on a machine with one H100:

    python3 perf/decode_floor.py

It prints one line per variant and writes ``chiprun_out/decode_floor.json``.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

VARIANT = {"name": None}
VARIANTS = ("again", "expand", "A", "A2", "C", "B")


def attention_variant(params, x, cache, pos, cfg, *, window=None,
                      slots=None):
    """``decode_self_attention`` with its attention computed as
    ``VARIANT["name"]`` says (module docstring)."""
    import torch

    from repro_torch.models import attention as A

    name = VARIANT["name"]
    p, q, k, v = A.decode_qkv(params, x, pos, cfg)
    c = cache.capacity
    cache.k[:, pos % c:pos % c + 1] = k
    cache.v[:, pos % c:pos % c + 1] = v
    k_pos = A.slot_positions(pos, 0, c, c, x.device)
    valid = k_pos >= 0
    eff = window if window is not None and window < c else None
    dt = q.dtype
    if name == "expand":
        o = A.attend(q, cache.k, cache.v, q_pos=p, k_pos=k_pos, window=eff,
                     k_valid=valid, expand_kv=True)
        return A._out_proj(params, o), cache
    b, sq, h, dh = q.shape
    hkv = cache.k.shape[2]
    qr = q.reshape(b, sq, hkv, h // hkv, dh)
    n, per = 4, c // 4
    bias = A._mask_bias(p, k_pos, causal=True, window=eff, k_valid=valid)
    ss = [torch.einsum("bqhgd,bkhd->bhgqk", qr,
                       cache.k[:, i * per:(i + 1) * per]).float()
          * A._scale(dh) + bias[:, i * per:(i + 1) * per] for i in range(n)]
    vs = [cache.v[:, i * per:(i + 1) * per] for i in range(n)]
    if name in ("A", "A2", "C"):
        ms = [s.amax(-1, keepdim=True) for s in ss]
        m = torch.stack(ms).amax(0)
        os_, ls = [], []
        for s, mr, vr in zip(ss, ms, vs):
            pr = torch.exp(s - mr)
            ls.append(pr.sum(-1, keepdim=True) * torch.exp(mr - m))
            if name == "A":
                o = torch.einsum("bhgqk,bkhd->bhgqd", pr.to(dt), vr).float()
            elif name == "A2":
                o = torch.einsum("bhgqk,bkhd->bhgqd", pr.to(dt).float(),
                                 vr.float())
            else:
                o = torch.einsum("bhgqk,bkhd->bhgqd", pr, vr.float())
            os_.append(o * torch.exp(mr - m))
        out = sum(os_) / sum(ls)
    else:
        m = torch.stack([s.amax(-1, keepdim=True) for s in ss]).amax(0)
        ps = [torch.exp(s - m) for s in ss]
        l = sum(pr.sum(-1, keepdim=True) for pr in ps)
        out = sum(torch.einsum("bhgqk,bkhd->bhgqd", (pr / l).to(dt).float(),
                               vr.float()) for pr, vr in zip(ps, vs))
    o = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(dt)
    return A._out_proj(params, o), cache


def run(mesh_unused, name, dtype, fed):
    """One rank: ``long_context_rank`` with the variant ``name`` (None:
    unpatched)."""
    from repro_torch.models import attention

    VARIANT["name"] = name
    if name is not None:
        attention.decode_self_attention = attention_variant
    return cs.long_context_rank(None, None, dtype, fed)


def main():
    import torch

    from repro_torch.launch import mesh as mesh_lib

    smi = cs.phase_card(torch)
    cs.phase_build()
    rec = {}
    dtype = "bfloat16"
    base = mesh_lib.run_local(run, 1, None, dtype, None, device="cuda",
                              timeout=600)[0]
    for name in VARIANTS:
        got = mesh_lib.run_local(run, 1, None if name == "again" else name,
                                 dtype, base["fed"], device="cuda",
                                 timeout=600)[0]
        errs = [cs.rel_err(a, b) for a, b in zip(got["logits"],
                                                 base["logits"])]
        rec[f"{dtype} {name}"] = errs
        cs.log(dtype, name, [f"{e:.3e}" for e in errs],
               cs.fmt_ms(got["step_ms"]))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_floor.json").write_text(json.dumps({"card": smi, **rec},
                                                      indent=1))
    cs.log(smi)


if __name__ == "__main__":
    main()
