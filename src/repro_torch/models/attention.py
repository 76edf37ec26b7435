"""Grouped-query attention: full, sliding-window, cross and cached decode.

Counterpart of ``repro/models/attention.py``.  Two numerics paths:

* ``attend`` — materialised scores (softmax in f32, probabilities cast to
  q's dtype before the PV product), in its expanded and its grouped form;
* ``attend_blockwise`` — the flash forward used by prefill.  Where the JAX
  function takes its flash branch (``block_k = min(block_k, Sk)`` divides
  ``Sk``) it runs K3 (``kernels/flash_attention.py``): the CUDA kernel on a
  CUDA tensor, its plain PyTorch version on a CPU tensor.  Elsewhere it takes
  the same materialised fallback as the JAX function.

All shapes: q (B, Sq, H, Dh); k/v (B, Sk, Hkv, Dh); GQA via head grouping.
``decode_self_attention`` writes the new token's K and V into the cache's
tensors in place (one slot per step, not a copy of the cache) and returns
the same tensors; its ``pos`` is a Python int, so the ring-buffer slot
arithmetic stays on the host.  ``cross_attention`` (the vlm and encdec
families) attends over memory K/V that ``project_memory`` precomputes,
through ``attend`` (materialised, as the JAX package), never K3.

On a mesh (``utils/shard_hints.py``) self and cross attention run on this
rank's heads: ``wq`` holds its q heads, ``wk``/``wv`` its kv heads (all of
them where the model axis does not divide ``n_kv_heads``:
:func:`_kv_for_heads` then picks the kv heads its q heads read), K3
(prefill) or ``attend`` sees only those, and the row-parallel ``wo``
product is all-reduced over ``model``.  The self-attention cache and the
projected memory (``project_memory``, the cross cache) hold what
``wk``/``wv`` give the rank (:func:`held_kv_heads`), the layout
``server.cache_specs`` names.  Under autograd the column-parallel products
take their input through ``shard_hints.copy_to`` (the memory too, where
the kv heads are sharded), and so do replicated kv heads before the cut to
the rank's: each rank's gradient of ``wk``/``wv`` then covers every kv
head, summed over ``model``, not only those its q heads read.

Where ``server.cache_specs`` shards the cache's sequence, a rank holds a
:class:`SlotSpan` of its slots and decode is flash-decode style:
:func:`decode_partials` attends over the rank's slots and keeps each row's
max, sum and unnormalised output in float32, and :func:`combine_partials`
merges the ranks' (or, without mesh axes, a stack of shards' in one
process) by the global max, so the result is the whole cache's softmax.
The JAX decode step runs the materialised ``attend`` over the whole cache
(GSPMD partitions it); no kernel is involved either way.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_plan
from repro_torch.models.param import decl
from repro_torch.utils import shard_hints


def attn_plan(cfg: ModelConfig) -> Dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "norm": rmsnorm_plan(d),
        "wq": decl((d, h, dh), ("d_model", "heads", None)),
        "wk": decl((d, hkv, dh), ("d_model", "kv_heads", None)),
        "wv": decl((d, hkv, dh), ("d_model", "kv_heads", None)),
        "wo": decl((h, dh, d), ("heads", None, "d_model"), fan_in_axes=(0, 1)),
    }


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: Optional[int],
               k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Sq, Sk) additive bias: 0 where visible, NEG_INF (-1e30) elsewhere."""
    ok = ref.visible(q_pos, k_pos, causal, window)
    if k_valid is not None:
        ok &= k_valid[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, ref.NEG_INF)


def _scale(dh: int) -> torch.Tensor:
    """``1 / sqrt(float32(dh))`` in float32, as a 0-dim CPU tensor."""
    return 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool = True,
           window: Optional[int] = None,
           k_valid: Optional[torch.Tensor] = None,
           expand_kv: bool = False) -> torch.Tensor:
    """Reference GQA attention with materialised (Sq, Sk) scores.

    ``expand_kv=True`` repeats the KV heads up to the Q head count before
    the score product; the grouped form (decode) views q as (Hkv, g)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window,
                      k_valid=k_valid)
    scale = _scale(dh)
    if expand_kv:
        if g > 1:
            k = torch.repeat_interleave(k, g, dim=2)
            v = torch.repeat_interleave(v, g, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    qr = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qr, k).float() * scale
    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, dh)


def attend_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_pos: torch.Tensor, k_pos: torch.Tensor,
                     causal: bool = True, window: Optional[int] = None,
                     block_k: int = 1024) -> torch.Tensor:
    """Flash-style forward (no gradient): K3 where the JAX function takes
    its flash branch, else the materialised fallback.  Output in q's
    dtype."""
    sk = k.shape[1]
    block_k = min(block_k, sk)
    if sk % block_k != 0:
        # short/odd sequences: the materialised path, as the JAX function
        return attend(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                      window=window, expand_kv=True)
    return _fa.attend_bshd(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                           window=window)


class KVCache(NamedTuple):
    """Fixed-capacity cache; ring-buffered when capacity < full context."""

    k: torch.Tensor          # (B, cap, Hkv, Dh) — rope already applied
    v: torch.Tensor          # (B, cap, Hkv, Dh)

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]


def held_kv_heads(cfg: ModelConfig) -> int:
    """The kv heads this rank's ``wk``/``wv`` hold: all of them, or on a
    mesh that shards them its share."""
    lay = shard_hints.layout(cfg)
    return cfg.n_kv_heads // (lay.model if lay and lay.kv_heads else 1)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
               device=None) -> KVCache:
    """Zeros; on a mesh this rank's kv heads (``batch`` is its own)."""
    shape = (batch, capacity, held_kv_heads(cfg), cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) against w (D, heads, Dh) -> (B, S, heads, Dh)."""
    d, heads, dh = w.shape
    return (x @ w.to(x.dtype).reshape(d, heads * dh)).unflatten(
        -1, (heads, dh))


def _project_qkv(params, x: torch.Tensor):
    """x (B, S, D) -> q (B, S, H, Dh), k and v (B, S, Hkv, Dh)."""
    return _proj(x, params["wq"]), _proj(x, params["wk"]), \
        _proj(x, params["wv"])


def _project_qkv_sharded(params, h: torch.Tensor, lay: shard_hints.Layout):
    """:func:`_project_qkv` on this rank's heads: the column-parallel
    products (``wq``, and ``wk``/``wv`` where the kv heads are sharded)
    take ``h`` through ``shard_hints.copy_to``; replicated ``wk``/``wv``
    take ``h`` as it is (the rank computes all of those kv heads)."""
    hp = shard_hints.copy_to(h)
    hk = hp if lay.kv_heads else h
    return _proj(hp, params["wq"]), _proj(hk, params["wk"]), \
        _proj(hk, params["wv"])


def _out_proj(params, o: torch.Tensor,
              lay: Optional[shard_hints.Layout] = None) -> torch.Tensor:
    """``o @ wo``; row-parallel over ``model`` where ``lay`` shards the
    heads (``wo`` holds this rank's rows)."""
    h, dh, d = params["wo"].shape
    wo = params["wo"].to(o.dtype).reshape(h * dh, d)
    if lay and lay.heads:
        return shard_hints.row_parallel(o.flatten(-2), wo, lay)
    return o.flatten(-2) @ wo


def _kv_for_heads(k: torch.Tensor, cfg: ModelConfig,
                  lay: Optional[shard_hints.Layout]) -> torch.Tensor:
    """The kv heads (dim 2) this rank's q heads read.  Sharded kv heads
    are already the rank's; replicated ones (the model axis divides
    ``n_heads`` but not ``n_kv_heads``) are cut to those its q heads
    ``[lo, hi)`` read, ``j // (H / Hkv)``: a whole number of groups, one
    group, or each q head's own kv head where neither fits."""
    if lay is None or not lay.heads or lay.kv_heads:
        return k
    g = cfg.n_heads // cfg.n_kv_heads
    lo, hi = lay.span(cfg.n_heads)
    if (hi - lo) % g == 0:
        return k[:, :, lo // g:hi // g]
    if g % (hi - lo) == 0:
        return k[:, :, lo // g:lo // g + 1]
    return torch.repeat_interleave(k, g, dim=2)[:, :, lo:hi]


def self_attention(params, x: torch.Tensor, cfg: ModelConfig, *,
                   causal: bool = True, window: Optional[int] = None,
                   blockwise: bool = False,
                   positions: Optional[torch.Tensor] = None,
                   return_kv: bool = False):
    """Full-sequence self attention (prefill / encoder)."""
    s = x.shape[1]
    lay = shard_hints.layout(cfg)
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    if lay and lay.heads:
        q, k, v = _project_qkv_sharded(params, h, lay)
    else:
        q, k, v = _project_qkv(params, h)
    pos = (torch.arange(s, dtype=torch.int32, device=x.device)
           if positions is None else positions)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if lay and lay.heads and not lay.kv_heads:
        # replicated kv heads, of which this rank reads its q heads' only:
        # their gradient is summed over the model axis
        k, v = shard_hints.copy_to(k), shard_hints.copy_to(v)
    ka, va = _kv_for_heads(k, cfg, lay), _kv_for_heads(v, cfg, lay)
    if blockwise:
        o = attend_blockwise(q, ka, va, q_pos=pos, k_pos=pos, causal=causal,
                             window=window)
    else:
        o = attend(q, ka, va, q_pos=pos, k_pos=pos, causal=causal,
                   window=window, expand_kv=True)
    out = _out_proj(params, o, lay)
    if return_kv:
        return out, (k, v)
    return out


def cross_attention(params, x: torch.Tensor,
                    memory_kv: Tuple[torch.Tensor, torch.Tensor],
                    cfg: ModelConfig) -> torch.Tensor:
    """Cross attention over precomputed memory K/V (no mask, no rope); the
    grouped form for one-token decode, the expanded one otherwise.  On a
    mesh ``memory_kv`` holds the rank's kv heads (``project_memory``), of
    which its q heads read theirs."""
    sq = x.shape[1]
    lay = shard_hints.layout(cfg)
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    if lay and lay.heads:
        h = shard_hints.copy_to(h)
    q = _proj(h, params["wq"])
    k, v = memory_kv
    if lay and lay.heads and not lay.kv_heads:
        k, v = shard_hints.copy_to(k), shard_hints.copy_to(v)
    k, v = _kv_for_heads(k, cfg, lay), _kv_for_heads(v, cfg, lay)
    dev = x.device
    o = attend(q, k, v,
               q_pos=torch.zeros(sq, dtype=torch.int32, device=dev),
               k_pos=torch.zeros(k.shape[1], dtype=torch.int32, device=dev),
               causal=False, expand_kv=sq > 1)
    return _out_proj(params, o, lay)


def project_memory(params, memory: torch.Tensor,
                   cfg: Optional[ModelConfig] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V (B, M, Hkv, Dh) of encoder/frontend output (B, M,
    D), in its dtype: on a mesh (``cfg``'s layout) the rank's held kv
    heads, the memory entering a column-parallel product where they are
    sharded."""
    lay = None if cfg is None else shard_hints.layout(cfg)
    if lay and lay.kv_heads:
        memory = shard_hints.copy_to(memory)
    return _proj(memory, params["wk"]), _proj(memory, params["wv"])


def decode_qkv(params, x: torch.Tensor, pos: int, cfg: ModelConfig):
    """The new token's position (1,) int32 and its q, k, v (rope applied)
    for one decode step of x (B, 1, D)."""
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    q, k, v = _project_qkv(params, h)
    p = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    return p, apply_rope(q, p, cfg.rope_theta), apply_rope(
        k, p, cfg.rope_theta), v


def slot_positions(pos: int, lo: int, hi: int, cap: int,
                   device=None) -> torch.Tensor:
    """The absolute position held by each slot ``[lo, hi)`` of a ring of
    ``cap`` slots once ``pos`` is written: the largest p <= pos with p mod
    cap == s, ``pos - ((pos - s) mod cap)`` (negative: not written yet)."""
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
    return pos - torch.remainder(pos - idx, cap)


class SlotSpan(NamedTuple):
    """This rank's slots ``[lo, hi)`` of a KV cache of ``cap`` slots whose
    sequence is split over the mesh ``axes`` (those of more than one rank;
    ``server.cache_specs``' sequence entry, the first axis the outer
    one)."""

    lo: int
    hi: int
    cap: int
    axes: Tuple[str, ...]


def decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    k_valid: Optional[torch.Tensor] = None):
    """Attention of q (B, Sq, H, Dh) over some slots of a cache, k/v (B, c,
    Hkv, Dh) at positions ``k_pos`` (c,), left unnormalised: each row's
    float32 max ``m`` and sum ``l`` (B, Sq, H, 1) and output ``o`` (B, Sq,
    H, Dh) float32, ``o = sum_k exp(s_k - m) v_k``, ``l = sum_k exp(s_k -
    m)``.  ``attend``'s grouped form and casts: float32 scores and
    exponents, the probabilities in q's dtype before the PV product.  A row
    that sees none of these slots has ``m = NEG_INF`` (:func:`
    combine_partials` weighs it by 0)."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window,
                      k_valid=k_valid)
    qr = q.reshape(b, sq, hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qr, k).float() * _scale(dh) \
        + bias
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype), v).float()

    def rows(t):      # (B, Hkv, g, Sq, 1) -> (B, Sq, H, 1)
        return t.permute(0, 3, 1, 2, 4).reshape(b, sq, h, 1)

    return rows(m), rows(l), o.reshape(b, sq, h, dh)


def combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                     dtype: torch.dtype, axes=None) -> torch.Tensor:
    """The flash-decode combine of :func:`decode_partials`' shards into the
    attention output, in ``dtype``.  Without ``axes`` the shards are a
    leading axis of ``m``, ``l`` and ``o`` (n, ...); with mesh ``axes``
    each rank holds its own and the merge is collectives over them
    (counted in ``shard_hints``): one all-reduce (max) of ``m`` an axis,
    then one all-reduce (sum) of the rescaled ``[o, l]``, packed, an axis.
    Every shard is rescaled by ``exp(m_r - m)`` with the global max ``m``
    before anything is summed, and only the sum is normalised: a shard
    that sees none of its slots (``m_r = NEG_INF``) adds exactly 0."""
    if axes is None:
        w = torch.exp(m - m.amax(0))
        return ((o * w).sum(0) / (l * w).sum(0)).to(dtype)
    w = torch.exp(m - shard_hints.all_max(m.clone(), axes))
    packed = shard_hints.all_reduce(torch.cat([o * w, l * w], -1), axes)
    return (packed[..., :-1] / packed[..., -1:]).to(dtype)


def decode_self_attention(params, x: torch.Tensor, cache: KVCache, pos: int,
                          cfg: ModelConfig, *,
                          window: Optional[int] = None,
                          slots: Optional[SlotSpan] = None):
    """One decode step against a (possibly ring-buffered) KV cache.

    Capacity == full context  -> plain causal cache (slot = pos).
    Capacity W < full context -> ring buffer (slot = pos mod W), giving
    sliding-window attention with O(W) memory.  The new K and V are written
    into ``cache``'s tensors in place.

    ``slots``: ``cache`` holds this rank's slots ``[lo, hi)`` of a cache of
    ``slots.cap`` (sequence-sharded over ``slots.axes``); the ring, the
    window and the valid slots are the whole cache's, only the owner of
    ``pos mod cap`` writes, and the ranks' partial softmaxes are merged by
    :func:`combine_partials`.  Where the sequence is over ``model`` and
    the q heads are too, the rank gathers every q head over ``model`` (its
    cache holds every kv head), merges, and keeps its own heads for
    ``wo``'s row-parallel product.
    """
    lay = shard_hints.layout(cfg)
    p, q, k, v = decode_qkv(params, x, pos, cfg)
    c = cache.capacity
    lo, cap = (0, c) if slots is None else (slots.lo, slots.cap)
    if slots is not None and slots.hi - lo != c:
        raise ValueError(f"a cache of {c} slots holds slots {slots}")
    slot = pos % cap - lo
    if 0 <= slot < c:
        cache.k[:, slot:slot + 1] = k
        cache.v[:, slot:slot + 1] = v
    k_pos = slot_positions(pos, lo, lo + c, cap, x.device)
    eff_window = window if window is not None and window < cap else None
    if slots is None:
        o = attend(q, _kv_for_heads(cache.k, cfg, lay),
                   _kv_for_heads(cache.v, cfg, lay), q_pos=p, k_pos=k_pos,
                   causal=True, window=eff_window, k_valid=k_pos >= 0)
        return _out_proj(params, o, lay), cache
    every_head = lay is not None and lay.heads and "model" in slots.axes
    if every_head:
        q, ck, cv = shard_hints.all_gather(q, 2), cache.k, cache.v
    else:
        ck, cv = _kv_for_heads(cache.k, cfg, lay), \
            _kv_for_heads(cache.v, cfg, lay)
    o = combine_partials(*decode_partials(
        q, ck, cv, q_pos=p, k_pos=k_pos, window=eff_window,
        k_valid=k_pos >= 0), q.dtype, slots.axes)
    if every_head:
        h_lo, h_hi = lay.span(cfg.n_heads)
        o = o[:, :, h_lo:h_hi]
    return _out_proj(params, o, lay), cache


def decode_cross_attention(params, x: torch.Tensor,
                           memory_kv: Tuple[torch.Tensor, torch.Tensor],
                           cfg: ModelConfig) -> torch.Tensor:
    """Cross attention during decode: the memory K/V are static."""
    return cross_attention(params, x, memory_kv, cfg)
