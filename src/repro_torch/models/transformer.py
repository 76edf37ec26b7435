"""Family assemblies: dense / moe / ssm / hybrid / encdec / vlm.

Counterpart of ``repro/models/transformer.py``.  Each family provides plain
functions over a parameter tree built from one plan (``plan(cfg)``):

    forward(params, cfg, tokens, memory)  -> (logits, aux)
    loss(params, cfg, batch, weights)     -> next-token CE + aux
    prefill(params, cfg, tokens, memory)  -> (last-position logits, cache)
    decode(params, cfg, cache, token)     -> (logits, cache')

The JAX package scans over stacked layer parameters (a leading 'layers'
axis; the hybrid and vlm families' groups over two, ``(n_groups, per,
...)``, the inner axis 'sublayers'); here Python loops index those axes
(:func:`layer`).  ``Cache.pos`` is a Python int: the decode loop's slot
arithmetic then needs no device scalar (and no host sync).  Decode writes
the KV caches in place (``attention.py``) and returns new SSM states,
stacked back to their leading axes (the hybrid's ``groups_ssm`` as ``(G,
per, ...)``, ``tail_ssm`` as ``(r, ...)``).  The moe family is the dense
family with ``moe.moe_ffn`` in place of the MLP; each layer's load-balance
loss is summed into ``aux`` in layer order (forward only: decode and
prefill drop it, as the JAX package does).  The hybrid family runs groups
of ``shared_attn_every`` mamba layers, each group followed by one shared
attention + MLP block (``params["shared"]``, stored once), then a tail of
``n_layers mod shared_attn_every`` mamba layers.  The vlm family runs
groups of ``cross_attn_every - 1`` dense layers and one cross layer (self
attention, cross attention over the patch embeddings, MLP); the encdec
family a bidirectional encoder over the frame embeddings (:func:`encode`)
and cross layers over its output.  Cross attention always runs ``attend``.

K3 and K4 have no backward.  The serving paths (``prefill`` and ``decode``)
reach them; a forward that autograd differentiates passes
``differentiable=True``, which runs the SSM mixer's plain scan
(``ref.ssd_ref``, as the JAX model always does) and needs
``blockwise=False`` (``attend``, not K3, the encoder's included).
``loss`` and the trainer's loss take that form.

SSM and hybrid prefill keep the JAX package's behaviour: they run
``forward`` (``blockwise=False``: the hybrid's shared attention through
``attend``) and return the last-position logits with a zeroed capacity-1
cache at position 0, not the state carried through the prompt.

Inside a hints context (``utils/shard_hints.py``, entered by
``train.server.shard_for_serving`` and ``train.trainer.
shard_for_training``) ``forward``, ``prefill``, ``decode`` and
``init_cache`` of every family run on this rank's shards: ``params`` are
its local tensors, ``tokens`` and ``memory`` its batch shard, and the
layers issue their collectives (every MLP through :func:`_ffn`, so each
``down`` product is all-reduced; the cross blocks' and the encoder's
attention on the rank's heads; the hybrid's shared block, stored once,
at each of its uses); the logits come back whole over the vocabulary.
The caches hold the rank's kv heads, ``cross_kv`` included, and, where
``server.cache_specs`` shards the sequence, the rank's slots of the
self-attention caches: ``decode``'s ``slots`` reach every family's self
attention (the hybrid's shared block and the vlm groups included).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    chunked_lm_loss, embed, embed_plan, mlp, mlp_plan, rmsnorm, rmsnorm_plan,
    unembed,
)
from repro_torch.models.param import stack_plan
from repro_torch.utils import shard_hints
from repro_torch.utils.device import resolve_device

STACK_AXES = ("layers", "sublayers")   # the plan axes a Python loop indexes


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def cross_len(cfg: ModelConfig, seq_len: int) -> int:
    """Length of the stub-frontend memory sequence."""
    if cfg.family == "vlm":
        return cfg.n_cross_tokens
    if cfg.family == "encdec":
        return max(seq_len // 4, 8)   # 4x-downsampled audio frames
    return 0


def dense_layer_plan(cfg: ModelConfig) -> Dict:
    return {"attn": attn.attn_plan(cfg), "mlp": mlp_plan(cfg.d_model, cfg.d_ff)}


def moe_layer_plan(cfg: ModelConfig) -> Dict:
    return {"attn": attn.attn_plan(cfg), "moe": moe_mod.moe_plan(cfg)}


def cross_layer_plan(cfg: ModelConfig) -> Dict:
    return {"attn": attn.attn_plan(cfg), "cross": attn.attn_plan(cfg),
            "mlp": mlp_plan(cfg.d_model, cfg.d_ff)}


def hybrid_groups(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, mamba layers a group, tail layers) of the hybrid family."""
    per = cfg.shared_attn_every
    return (cfg.n_layers // per, per, cfg.n_layers % per)


def vlm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, dense layers a group) of the vlm family; each group ends
    with one cross layer."""
    per = cfg.cross_attn_every
    if cfg.n_layers % per:
        raise ValueError(f"vlm: n_layers {cfg.n_layers} is not a multiple of "
                         f"cross_attn_every {per}")
    return cfg.n_layers // per, per - 1


def plan(cfg: ModelConfig) -> Dict:
    p: Dict[str, Any] = {
        "embed": embed_plan(cfg),
        "final_norm": rmsnorm_plan(cfg.d_model),
    }
    fam = cfg.family
    if fam == "dense":
        p["layers"] = stack_plan(dense_layer_plan(cfg), cfg.n_layers)
    elif fam == "moe":
        p["layers"] = stack_plan(moe_layer_plan(cfg), cfg.n_layers)
    elif fam == "ssm":
        p["layers"] = stack_plan(ssm_mod.ssm_plan(cfg), cfg.n_layers)
    elif fam == "hybrid":
        n_groups, per, tail = hybrid_groups(cfg)
        p["mamba_groups"] = stack_plan(
            stack_plan(ssm_mod.ssm_plan(cfg), per, "sublayers"), n_groups)
        if tail:
            p["mamba_tail"] = stack_plan(ssm_mod.ssm_plan(cfg), tail)
        p["shared"] = dense_layer_plan(cfg)   # stored once, applied n_groups x
    elif fam == "vlm":
        n_groups, per = vlm_groups(cfg)
        p["plain_groups"] = stack_plan(
            stack_plan(dense_layer_plan(cfg), per, "sublayers"), n_groups)
        p["cross_layers"] = stack_plan(cross_layer_plan(cfg), n_groups)
    elif fam == "encdec":
        p["enc_layers"] = stack_plan(dense_layer_plan(cfg),
                                     cfg.encoder_layers)
        p["enc_norm"] = rmsnorm_plan(cfg.d_model)
        p["layers"] = stack_plan(cross_layer_plan(cfg), cfg.n_layers)
    else:
        raise ValueError(fam)
    return p


def layer(stacked, i: int):
    """Layer ``i``'s parameters: index the leading axis of every leaf (a
    tensor, or a list of per-layer tensors, as the trainer's autograd
    leaves are).  A two-axis stack takes two calls: group, then
    sublayer."""
    if isinstance(stacked, (torch.Tensor, list)):
        return stacked[i]
    return {k: layer(v, i) for k, v in stacked.items()}


def _ffn(lp, x: torch.Tensor, cfg: ModelConfig):
    """The dense MLP or the MoE FFN of one layer: (residual delta, aux)."""
    if cfg.family == "moe":
        return moe_mod.moe_ffn(lp["moe"], x, cfg)
    return mlp(lp["mlp"], x, cfg.norm_eps, shard_hints.layout(cfg)), None


def _cross_block(lp, x: torch.Tensor, kv, cfg: ModelConfig,
                 blockwise: bool) -> torch.Tensor:
    """Self + cross + mlp over the memory K/V ``kv`` of this layer."""
    x = x + attn.self_attention(lp["attn"], x, cfg, window=cfg.window,
                                blockwise=blockwise)
    x = x + attn.cross_attention(lp["cross"], x, kv, cfg)
    return x + _ffn(lp, x, cfg)[0]


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None, *, blockwise: bool = False,
            return_hidden: bool = False, differentiable: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits | final-norm hidden, aux).
    ``differentiable=True``: no forward-only kernel (module docstring)."""
    if differentiable and blockwise:
        raise ValueError("blockwise attention runs K3, which has no "
                         "backward: a differentiable forward takes "
                         "blockwise=False")
    dt = _dtype(cfg)
    lay = shard_hints.layout(cfg)
    x = embed(params["embed"], tokens, dt, lay)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family

    def mamba(lp, x):
        return x + ssm_mod.ssm_mixer(lp, x, cfg, plain_scan=differentiable)

    def block(lp, x, aux):
        x = x + attn.self_attention(lp["attn"], x, cfg, window=cfg.window,
                                    blockwise=blockwise)
        dx, a = _ffn(lp, x, cfg)
        return x + dx, aux if a is None else aux + a

    if fam in ("dense", "moe"):
        for i in range(cfg.n_layers):
            x, aux = block(layer(params["layers"], i), x, aux)
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            x = mamba(layer(params["layers"], i), x)
    elif fam == "hybrid":
        n_groups, per, tail = hybrid_groups(cfg)
        for g in range(n_groups):
            gp = layer(params["mamba_groups"], g)
            for j in range(per):
                x = mamba(layer(gp, j), x)
            x, _ = block(params["shared"], x, aux)
        for j in range(tail):
            x = mamba(layer(params["mamba_tail"], j), x)
    elif fam == "vlm":
        if memory is None:
            raise ValueError("vlm needs patch embeddings (memory)")
        mem = memory.to(dt)
        n_groups, per = vlm_groups(cfg)
        for g in range(n_groups):
            gp = layer(params["plain_groups"], g)
            for j in range(per):
                x, _ = block(layer(gp, j), x, aux)
            cl = layer(params["cross_layers"], g)
            x = _cross_block(cl, x, attn.project_memory(cl["cross"], mem,
                                                        cfg), cfg, blockwise)
    elif fam == "encdec":
        if memory is None:
            raise ValueError("encdec needs frame embeddings (memory)")
        enc = encode(params, cfg, memory, blockwise=blockwise)
        for i in range(cfg.n_layers):
            lp = layer(params["layers"], i)
            x = _cross_block(lp, x, attn.project_memory(lp["cross"], enc,
                                                        cfg), cfg, blockwise)
    else:
        raise ValueError(fam)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return unembed(params["embed"], x, cfg.tie_embeddings, lay), aux


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           blockwise: bool = False) -> torch.Tensor:
    """Bidirectional encoder over stub frame embeddings (B, M, D): K3
    (``causal=False``) where ``blockwise``, ``attend`` otherwise."""
    x = frames.to(_dtype(cfg))
    for i in range(cfg.encoder_layers):
        lp = layer(params["enc_layers"], i)
        x = x + attn.self_attention(lp["attn"], x, cfg, causal=False,
                                    blockwise=blockwise)
        x = x + _ffn(lp, x, cfg)[0]
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
         weights: Optional[torch.Tensor] = None, *,
         loss_chunk: int = 1024) -> torch.Tensor:
    """Next-token CE (+ aux); ``weights``: per-sequence OTA gains.  The
    forward is the differentiable one (``attend``, not K3; the SSM mixer's
    plain scan, not K4), as the JAX package's training forward; the CE is
    evaluated in recomputed sequence chunks (:func:`chunked_lm_loss`)."""
    hidden, aux = forward(params, cfg, batch["tokens"], batch.get("memory"),
                          blockwise=False, return_hidden=True,
                          differentiable=True)
    ce = chunked_lm_loss(params["embed"], hidden, batch["labels"],
                         cfg.tie_embeddings, weights, chunk=loss_chunk)
    return ce + aux


class Cache(NamedTuple):
    """Decode-time state for every family (unused fields are None)."""

    kv: Any = None           # dense/moe/encdec: KVCache with leading (L,)
    ssm: Any = None          # ssm: SSMState with leading (L,)
    groups_kv: Any = None    # hybrid: shared-attn KVCache (G, ...); vlm plain (G, per-1, ...)
    groups_ssm: Any = None   # hybrid: SSMState (G, per, ...)
    tail_ssm: Any = None     # hybrid tail: SSMState (r, ...)
    cross_self_kv: Any = None  # vlm cross-layer self KV (G, ...)
    cross_kv: Any = None     # vlm/encdec: projected memory (k, v), (n, B, M, Hkv, Dh)
    pos: int = 0             # next absolute position (a Python int)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, mem_len: int = 0,
               dtype=None, device=None) -> Cache:
    """Zero-initialised cache; ``capacity`` already reflects serve_window
    clamping (``model.serve_capacity``).  ``device`` None means cuda."""
    dt = dtype or _dtype(cfg)
    device = resolve_device(device)
    fam = cfg.family

    def kv(*lead):
        c = attn.init_cache(cfg, batch, capacity, dt, device)
        return attn.KVCache(*(x.new_zeros(lead + x.shape) for x in c))

    def sstate(*lead):
        s = ssm_mod.init_state(cfg, batch, dt, device)
        return ssm_mod.SSMState(*(x.new_zeros(lead + x.shape) for x in s))

    def cross(n):
        shape = (n, batch, mem_len, attn.held_kv_heads(cfg), cfg.head_dim)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    if fam in ("dense", "moe"):
        return Cache(kv=kv(cfg.n_layers), pos=0)
    if fam == "ssm":
        return Cache(ssm=sstate(cfg.n_layers), pos=0)
    if fam == "hybrid":
        n_groups, per, tail = hybrid_groups(cfg)
        return Cache(groups_ssm=sstate(n_groups, per), groups_kv=kv(n_groups),
                     tail_ssm=sstate(tail) if tail else None, pos=0)
    if fam == "vlm":
        n_groups, per = vlm_groups(cfg)
        return Cache(groups_kv=kv(n_groups, per), cross_self_kv=kv(n_groups),
                     cross_kv=cross(n_groups), pos=0)
    if fam == "encdec":
        return Cache(kv=kv(cfg.n_layers), cross_kv=cross(cfg.n_layers),
                     pos=0)
    raise ValueError(fam)


def _kv_at(cache: attn.KVCache, *idx) -> attn.KVCache:
    """One layer's KV cache: views into the stacked cache, which decode
    writes in place."""
    return attn.KVCache(cache.k[idx], cache.v[idx])


def _stack_states(states) -> ssm_mod.SSMState:
    return ssm_mod.SSMState(*(torch.stack(t) for t in zip(*states)))


def decode(params, cfg: ModelConfig, cache: Cache, token: torch.Tensor, *,
           window: Optional[int] = None,
           slots: Optional[attn.SlotSpan] = None) -> Tuple[torch.Tensor, Cache]:
    """serve_step: one new token per sequence. Returns (logits (B,1,V),
    cache').  ``slots``: the self-attention caches (``kv``, ``groups_kv``,
    ``cross_self_kv``) hold this rank's span of a sequence-sharded cache
    (``attention.decode_self_attention``); ``cross_kv`` is whole."""
    lay = shard_hints.layout(cfg)
    x = embed(params["embed"], token, _dtype(cfg), lay)
    pos = int(cache.pos)
    fam = cfg.family

    def self_attn(lp, x, kv):
        dx, _ = attn.decode_self_attention(lp["attn"], x, kv, pos, cfg,
                                           window=window, slots=slots)
        return x + dx

    def mamba(stacked, states, x):
        """The stacked mamba layers over their states: (x, new states)."""
        new = []
        for j in range(len(states.ssm)):
            s = ssm_mod.SSMState(*(t[j] for t in states))
            dx, s2 = ssm_mod.ssm_step(layer(stacked, j), x, s, cfg)
            x = x + dx
            new.append(s2)
        return x, _stack_states(new)

    def cross(lp, x, kv, ckv):
        x = self_attn(lp, x, kv)
        x = x + attn.decode_cross_attention(lp["cross"], x, ckv, cfg)
        return x + _ffn(lp, x, cfg)[0]

    new = cache
    if fam in ("dense", "moe"):
        for i in range(cfg.n_layers):
            lp = layer(params["layers"], i)
            x = self_attn(lp, x, _kv_at(cache.kv, i))
            x = x + _ffn(lp, x, cfg)[0]
    elif fam == "ssm":
        x, ssm = mamba(params["layers"], cache.ssm, x)
        new = cache._replace(ssm=ssm)
    elif fam == "hybrid":
        shared = params["shared"]
        groups = []
        for g in range(hybrid_groups(cfg)[0]):
            x, s2 = mamba(layer(params["mamba_groups"], g),
                          ssm_mod.SSMState(*(t[g] for t in cache.groups_ssm)),
                          x)
            groups.append(s2)
            x = self_attn(shared, x, _kv_at(cache.groups_kv, g))
            x = x + _ffn(shared, x, cfg)[0]
        tail = cache.tail_ssm
        if tail is not None:
            x, tail = mamba(params["mamba_tail"], tail, x)
        new = cache._replace(groups_ssm=_stack_states(groups), tail_ssm=tail)
    elif fam == "vlm":
        n_groups, per = vlm_groups(cfg)
        for g in range(n_groups):
            gp = layer(params["plain_groups"], g)
            for j in range(per):
                lp = layer(gp, j)
                x = self_attn(lp, x, _kv_at(cache.groups_kv, g, j))
                x = x + _ffn(lp, x, cfg)[0]
            x = cross(layer(params["cross_layers"], g), x,
                      _kv_at(cache.cross_self_kv, g),
                      tuple(t[g] for t in cache.cross_kv))
    elif fam == "encdec":
        for i in range(cfg.n_layers):
            x = cross(layer(params["layers"], i), x, _kv_at(cache.kv, i),
                      tuple(t[i] for t in cache.cross_kv))
    else:
        raise ValueError(fam)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings, lay)
    return logits, new._replace(pos=pos + 1)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
    """Process the prompt, return (last-position logits, filled cache).
    The vlm and encdec families fill ``cross_kv`` with the projected memory
    (the encdec encoder through K3, bidirectional)."""
    b, s = tokens.shape
    fam = cfg.family
    if fam in ("ssm", "hybrid"):
        # the JAX package's SSM/hybrid prefill: forward, then a zeroed
        # capacity-1 cache (the prompt's state is not carried)
        logits, _ = forward(params, cfg, tokens, memory, blockwise=False)
        return logits[:, -1:, :], init_cache(cfg, b, 1, 0,
                                             device=tokens.device)
    dt = _dtype(cfg)
    lay = shard_hints.layout(cfg)
    x = embed(params["embed"], tokens, dt, lay)

    def self_attn(lp, x, kvs):
        out, kv = attn.self_attention(lp["attn"], x, cfg, window=cfg.window,
                                      blockwise=True, return_kv=True)
        kvs.append(kv)
        return x + out

    def cross(lp, x, kvs, ckvs, mem):
        x = self_attn(lp, x, kvs)
        ckv = attn.project_memory(lp["cross"], mem, cfg)
        ckvs.append(ckv)
        x = x + attn.cross_attention(lp["cross"], x, ckv, cfg)
        return x + _ffn(lp, x, cfg)[0]

    def stacked(kvs):
        return tuple(torch.stack(t) for t in zip(*kvs))

    if fam in ("dense", "moe"):
        kvs = []
        for i in range(cfg.n_layers):
            lp = layer(params["layers"], i)
            x = self_attn(lp, x, kvs)
            x = x + _ffn(lp, x, cfg)[0]
        cache = Cache(kv=attn.KVCache(*stacked(kvs)), pos=s)
    elif fam == "vlm":
        if memory is None:
            raise ValueError("vlm needs patch embeddings (memory)")
        mem = memory.to(dt)
        n_groups, per = vlm_groups(cfg)
        pkvs, kvs, ckvs = [], [], []
        for g in range(n_groups):
            gp, gkvs = layer(params["plain_groups"], g), []
            for j in range(per):
                lp = layer(gp, j)
                x = self_attn(lp, x, gkvs)
                x = x + _ffn(lp, x, cfg)[0]
            pkvs.append(attn.KVCache(*stacked(gkvs)))
            x = cross(layer(params["cross_layers"], g), x, kvs, ckvs, mem)
        cache = Cache(groups_kv=attn.KVCache(*stacked(pkvs)),
                      cross_self_kv=attn.KVCache(*stacked(kvs)),
                      cross_kv=stacked(ckvs), pos=s)
    elif fam == "encdec":
        if memory is None:
            raise ValueError("encdec needs frame embeddings (memory)")
        enc = encode(params, cfg, memory, blockwise=True)
        kvs, ckvs = [], []
        for i in range(cfg.n_layers):
            x = cross(layer(params["layers"], i), x, kvs, ckvs, enc)
        cache = Cache(kv=attn.KVCache(*stacked(kvs)), cross_kv=stacked(ckvs),
                      pos=s)
    else:
        raise ValueError(fam)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.tie_embeddings, lay), cache
