"""Family assemblies: the dense, SSM and MoE families.

Counterpart of ``repro/models/transformer.py`` for the families ported so
far.  Each provides plain functions over a parameter tree built from one
plan (``plan(cfg)``):

    forward(params, cfg, tokens)          -> (logits, aux)
    loss(params, cfg, batch, weights)     -> next-token CE + aux
    prefill(params, cfg, tokens)          -> (last-position logits, cache)
    decode(params, cfg, cache, token)     -> (logits, cache')

The JAX package scans over stacked layer parameters (leading 'layers' axis);
here a Python loop indexes that axis.  ``Cache.pos`` is a Python int: the
decode loop's slot arithmetic then needs no device scalar (and no host
sync).  Decode writes the KV cache in place (``attention.py``) and returns
new SSM states.  The moe family is the dense family with ``moe.moe_ffn`` in
place of the MLP; each layer's load-balance loss is summed into ``aux`` in
layer order (forward only: decode and prefill drop it, as the JAX package
does).  The hybrid, vlm and encdec families raise ``NotImplementedError``;
``ROADMAP.md`` lists them.

K3 and K4 have no backward.  The serving paths (``prefill`` and ``decode``)
reach them; a forward that autograd differentiates passes
``differentiable=True``, which runs the SSM mixer's plain scan
(``ref.ssd_ref``, as the JAX model always does) and needs
``blockwise=False`` (``attend``, not K3).  ``loss`` and the trainer's loss
take that form.

SSM prefill keeps the JAX package's behaviour: it runs ``forward`` and
returns the last-position logits with a zeroed capacity-1 cache at position
0, not the state carried through the prompt.
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
from repro_torch.utils.device import resolve_device

PORTED_FAMILIES = ("dense", "ssm", "moe")
_ATTENTION_FAMILIES = ("dense", "moe")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _unported(cfg: ModelConfig) -> NotImplementedError:
    return NotImplementedError(
        f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet; the port "
        f"runs {PORTED_FAMILIES} (ROADMAP.md lists the rest)")


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


def plan(cfg: ModelConfig) -> Dict:
    p: Dict[str, Any] = {
        "embed": embed_plan(cfg),
        "final_norm": rmsnorm_plan(cfg.d_model),
    }
    if cfg.family == "dense":
        p["layers"] = stack_plan(dense_layer_plan(cfg), cfg.n_layers)
    elif cfg.family == "moe":
        p["layers"] = stack_plan(moe_layer_plan(cfg), cfg.n_layers)
    elif cfg.family == "ssm":
        p["layers"] = stack_plan(ssm_mod.ssm_plan(cfg), cfg.n_layers)
    else:
        raise _unported(cfg)
    return p


def layer(stacked, i: int):
    """Layer ``i``'s parameters: index the leading axis of every leaf (a
    tensor, or a list of per-layer tensors, as the trainer's autograd
    leaves are)."""
    if isinstance(stacked, (torch.Tensor, list)):
        return stacked[i]
    return {k: layer(v, i) for k, v in stacked.items()}


def _ffn(lp, x: torch.Tensor, cfg: ModelConfig):
    """The dense MLP or the MoE FFN of one layer: (residual delta, aux)."""
    if cfg.family == "moe":
        return moe_mod.moe_ffn(lp["moe"], x, cfg)
    return mlp(lp["mlp"], x, cfg.norm_eps), None


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None, *, blockwise: bool = False,
            return_hidden: bool = False, differentiable: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits | final-norm hidden, aux).
    ``differentiable=True``: no forward-only kernel (module docstring)."""
    if cfg.family not in PORTED_FAMILIES:
        raise _unported(cfg)
    if differentiable and blockwise:
        raise ValueError("blockwise attention runs K3, which has no "
                         "backward: a differentiable forward takes "
                         "blockwise=False")
    x = embed(params["embed"], tokens, _dtype(cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        if cfg.family == "ssm":
            x = x + ssm_mod.ssm_mixer(lp, x, cfg, plain_scan=differentiable)
            continue
        x = x + attn.self_attention(lp["attn"], x, cfg, window=cfg.window,
                                    blockwise=blockwise)
        dx, a = _ffn(lp, x, cfg)
        x = x + dx
        if a is not None:
            aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return unembed(params["embed"], x, cfg.tie_embeddings), aux


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

    kv: Any = None           # dense/moe: KVCache with leading (L,) axes
    ssm: Any = None          # ssm: SSMState with leading (L,)
    groups_kv: Any = None    # hybrid / vlm (not ported)
    groups_ssm: Any = None   # hybrid (not ported)
    tail_ssm: Any = None     # hybrid (not ported)
    cross_self_kv: Any = None  # vlm (not ported)
    cross_kv: Any = None     # vlm/encdec (not ported)
    pos: int = 0             # next absolute position (a Python int)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, mem_len: int = 0,
               dtype=None, device=None) -> Cache:
    """Zero-initialised cache; ``capacity`` already reflects serve_window
    clamping (``model.serve_capacity``).  ``device`` None means cuda."""
    dt = dtype or _dtype(cfg)
    device = resolve_device(device)
    if cfg.family in _ATTENTION_FAMILIES:
        c = attn.init_cache(cfg, batch, capacity, dt, device)
        return Cache(kv=attn.KVCache(
            *(x.new_zeros((cfg.n_layers,) + x.shape) for x in c)), pos=0)
    if cfg.family == "ssm":
        s = ssm_mod.init_state(cfg, batch, dt, device)
        return Cache(ssm=ssm_mod.SSMState(
            *(x.new_zeros((cfg.n_layers,) + x.shape) for x in s)), pos=0)
    raise _unported(cfg)


def decode(params, cfg: ModelConfig, cache: Cache, token: torch.Tensor, *,
           window: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """serve_step: one new token per sequence. Returns (logits (B,1,V),
    cache')."""
    x = embed(params["embed"], token, _dtype(cfg))
    pos = int(cache.pos)
    if cfg.family in _ATTENTION_FAMILIES:
        for i in range(cfg.n_layers):
            lp = layer(params["layers"], i)
            c = attn.KVCache(cache.kv.k[i], cache.kv.v[i])
            dx, _ = attn.decode_self_attention(lp["attn"], x, c, pos, cfg,
                                               window=window)
            x = x + dx
            x = x + _ffn(lp, x, cfg)[0]
        new = cache
    elif cfg.family == "ssm":
        states = []
        for i in range(cfg.n_layers):
            lp = layer(params["layers"], i)
            s = ssm_mod.SSMState(*(t[i] for t in cache.ssm))
            dx, s2 = ssm_mod.ssm_step(lp, x, s, cfg)
            x = x + dx
            states.append(s2)
        new = cache._replace(ssm=ssm_mod.SSMState(
            *(torch.stack(t) for t in zip(*states))))
    else:
        raise _unported(cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg.tie_embeddings)
    return logits, new._replace(pos=pos + 1)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
    """Process the prompt, return (last-position logits, filled cache)."""
    b, s = tokens.shape
    if cfg.family == "ssm":
        # the JAX package's SSM prefill: forward, then a zeroed capacity-1
        # cache (the prompt's state is not carried)
        logits, _ = forward(params, cfg, tokens, memory, blockwise=False)
        return logits[:, -1:, :], init_cache(cfg, b, 1, 0,
                                             device=tokens.device)
    if cfg.family not in _ATTENTION_FAMILIES:
        raise _unported(cfg)
    x = embed(params["embed"], tokens, _dtype(cfg))
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        out, (k, v) = attn.self_attention(lp["attn"], x, cfg,
                                          window=cfg.window, blockwise=True,
                                          return_kv=True)
        x = x + out
        x = x + _ffn(lp, x, cfg)[0]
        ks.append(k)
        vs.append(v)
    cache = Cache(kv=attn.KVCache(k=torch.stack(ks), v=torch.stack(vs)),
                  pos=s)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return unembed(params["embed"], x, cfg.tie_embeddings), cache
