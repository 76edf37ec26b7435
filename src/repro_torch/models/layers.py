"""Shared neural building blocks (plan builders + apply functions).

Counterpart of ``repro/models/layers.py``: RMSNorm (float32 inside, cast
back), token embedding and (tied) unembedding, rotary embeddings on halves
(not interleaved), and the SwiGLU MLP with silu in float32.  Weights keep the
JAX package's layouts (``gate`` is ``(d_model, d_ff)``), so a product is
``x @ w``.  The LM losses (``lm_loss``, ``chunked_lm_loss``) are the
trainer's.

On a mesh (``utils/shard_hints.py``) the functions take this rank's
shards: with the vocabulary sharded, ``embed`` looks up the rank's rows
(tokens outside its range give zeros) and all-reduces, which is exact, and
``unembed`` gathers the vocabulary, so a caller sees every logit; ``mlp``
with a ``lay`` that shards ``d_ff`` has ``gate``/``up`` column-parallel and
``down`` row-parallel (``shard_hints.row_parallel``).  Under autograd the
column-parallel products take their input through ``shard_hints.copy_to``
(its gradient summed over ``model``), as the unembedding does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import decl
from repro_torch.utils import shard_hints


def rmsnorm_plan(d: int) -> Dict:
    return {"scale": decl((d,), ("d_model",), init="ones", dtype="float32")}


def rmsnorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def embed_plan(cfg: ModelConfig) -> Dict:
    p = {"tok": decl((cfg.vocab, cfg.d_model), ("vocab", "d_model"),
                     scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = decl((cfg.d_model, cfg.vocab), ("d_model", "vocab"))
    return p


def embed(params, tokens: torch.Tensor, dtype,
          lay: Optional[shard_hints.Layout] = None) -> torch.Tensor:
    """Token rows in ``dtype``; vocabulary-parallel where ``lay`` shards
    the vocabulary."""
    tok = params["tok"]
    if lay is None or not lay.vocab:
        return tok[tokens].to(dtype)
    lo = lay.model_rank * tok.shape[0]
    ids = tokens - lo
    mine = (ids >= 0) & (ids < tok.shape[0])
    x = tok[torch.where(mine, ids, torch.zeros_like(ids))].to(dtype)
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=dtype,
                                                    device=x.device))
    return shard_hints.all_reduce(x)


def unembed(params, x: torch.Tensor, tie: bool,
            lay: Optional[shard_hints.Layout] = None) -> torch.Tensor:
    """Logits over the whole vocabulary (gathered over ``model`` where
    ``lay`` shards it)."""
    w = params["tok"].T if tie else params["head"]
    if lay is None or not lay.vocab:
        return x @ w.to(x.dtype)
    logits = shard_hints.copy_to(x) @ w.to(x.dtype)
    return shard_hints.all_gather(logits, -1)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (half,)
    angles = positions[..., :, None].float() * freqs              # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]                      # (..., seq, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_plan(d_model: int, d_ff: int) -> Dict:
    return {
        "norm": rmsnorm_plan(d_model),
        "gate": decl((d_model, d_ff), ("d_model", "d_ff")),
        "up": decl((d_model, d_ff), ("d_model", "d_ff")),
        "down": decl((d_ff, d_model), ("d_ff", "d_model")),
    }


def mlp(params, x: torch.Tensor, eps: float,
        lay: Optional[shard_hints.Layout] = None) -> torch.Tensor:
    """SwiGLU; where ``lay`` shards ``d_ff`` the weights are this rank's
    ``d_ff`` shards, and the ``down`` product is row-parallel."""
    h = rmsnorm(params["norm"], x, eps)
    if lay and lay.d_ff:
        h = shard_hints.copy_to(h)
    g = h @ params["gate"].to(x.dtype)
    u = h @ params["up"].to(x.dtype)
    act = F.silu(g.float()).to(x.dtype) * u
    if lay and lay.d_ff:
        return shard_hints.row_parallel(act, params["down"].to(x.dtype), lay)
    return act @ params["down"].to(x.dtype)


# --------------------------------------------------------------------------
# Cross-entropy LM loss
# --------------------------------------------------------------------------

def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position ``logsumexp - gold`` in float32.  ``gather``'s backward
    is deterministic on CUDA under ``torch.use_deterministic_algorithms``
    (``nll_loss``'s is not)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return logz - gold


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; ``weights`` optionally reweights each
    sequence (the OTA channel-weighted-loss hook: weight = h of the
    sequence's agent)."""
    per_seq = torch.mean(_nll(logits, labels), dim=-1)        # (batch,)
    if weights is not None:
        per_seq = per_seq * weights
    return torch.mean(per_seq)


def chunked_lm_loss(embed_params, hidden: torch.Tensor, labels: torch.Tensor,
                    tie: bool, weights: Optional[torch.Tensor] = None,
                    chunk: int = 1024) -> torch.Tensor:
    """CE without holding the ``(B, S, vocab)`` float32 logits: the sequence
    in chunks, each recomputed in the backward
    (``torch.utils.checkpoint``, where JAX uses ``jax.checkpoint``), so
    both passes hold one ``(B, chunk, vocab)`` block.  A sequence that
    ``chunk`` does not divide takes :func:`lm_loss` whole, as in JAX."""
    b, s, _ = hidden.shape
    if s % chunk != 0:
        return lm_loss(unembed(embed_params, hidden, tie), labels, weights)

    def body(h, lab):
        return torch.sum(_nll(unembed(embed_params, h, tie), lab), dim=-1)

    nll_sum = torch.zeros(b, dtype=torch.float32, device=hidden.device)
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        nll_sum = nll_sum + checkpoint(body, hidden[:, sl], labels[:, sl],
                                       use_reentrant=False)
    per_seq = nll_sum / s
    if weights is not None:
        per_seq = per_seq * weights
    return torch.mean(per_seq)
