"""Mixture-of-Experts FFN: top-k routing, capacity-based dispatch.

Counterpart of ``repro/models/moe.py``: the same plan, capacity, routing,
Switch aux loss and stable-sort dispatch, so both packages keep and drop
exactly the same (token, slot) assignments.  Dispatch scatters the kept
assignments into an ``(E, cap, d)`` buffer (dropped ones to a dump row that
is cut off), the experts run as batched products over the experts axis,
and a gather brings each assignment's output back.  The expert products
are plain ``torch.bmm``: the JAX package computes them outside any Pallas
kernel, and the family has no TPU kernel of its own.

Ties: ``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk``
promises no order among equal values (on CUDA especially), so routing
agrees with the JAX package's where the router probabilities of a token do
not tie, which holds for float32 logits from continuous weights.

Every op here has a deterministic CUDA kernel under
``torch.use_deterministic_algorithms(True)``: integer ``scatter_add_`` and
``cumsum``, ``argsort(stable=True)``, ``index_copy``, ``index_select``
(its backward is ``index_add``) and ``topk``'s scatter; and none reads a
value back to the host, so a layer makes no synchronisation.

On a mesh (``utils/shard_hints.py``; the JAX function's serve-time hints
``experts``, ``d_ff`` and ``moe_cap``) each rank routes its own tokens, the
batch's shard, with the replicated router, identically on every rank of
its ``model`` group.  Capacity and slot ranks stay the whole batch's, as
GSPMD keeps them: the per-expert counts are gathered over the batch axes,
capacity comes from the global token count, and each assignment's rank is
its rank within the rank's tokens plus the counts of the batch shards
before it (the token order of the unsharded stable sort), so the dispatch
integers are the unsharded ones.  Under the ``moe_cap`` hint (serving)
the buffer's capacity axis holds only this batch shard's slots, at most
its own token count an expert, not the whole batch's.  The experts shard
over ``model`` (their ``d_ff`` where the experts do not divide it); each
rank builds and runs its experts' rows of the buffer (or its ``d_ff``
slice of all of them), and the
combine's float32 partial sums are all-reduced over ``model`` before the
one rounding to the model dtype.  The load-balance loss is the whole
batch's: the router's mean probabilities are averaged over the batch
shards and the counts summed.  Under autograd (the sharded train step)
the router runs on the replicated tokens, whose gradient is whole on
every rank; the tokens dispatched to this rank's experts and the gates of
the combine go through ``shard_hints.copy_to`` (their gradients summed
over ``model``), and the mean probabilities' all-reduce over the batch
shards sums in backward, as each shard's loss is its share of the global
mean (the counts are integers, with no gradient).

OTA note: per-agent expert-gradient sparsity makes MoE the worst case for
the uplink's SNR: the dense channel noise hits every expert's parameters
while only top_k experts per token receive signal.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rmsnorm, rmsnorm_plan
from repro_torch.models.param import decl
from repro_torch.utils import shard_hints


def moe_plan(cfg: ModelConfig) -> Dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "norm": rmsnorm_plan(d),
        "router": decl((d, e), ("d_model", None), scale=0.02),
        "gate": decl((e, d, ff), ("experts", "d_model", "d_ff"),
                     fan_in_axes=(1,)),
        "up": decl((e, d, ff), ("experts", "d_model", "d_ff"),
                   fan_in_axes=(1,)),
        "down": decl((e, ff, d), ("experts", "d_ff", "d_model"),
                     fan_in_axes=(1,)),
    }


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens of one call: the JAX
    package's, padded to a multiple of 8 with a floor of 8 (its TPU
    layout), so both packages drop the same assignments."""
    m = cfg.moe
    c = -(-n_tokens * m.top_k // m.num_experts)
    c = int(c * m.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def route(params, x_flat: torch.Tensor, cfg: ModelConfig,
          generator: Optional[torch.Generator] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of (T, d) tokens.  Returns (expert_idx (T, k) int64,
    gates (T, k) in x's dtype, aux_loss float32 scalar).  The router jitter
    is drawn only from an explicit ``generator`` (JAX: ``key``)."""
    gates_full, idx, gates = _router(params, x_flat, cfg, generator)
    aux = _aux(gates_full.mean(dim=0),
               _counts(idx.reshape(-1), cfg.moe.num_experts),
               x_flat.shape[0], cfg)
    return idx, gates.to(x_flat.dtype), aux


def _router(params, x_flat: torch.Tensor, cfg: ModelConfig,
            generator: Optional[torch.Generator]):
    """(router probabilities (T, E) float32, top-k experts (T, k),
    renormalised top-k gates float32)."""
    m = cfg.moe
    logits = x_flat.float() @ params["router"].float()
    if generator is not None and m.router_jitter > 0.0:
        logits = logits + m.router_jitter * torch.randn(
            logits.shape, generator=generator, device=logits.device)
    gates_full = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(gates_full, m.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates_full, idx, gates


def _aux(me: torch.Tensor, counts: torch.Tensor, t: int,
         cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance loss from the mean router probabilities
    ``me`` (E,) and the assignments per expert of ``t`` tokens.  ce counts
    assignments per expert times 1/(t*k) (JAX adds 1/(t*k) once per
    assignment, which rounds differently: within rtol 1e-6)."""
    m = cfg.moe
    ce = counts.float() * (1.0 / (t * m.top_k))
    return m.num_experts * torch.sum(me * ce) * m.load_balance_coef


def _counts(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments per expert (``jnp.bincount(flat_e, length=E)``) as an
    integer scatter-add: ``torch.bincount`` reads the input's max back to
    the host on CUDA, a synchronisation each call."""
    return torch.zeros(n_experts, dtype=flat_e.dtype,
                       device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


def dispatch(idx: torch.Tensor, n_experts: int, cap: int,
             offset: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each (token, slot) assignment's rank within its expert (in token
    order, by a stable sort on the expert id), whether it fits the
    capacity, and its buffer row (``e * cap + rank``, or the dump row
    ``E * cap`` when dropped).  ``idx`` (T, k) -> three (T*k,) tensors.
    ``offset`` (E,): the assignments to each expert that precede these
    tokens in the whole batch (the batch shards before this one), added
    to every rank."""
    flat_e = idx.reshape(-1)
    n_assign = flat_e.shape[0]
    sort_idx = torch.argsort(flat_e, stable=True)
    counts = _counts(flat_e, n_experts)
    starts = torch.cumsum(counts, 0) - counts                   # exclusive
    rank_sorted = torch.arange(n_assign, device=idx.device) \
        - starts[flat_e[sort_idx]]
    # sort_idx is a permutation: each rank lands in its own place
    rank = torch.empty_like(rank_sorted).index_copy_(0, sort_idx, rank_sorted)
    if offset is not None:
        rank = rank + offset[flat_e]
    keep = rank < cap
    dest = torch.where(keep, flat_e * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    return rank, keep, dest


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward over (B, S, D).  Returns (out, aux_loss).  On a
    mesh ``x`` is this rank's batch shard and the expert weights its
    shards (module docstring)."""
    b, s, d = x.shape
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    dt = x.dtype
    lay = shard_hints.layout(cfg)
    h = rmsnorm(params["norm"], x, cfg.norm_eps)
    x_flat = h.reshape(b * s, d)
    t = b * s

    def assignments(xf):
        return xf[:, None, :].expand(t, k, d).reshape(t * k, d)

    if lay is None:
        cap = _capacity(t, cfg)
        idx, gates, aux = route(params, x_flat, cfg, generator)
        _, keep, dest = dispatch(idx, e, cap)
        # the kept assignments into the (E*cap + 1, d) buffer; dropped ones
        # all go to the last row, which is cut off, so which of them lands
        # there does not matter
        buf = x_flat.new_zeros((e * cap + 1, d)).index_copy(
            0, dest, assignments(x_flat))
        buf = buf[:-1].reshape(e, cap, d)
        mine, rows = keep, dest
    else:
        cap = _capacity(t * lay.n_batch, cfg)
        gates_full, idx, gates = _router(params, x_flat, cfg, generator)
        gates = gates.to(dt)
        counts = shard_hints.all_gather(_counts(idx.reshape(-1), e)[None],
                                        0, lay.batch_axes)   # (shards, E)
        # the batch shards' losses are summed (each its share of the
        # global mean), so the all-reduce over them sums in backward too
        me = shard_hints.all_reduce(gates_full.mean(dim=0), lay.batch_axes,
                                    backward="sum") / lay.n_batch
        aux = _aux(me, counts.sum(0), t * lay.n_batch, cfg)
        offset = counts[:lay.batch_rank].sum(0)
        rank, keep, dest = dispatch(idx, e, cap, offset=offset)
        flat_e = idx.reshape(-1)
        if lay.moe_cap and lay.n_batch > 1:
            # this batch shard's slots only (the moe_cap hint): its
            # assignments' ranks less the shards' before it, at most its t
            # tokens to an expert
            slots, slot = min(cap, t), rank - offset[flat_e]
        else:
            slots, slot = cap, rank
        # this rank's experts' rows (all of them where the experts are not
        # sharded); dropped assignments and other ranks' experts go to the
        # dump row, cut off
        lo, hi = lay.span(e) if lay.experts else (0, e)
        mine = keep & (flat_e >= lo) & (flat_e < hi)
        rows = torch.where(mine, (flat_e - lo) * slots + slot,
                           torch.full_like(slot, (hi - lo) * slots))
        if lay.experts or lay.moe_d_ff:
            # this rank's experts (or d_ff) see the tokens and the gates:
            # their gradients are summed over the model axis
            x_flat, gates = shard_hints.copy_to(x_flat), \
                shard_hints.copy_to(gates)
        buf = x_flat.new_zeros(((hi - lo) * slots + 1, d)).index_copy(
            0, rows, assignments(x_flat))
        buf = buf[:-1].reshape(hi - lo, slots, d)

    # per-expert SwiGLU: batched products over the experts axis
    g = torch.bmm(buf, params["gate"].to(dt))
    u = torch.bmm(buf, params["up"].to(dt))
    act = F.silu(g.float()).to(dt) * u
    y = torch.bmm(act, params["down"].to(dt))

    # gather back; dropped assignments (and, on a mesh, other ranks'
    # experts) contribute exactly zero.  The gate-weighted top-k slots are
    # summed in slot order in float32 (the ranks' partial sums all-reduced
    # over model) and rounded once to the model dtype, as XLA reduces a
    # bf16 sum
    safe = torch.where(mine, rows, torch.zeros_like(rows))
    picked = torch.index_select(y.reshape(-1, d), 0, safe) \
        * mine[:, None].to(dt)
    terms = (picked.reshape(t, k, d) * gates[..., None]).unbind(1)
    out = terms[0].float()
    for term in terms[1:]:
        out = out + term.float()
    if lay is not None and (lay.experts or lay.moe_d_ff):
        out = shard_hints.all_reduce(out)
    return out.to(dt).reshape(b, s, d), aux
