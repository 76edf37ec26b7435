"""Serving: batched greedy decode steps over a KV cache or SSM state, on one
device or tensor-parallel over a ``("data", "model")`` mesh.

Counterpart of ``repro/train/server.py``.  Cache capacity honours the
architecture's serving window: SWA archs use a ring buffer of ``window``
slots; SSM archs carry O(1) recurrent state.

``cache_specs`` builds the partition-spec tree for the cache by mirroring
``transformer.init_cache``'s structure: batch over ('pod', 'data') when
divisible, KV heads over 'model' when divisible, with a sequence-sharded
entry for what remains (batch 1 long-context serving, or KV heads that do
not divide 'model'), flash-decode style.

:func:`shard_for_serving` is the sharded serve path on a ``DeviceMesh``
(``launch.mesh.make_tiny_mesh``): the weights as DTensors under
``serve_rules`` (each rank keeps its shards), the batch over the data
axes, the cache laid out per ``cache_specs``, and every call run inside a
hints context (``utils/shard_hints.py``) on the rank's own shards; the
vlm and encdec families' ``memory`` goes in whole or laid out by
``data.make_batch_specs``, each rank taking its batch shard.  Every family
is served on a mesh.  A batch that does not divide the batch axes (batch
1, ``long_500k``) is replicated over them, as the JAX package's
``constrain`` leaves it: every data rank runs the whole batch, under a
layout with no batch axes (so MoE routing counts its tokens once).

Where ``cache_specs`` shards a KV cache's sequence (``kv``, ``groups_kv``,
``cross_self_kv``: over ``data`` where the batch does not divide it, over
``model`` where ``model`` does not divide the kv heads, over ``("data",
"model")`` where both hold), each rank of those axes holds slots ``[r
cap/n, (r+1) cap/n)`` in mesh order (:meth:`ShardedServer.slot_span`).
The prefill computes the whole prompt and keeps the rank's slots;
``decode`` gives every family's self attention that span: the ring,
window and valid slots are the whole cache's, only the owner of ``pos mod
cap`` writes the new K/V, and the flash-decode combine
(``attention.combine_partials``) merges the ranks' partial softmaxes
with one all-reduce (max) and one all-reduce (sum) over each sequence axis
of more than one rank; where the sequence is over ``model`` and the q
heads are too, each rank first gathers every q head over ``model``.
``cross_kv`` is never sharded over the sequence.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.attention import KVCache, SlotSpan
from repro_torch.models.model import Model, serve_capacity
from repro_torch.models.param import (
    P, NamedSharding, distribute_params, entry_axes, local_params,
    mesh_shape, serve_rules,
)
from repro_torch.models.ssm import SSMState
from repro_torch.utils import shard_hints
from repro_torch.utils.tree import flatten_paths


@dataclass(frozen=True)
class ServeConfig:
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0


def make_serve_step(model: Model, shape: InputShape):
    """serve_step(params, cache, token) -> (next_token, logits, cache').
    Tokens are int64 (B, 1) tensors, the index type of PyTorch."""
    cfg = model.cfg
    window = cfg.window or cfg.serve_window
    eff_window = window if (window and window < shape.seq_len) else None

    @torch.no_grad()
    def serve_step(params, cache, token):
        logits, cache = transformer.decode(params, cfg, cache, token,
                                           window=eff_window)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return next_token, logits, cache

    return serve_step


def init_cache_for_shape(model: Model, shape: InputShape, device=None):
    cfg = model.cfg
    cap = serve_capacity(cfg, shape.seq_len)
    mem_len = transformer.cross_len(cfg, shape.seq_len)
    cache = model.init_cache(shape.global_batch, cap, mem_len, device=device)
    # decode_32k/long_500k semantics: the cache is already full up to seq_len-1
    return cache._replace(pos=shape.seq_len - 1)


def abstract_cache_for_shape(model: Model, shape: InputShape):
    """``init_cache_for_shape`` on the ``meta`` device (no storage)."""
    return init_cache_for_shape(model, shape, device="meta")


# --------------------------------------------------------------------------
# Cache sharding
# --------------------------------------------------------------------------

def _axes_ok(mesh, axes: Tuple[str, ...], dim: int) -> bool:
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        if a not in shape:
            return False
        n *= shape[a]
    return dim % n == 0 and n > 1


def _batch_entry(mesh, batch: int):
    shape = mesh_shape(mesh)
    for cand in (("pod", "data"), ("data",)):
        axes = tuple(a for a in cand if a in shape)
        if axes and _axes_ok(mesh, axes, batch):
            return axes if len(axes) > 1 else axes[0]
    return None


def _cache_entries(cfg: ModelConfig, batch: int, cap: int, mesh):
    """(batch entry, sequence entry, kv-head entry) of a cache of ``cap``
    slots."""
    b_entry = _batch_entry(mesh, batch)
    kvh = "model" if _axes_ok(mesh, ("model",), max(cfg.n_kv_heads, 1)) \
        else None
    # The cache sequence dim picks up whatever axes remain unused: 'model'
    # when the (few) KV heads can't split 16 ways, 'data' when batch=1
    # (long-context serving) — flash-decode style sequence parallelism.
    seq_axes = []
    if b_entry is None:
        seq_axes.append("data")
    if kvh is None:
        seq_axes.append("model")
    seq_axes = tuple(a for a in seq_axes if a in mesh_shape(mesh))
    seq_entry = None
    if seq_axes and _axes_ok(mesh, seq_axes, cap):
        seq_entry = seq_axes if len(seq_axes) > 1 else seq_axes[0]
    return b_entry, seq_entry, kvh


def _cache_specs(cfg: ModelConfig, batch: int, cap: int, mesh):
    b_entry, seq_entry, kvh = _cache_entries(cfg, batch, cap, mesh)

    def kv_spec(lead: int):
        # (lead..., B, cap, Hkv, Dh)
        lead_spec = (None,) * lead
        return KVCache(k=P(*lead_spec, b_entry, seq_entry, kvh, None),
                       v=P(*lead_spec, b_entry, seq_entry, kvh, None))

    def ssm_spec(lead: int):
        d_in = cfg.ssm.expand * cfg.d_model
        din = "model" if _axes_ok(mesh, ("model",), d_in) else None
        hg = d_in // cfg.ssm.headdim // cfg.ssm.n_groups
        hco = "model" if _axes_ok(mesh, ("model",), hg) else None
        lead_spec = (None,) * lead
        return SSMState(ssm=P(*lead_spec, b_entry, None, hco, None, None),
                        conv_x=P(*lead_spec, b_entry, None, din),
                        conv_B=P(*lead_spec, b_entry, None, None),
                        conv_C=P(*lead_spec, b_entry, None, None))

    def cross_spec(lead: int):
        s = P(*(None,) * lead, b_entry, None, kvh, None)
        return (s, s)

    pos = P()
    fam = cfg.family
    C = transformer.Cache
    if fam in ("dense", "moe"):
        return C(kv=kv_spec(1), pos=pos)
    if fam == "ssm":
        return C(ssm=ssm_spec(1), pos=pos)
    if fam == "hybrid":
        tail = cfg.n_layers % cfg.shared_attn_every
        return C(groups_ssm=ssm_spec(2), groups_kv=kv_spec(1),
                 tail_ssm=ssm_spec(1) if tail else None, pos=pos)
    if fam == "vlm":
        return C(groups_kv=kv_spec(2), cross_self_kv=kv_spec(1),
                 cross_kv=cross_spec(1), pos=pos)
    if fam == "encdec":
        return C(kv=kv_spec(1), cross_kv=cross_spec(1), pos=pos)
    raise ValueError(fam)


def cache_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """Spec tree matching ``init_cache``'s structure for (cfg, shape)."""
    return _cache_specs(cfg, shape.global_batch,
                        serve_capacity(cfg, shape.seq_len), mesh)


# --------------------------------------------------------------------------
# The sharded serve path
# --------------------------------------------------------------------------

_KV_FIELDS = ("kv", "groups_kv", "cross_self_kv")   # the self-attention KV


def _map_cache(fn, cache, per_field):
    """``fn(tensor, x)`` over every tensor field of a cache, ``x`` from the
    same field's entries of ``per_field`` (a dict by field name), ``pos``
    kept."""
    fields = {}
    for name, value in cache._asdict().items():
        if name == "pos" or value is None:
            fields[name] = value
            continue
        parts = [fn(t, x) for t, x in zip(value, per_field[name])]
        fields[name] = type(value)(*parts) if hasattr(value, "_fields") \
            else tuple(parts)
    return transformer.Cache(**fields)


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def _serve_batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The mesh axes a serve call's batch of ``batch`` runs over: the batch
    hint's (``pod``, ``data``) where they divide it, else the cache's batch
    entry (``data`` alone on a multi-pod mesh), else none: the batch is
    replicated over them, as the JAX package's ``constrain`` leaves a
    dimension it cannot divide unconstrained."""
    shape = mesh_shape(mesh)
    axes = tuple(a for a in ("pod", "data") if a in shape)
    n = 1
    for a in axes:
        n *= shape[a]
    return axes if batch % n == 0 else entry_axes(_batch_entry(mesh, batch))


@dataclass(eq=False)
class ShardedServer:
    """The serve path of ``model`` on a ``DeviceMesh`` (see
    :func:`shard_for_serving`).  ``params`` are DTensors, ``local`` this
    rank's tensors of them.  Tokens go in as DTensors laid out by
    ``data.make_batch_specs`` or as the whole batch (the same on every
    rank; each rank takes its shard, or all of it where the batch does not
    divide the batch axes); logits, next tokens and caches come back as
    DTensors (``.full_tensor()`` gathers one, a collective)."""

    model: Model
    mesh: Any
    params: Any
    local: Any
    _layouts: dict = field(default_factory=dict)       # by batch axes
    _placements_of: dict = field(default_factory=dict)   # built once each

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    def _batch_axes(self, batch: Optional[int]) -> Tuple[str, ...]:
        if batch is None:
            return shard_hints.attn_hints(self.cfg, self.mesh)["batch"]
        return _serve_batch_axes(self.mesh, batch)

    def hints(self, kind: str, batch: Optional[int] = None):
        """The hints context every call runs in: for a batch of ``batch``
        (None: one the batch axes divide), the batch (and the MoE buffer)
        over :func:`_serve_batch_axes`."""
        hint_map = shard_hints.attn_hints(self.cfg, self.mesh, kind)
        hint_map["batch"] = axes = self._batch_axes(batch)
        if "moe_cap" in hint_map:
            hint_map["moe_cap"] = axes
        return shard_hints.hints(self.mesh, **hint_map)

    def layout(self, batch: Optional[int] = None) -> shard_hints.Layout:
        """What this rank holds for a batch of ``batch`` (built once per
        batch axes)."""
        axes = self._batch_axes(batch)
        if axes not in self._layouts:
            with self.hints("prefill", batch):
                self._layouts[axes] = shard_hints.layout(self.cfg)
        return self._layouts[axes]

    def _placements(self, ndim: int, batch: int) -> tuple:
        """A tensor with its batch (dim 0) over the batch axes (replicated
        where the batch does not divide them)."""
        axes = self._batch_axes(batch)
        if (ndim, axes) not in self._placements_of:
            entry = axes if len(axes) > 1 else (axes[0] if axes else None)
            self._placements_of[(ndim, axes)] = NamedSharding(
                self.mesh, P(entry, *[None] * (ndim - 1))).placements
        return self._placements_of[(ndim, axes)]

    def _wrap(self, local: torch.Tensor, placements):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.mesh, placements,
                                  run_check=False)

    def _batch(self, x: torch.Tensor, batch: int) -> torch.Tensor:
        """This rank's batch shard of a DTensor or of the whole batch."""
        return shard_hints.batch_shard(x, self.layout(batch))

    def _cache_placements(self, batch: int, capacity: int):
        """The placements of each cache field per ``cache_specs`` (built
        once per batch and capacity)."""
        key = (batch, capacity)
        if key not in self._placements_of:
            specs = _cache_specs(self.cfg, batch, capacity, self.mesh)
            self._placements_of[key] = {
                name: [NamedSharding(self.mesh, s).placements for s in spec]
                for name, spec in specs._asdict().items()
                if name != "pos" and spec is not None}
        return self._placements_of[key]

    def slot_span(self, batch: int, capacity: int) -> Optional[SlotSpan]:
        """This rank's slots of a KV cache of ``capacity`` slots for a
        batch of ``batch`` where ``cache_specs`` shards its sequence (None
        where it does not, or the family has no KV cache): the ranks of
        the sequence axes in mesh order, the first axis the outer one."""
        _, seq_entry, _ = _cache_entries(self.cfg, batch, capacity,
                                         self.mesh)
        if seq_entry is None or self.cfg.family == "ssm":
            return None
        shape = mesh_shape(self.mesh)
        coord = dict(zip(self.mesh.mesh_dim_names,
                         self.mesh.get_coordinate()))
        n, idx = 1, 0
        for a in entry_axes(seq_entry):
            n, idx = n * shape[a], idx * shape[a] + coord[a]
        per = capacity // n
        return SlotSpan(lo=idx * per, hi=(idx + 1) * per, cap=capacity,
                        axes=tuple(a for a in entry_axes(seq_entry)
                                   if shape[a] > 1))

    def _wrap_cache(self, cache, batch: int, capacity: int):
        """The rank's cache fields as DTensors of a cache of ``capacity``
        slots."""
        placements = self._cache_placements(batch, capacity)
        return _map_cache(self._wrap, cache, placements)

    def _keep_slots(self, cache, span: Optional[SlotSpan]):
        """The slots ``span`` of a cache's self-attention KV fields (the
        rank computed all of them), copied; ``cross_kv`` and SSM states
        kept."""
        if span is None:
            return cache
        return cache._replace(**{
            f: KVCache(*(t[..., span.lo:span.hi, :, :].clone()
                         for t in getattr(cache, f)))
            for f in _KV_FIELDS if getattr(cache, f) is not None})

    @staticmethod
    def _capacity(cache) -> int:
        """The slots of the cache's KV fields (1 where it has none); of a
        cache of DTensors, the whole cache's."""
        kv = next((getattr(cache, f) for f in _KV_FIELDS
                   if getattr(cache, f) is not None), None)
        return 1 if kv is None else kv.k.shape[-3]

    def _memory(self, memory, batch: int):
        return None if memory is None else self._batch(memory, batch)

    def _logits(self, local: torch.Tensor, batch: int):
        return self._wrap(local, self._placements(local.ndim, batch))

    @torch.no_grad()
    def forward(self, tokens, memory=None, *, blockwise=False):
        """(logits DTensor (B, S, V), the rank's aux loss); ``memory`` (the
        vlm and encdec families') whole or a DTensor, as ``tokens``."""
        b = tokens.shape[0]
        with self.hints("prefill", b):
            logits, aux = transformer.forward(
                self.local, self.cfg, self._batch(tokens, b),
                self._memory(memory, b), blockwise=blockwise)
        return self._logits(logits, b), aux

    @torch.no_grad()
    def prefill(self, tokens, memory=None):
        """(last-position logits DTensor (B, 1, V), cache of DTensors);
        ``memory`` as :meth:`forward`'s.  Where the cache's sequence is
        sharded every rank of the sequence axes computes the whole prompt
        and keeps its slots."""
        b = tokens.shape[0]
        # the SSM and hybrid prefills return a cache of one slot
        cap = 1 if self.cfg.family in ("ssm", "hybrid") else tokens.shape[1]
        with self.hints("prefill", b):
            logits, cache = transformer.prefill(self.local, self.cfg,
                                                self._batch(tokens, b),
                                                self._memory(memory, b))
        cache = self._keep_slots(cache, self.slot_span(b, cap))
        return self._logits(logits, b), self._wrap_cache(cache, b, cap)

    def init_cache(self, batch: int, capacity: int, mem_len: int = 0,
                   device=None):
        """A zero cache of ``capacity`` slots (and ``mem_len`` memory
        positions in ``cross_kv``) for a batch of ``batch``, this rank's
        shards as DTensors: its batch shard (all of it where the batch
        does not divide the batch axes), kv heads and slots."""
        lay = self.layout(batch)
        span = self.slot_span(batch, capacity)
        with self.hints("decode", batch):
            cache = transformer.init_cache(
                self.cfg, batch // lay.n_batch,
                capacity if span is None else span.hi - span.lo, mem_len,
                device=device)
        return self._wrap_cache(cache, batch, capacity)

    @torch.no_grad()
    def decode(self, cache, token, *, window: Optional[int] = None):
        """One token per sequence: (logits DTensor (B, 1, V), cache'); the
        KV caches are written in place, a sequence-sharded one by the
        owner of the new slot, its ranks' softmaxes merged by the
        flash-decode combine (``attention.combine_partials``)."""
        b, cap = token.shape[0], self._capacity(cache)
        local = _map_cache(lambda t, _: _local(t), cache,
                           cache._asdict())
        with self.hints("decode", b):
            logits, local = transformer.decode(
                self.local, self.cfg, local, self._batch(token, b),
                window=window, slots=self.slot_span(b, cap))
        return self._logits(logits, b), self._wrap_cache(local, b, cap)

    def make_serve_step(self, shape: InputShape):
        """serve_step(cache, token) -> (next_token, logits, cache'), greedy
        over the whole vocabulary, as :func:`make_serve_step`."""
        window = self.cfg.window or self.cfg.serve_window
        eff_window = window if (window and window < shape.seq_len) else None

        @torch.no_grad()
        def serve_step(cache, token):
            logits, cache = self.decode(cache, token, window=eff_window)
            nxt = torch.argmax(logits.to_local()[:, -1, :], dim=-1)[:, None]
            return self._wrap(nxt, self._placements(2, token.shape[0])), \
                logits, cache

        return serve_step


def shard_for_serving(model: Model, params, mesh) -> ShardedServer:
    """The serve path of ``model`` on the ``DeviceMesh``: ``params`` (the
    same whole tensors on every rank, or DTensors already laid out) as
    DTensors under ``serve_rules``, each rank keeping its shards.  Raises
    for a layout the port does not shard yet (``shard_hints.Layout``)."""
    if any(hasattr(v, "to_local") for v in flatten_paths(params).values()):
        dparams = params
    else:
        dparams = distribute_params(params, model.plan, serve_rules(), mesh)
    server = ShardedServer(model=model, mesh=mesh, params=dparams,
                           local=local_params(dparams))
    server.layout()      # raises for what is not sharded
    return server
