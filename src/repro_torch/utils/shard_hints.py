"""Logical-axis sharding hints: the model on each rank's own shards.

Counterpart of ``repro/utils/shard_hints.py``.  The JAX package's model code
is mesh-agnostic and GSPMD partitions it; launchers activate hints that map
*logical* activation axes ('heads', 'batch', ...) to mesh axes, and
``hints.constrain`` pins activations to them.  The port is eager PyTorch,
so the hints decide what each rank runs: inside a hints context every rank
runs the model on its own shards of the parameters and of the batch, as
the active map (:func:`attn_hints`'s dict) lays them out.  ``heads``,
``d_ff``, ``experts``, ``d_inner`` and ``ssm_heads`` mapped to ``model``
make the rank run its share of those axes; ``batch`` names the batch's
mesh axes; ``moe_cap`` keeps the MoE dispatch buffer to this batch shard's
slots.  The collectives sit where the JAX model re-constrains an output
to ``("batch", "q_seq", None)`` after a contraction over a
``model``-sharded axis: the partial sums are all-reduced over the
``model`` group after ``wo`` (self and cross attention), ``down`` (the
MLP), the experts' combine (MoE) and ``w_out`` (the SSM mixer).  The
vocabulary-parallel embedding all-reduces its rows; the unembedding
gathers the vocabulary; the SSM's ``gate_norm`` all-reduces its mean of
squares; MoE routing gathers its per-expert counts over the batch axes so
capacity and slot ranks are the whole batch's.

The weights are laid out over ``model`` as ``param.serve_rules()`` lays
them out (``distribute_params``; the sharded train step's
``train_rules(fsdp=True)`` adds only ``d_model`` over ``data``, and no
mesh axis is used twice in a spec, so its ``model`` entries are the
same): what a rank holds of the axes no hint names (``kv_heads``,
``vocab``, the experts' ``d_ff``) comes from them, and a hint that
disagrees with the weights' layout raises (:class:`Layout`).  Every
family runs on one layout: the cross blocks, the encoder and the hybrid's
shared block take ``attn_plan`` and ``mlp_plan`` as the decoder layers do,
so :func:`_held` reads them all.  The model code sees the ``model`` axis
only: the trainer gathers each leaf's
``data`` shards at its use (:func:`unshard`), so beneath it the layers
run the layout they run when serving.

Autograd: every collective here is a ``torch.autograd.Function`` with
Megatron's conjugate pair on the ``model`` axis, whose ranks compute the
same loss once (the objective counts it once): the all-reduce after a
row-parallel product, the embedding's and the MoE combine's is the
identity in backward; :func:`copy_to`, the entry to a column-parallel
region (and to any use of a replicated tensor by this rank's share of an
axis only), is the identity in forward and an all-reduce in backward; the
vocabulary gather slices this rank's columns in backward.  Where the
forward sum feeds a share of an axis (``gate_norm``'s mean of squares) or
ranks whose losses are summed (the batch axes: each data rank's loss is
its share of the global mean), the backward of an all-reduce is an
all-reduce (``backward="sum"``), and the backward of :func:`unshard`'s
all-gather is a reduce-scatter.  A backward collective over ranks of one
is skipped (the identity), so is :func:`unshard` on a ``data`` axis of
one: no copy is made there.

The serve path runs a batch that does not divide the batch axes (batch
1, ``long_500k``) under a ``batch`` hint of no axes (``train.server``):
the batch is replicated over them, ``n_batch`` is 1, and MoE routing
counts the whole batch's tokens once, as JAX's ``constrain`` leaves such
a dimension unconstrained.  Where ``server.cache_specs`` then shards the
KV cache's sequence over ``data``, over ``model`` (the kv heads do not
divide it) or over both, decode is flash-decode style
(``attention.combine_partials``): each rank attends over its slots, and
the partial softmaxes are merged by one all-reduce (max, :func:`all_max`)
of the rows' maxima and one all-reduce (sum) of the rescaled outputs and
sums, packed, over each sequence axis of more than one rank; where that
axis is ``model`` and the q heads are sharded, every q head is first
gathered over ``model`` (:func:`all_gather`, one token).

Outside a hints context :func:`layout` is None and every model function
runs exactly as it did before (bitwise).  Inside one every collective is
issued, at width 1 too (where it is the identity; the combine's skip the
sequence axes of one rank), and counted here where it is issued
(``ALL_REDUCES``, ``ALL_GATHERS``, ``REDUCE_SCATTERS``; :func:`counts`
reads them, :func:`reset_counts` zeroes them), each with its result's
bytes and its group's size (:func:`collective_stats`: the wire bytes by
kind, ``utils.collectives.wire_bytes``; a collective over a group of one
rank moves nothing and adds none).  The ``q_seq`` hint
(context parallelism where the heads do not divide the model axis) is not
acted on (``ROADMAP.md``): there the attention weights are replicated and
every rank of a ``model`` group runs all the heads.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.utils.collectives import CollectiveStats, wire_bytes

_STATE: Dict = {"mesh": None, "map": {}}
_LAYOUTS: Dict = {}     # (cfg, mesh, hint map) -> Layout

# torch's newer name of all_gather_into_tensor, where it has one
_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

# Collectives issued inside a hints context, counted where each is issued.
ALL_REDUCES = 0
ALL_GATHERS = 0
REDUCE_SCATTERS = 0
# their wire bytes and counts by kind, summed as each is issued
_STATS = CollectiveStats()
_GROUP_SIZES = weakref.WeakKeyDictionary()     # process group -> its size


def reset_counts() -> None:
    """Zero the collective counters."""
    global ALL_REDUCES, ALL_GATHERS, REDUCE_SCATTERS, _STATS
    ALL_REDUCES = ALL_GATHERS = REDUCE_SCATTERS = 0
    _STATS = CollectiveStats()


def counts() -> Dict[str, int]:
    """The collectives issued since the counters were last zeroed."""
    return {"all_reduce": ALL_REDUCES, "all_gather": ALL_GATHERS,
            "reduce_scatter": REDUCE_SCATTERS}


def collective_stats() -> CollectiveStats:
    """The wire bytes and counts by kind (``"all-reduce"``,
    ``"all-gather"``, ``"reduce-scatter"``, the JAX package's HLO names) of
    the collectives issued since the counters were last zeroed; a group of
    one rank adds its count and no bytes (a copy: later collectives do
    not change it)."""
    return CollectiveStats(dict(_STATS.bytes_by_kind),
                           dict(_STATS.count_by_kind))


def _group_size(group) -> int:
    """The number of ranks in ``group``, read once a group."""
    n = _GROUP_SIZES.get(group)
    if n is None:
        n = _GROUP_SIZES[group] = dist.get_world_size(group)
    return n


def _issued(kind: str, result: torch.Tensor, g: int) -> None:
    """Add one collective whose result is ``result`` over ``g`` ranks."""
    nbytes = result.numel() * result.element_size()
    _STATS.add(kind, wire_bytes(kind, nbytes, g) if g > 1 else 0.0)


@contextmanager
def hints(mesh, **logical_to_mesh):
    """Activate hints, e.g. ``hints(mesh, **attn_hints(cfg, mesh,
    "prefill"))``.  ``mesh`` is a ``DeviceMesh`` with a ``model`` axis and
    the batch axes."""
    prev = dict(_STATE)
    _STATE["mesh"] = mesh
    _STATE["map"] = {k: v for k, v in logical_to_mesh.items()
                     if v is not None}
    try:
        yield
    finally:
        _STATE.update(prev)


def active() -> bool:
    return _STATE["mesh"] is not None


def has(name: str) -> bool:
    """Whether a logical axis name is mapped in the active hints."""
    return name in _STATE["map"]


def attn_hints(cfg, mesh, kind: str = "train") -> Dict[str, object]:
    """The JAX package's choice of head sharding against context
    parallelism for this arch on this mesh (the same dict).  ``kind``:
    "train" | "prefill" | "decode"."""
    from repro_torch.models.param import mesh_shape

    shape = mesh_shape(mesh)
    model_sz = shape.get("model", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in shape)
    out: Dict[str, object] = {"batch": batch_axes}
    if cfg.n_heads and cfg.n_heads % model_sz == 0:
        out["heads"] = "model"
    elif cfg.n_heads:
        out["q_seq"] = "model"
    if cfg.d_ff and cfg.d_ff % model_sz == 0:
        out["d_ff"] = "model"
    if cfg.moe is not None:
        if cfg.moe.num_experts % model_sz == 0:
            out["experts"] = "model"
        if kind != "train":
            out["moe_cap"] = batch_axes
    if cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        n_ssm_heads = d_in // cfg.ssm.headdim
        if n_ssm_heads % model_sz == 0:
            out["ssm_heads"] = "model"
            if d_in % model_sz == 0:
                out["d_inner"] = "model"
    return out


@dataclass(frozen=True)
class Layout:
    """What this rank runs of one config's model under the active hints.

    ``model``/``model_rank``: the model axis' size and this rank's index
    on it; ``batch_axes``, ``n_batch``, ``batch_rank``: the batch's mesh
    axes (the ``batch`` hint), their product and this rank's linear index
    over them (the first axis the outer one).  The flags say which logical
    axes run sharded over ``model``: ``heads``, ``d_ff``, ``experts``,
    ``d_inner`` and ``ssm_heads`` as the hints map them, ``kv_heads``,
    ``vocab`` and ``moe_d_ff`` (the experts' ``d_ff``, sharded only where
    the experts are not) as the weights hold them.  ``moe_cap``: the MoE
    buffer holds this batch shard's slots only."""

    model: int
    model_rank: int
    batch_axes: Tuple[str, ...]
    n_batch: int
    batch_rank: int
    vocab: bool = False
    heads: bool = False
    kv_heads: bool = False
    d_ff: bool = False
    experts: bool = False
    moe_d_ff: bool = False
    d_inner: bool = False
    ssm_heads: bool = False
    moe_cap: bool = False

    def span(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``n`` rows split over ``model``."""
        per = n // self.model
        return self.model_rank * per, (self.model_rank + 1) * per


def _held(cfg, mesh) -> Dict[str, bool]:
    """Which logical axes the weights shard over ``model`` under
    ``serve_rules`` (``distribute_params``' layout)."""
    from repro_torch.models import attention, layers, moe, ssm
    from repro_torch.models.param import serve_rules, spec_for

    rules = serve_rules()

    def on(decl, dim):
        spec = spec_for(decl, rules, mesh)
        return len(spec) > dim and spec[dim] == "model"

    held = {"vocab": on(layers.embed_plan(cfg)["tok"], 0)}
    if cfg.n_heads:
        a = attention.attn_plan(cfg)
        held.update(heads=on(a["wq"], 1), kv_heads=on(a["wk"], 1))
    if cfg.d_ff and cfg.family != "moe":
        held["d_ff"] = on(layers.mlp_plan(cfg.d_model, cfg.d_ff)["gate"], 1)
    if cfg.moe is not None:
        g = moe.moe_plan(cfg)["gate"]
        held.update(experts=on(g, 0), moe_d_ff=on(g, 2))
    if cfg.ssm is not None:
        s = ssm.ssm_plan(cfg)
        held.update(d_inner=on(s["w_x"], 1), ssm_heads=on(s["w_dt"], 1))
    return held


def _build_layout(cfg, mesh, hint_map: Dict) -> Layout:
    from repro_torch.models.param import mesh_shape

    shape = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    batch = hint_map.get("batch", ())
    batch_axes = (batch,) if isinstance(batch, str) else tuple(batch)
    if any(a not in shape or a == "model" for a in batch_axes):
        raise ValueError(f"batch hint {batch!r}: not batch axes of the mesh "
                         f"{shape}")
    n_batch, batch_rank = 1, 0
    for a in batch_axes:
        n_batch, batch_rank = n_batch * shape[a], batch_rank * shape[a] \
            + coord[a]

    def hinted(name):
        return hint_map.get(name) == "model"

    held = _held(cfg, mesh)
    flags = dict(held)
    if cfg.n_heads:
        flags["heads"] = hinted("heads")
        if held["kv_heads"] and not held["heads"]:
            raise NotImplementedError("kv heads sharded, q heads not")
    if cfg.d_ff and cfg.family != "moe":
        flags["d_ff"] = hinted("d_ff")
    if cfg.moe is not None:
        flags.update(experts=hinted("experts"),
                     moe_d_ff=hinted("d_ff") and not hinted("experts"),
                     moe_cap="moe_cap" in hint_map)
    if cfg.ssm is not None:
        if held["d_inner"] != held["ssm_heads"]:
            raise NotImplementedError(
                "the SSM's d_inner and its heads shard differently on this "
                "mesh (the model axis divides one and not the other): not "
                "ported (ROADMAP.md §1)")
        if held["ssm_heads"] and cfg.ssm.n_groups != 1:
            raise NotImplementedError("SSD heads sharded with n_groups > 1")
        flags.update(d_inner=hinted("d_inner"),
                     ssm_heads=hinted("ssm_heads"))
    wrong = sorted(k for k in held if flags[k] != held[k])
    if wrong:
        raise ValueError(
            f"the hints {hint_map} shard {[k for k in wrong if flags[k]]} "
            f"and not {[k for k in wrong if not flags[k]]} over 'model', "
            f"unlike the weights (serve_rules on {shape})")
    return Layout(model=shape.get("model", 1),
                  model_rank=coord.get("model", 0), batch_axes=batch_axes,
                  n_batch=n_batch, batch_rank=batch_rank, **flags)


def layout(cfg) -> Optional[Layout]:
    """What this rank runs of ``cfg`` under the active hints (a
    :class:`Layout`, built once per config, mesh and hint map), or None
    outside a hints context."""
    if not active():
        return None
    mesh, hint_map = _STATE["mesh"], _STATE["map"]
    key = (cfg, mesh, tuple(sorted(hint_map.items())))
    if key not in _LAYOUTS:
        _LAYOUTS[key] = _build_layout(cfg, mesh, hint_map)
    return _LAYOUTS[key]


def batch_shard(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """This rank's shard of a DTensor laid out over the batch axes, or of
    the whole batch (the same on every rank): its block of rows over
    ``lay``'s batch axes.  A serve call whose batch does not divide the
    batch axes runs under a layout with none (``train.server``), so the
    whole batch comes back; a layout whose axes do not divide the batch
    raises."""
    if hasattr(x, "to_local"):
        return x.to_local()
    if x.shape[0] % lay.n_batch:
        raise ValueError(f"a batch of {x.shape[0]} does not divide over "
                         f"the {lay.n_batch} shards of {lay.batch_axes}")
    return x.chunk(lay.n_batch)[lay.batch_rank]


def _groups(axes) -> list:
    mesh = _STATE["mesh"]
    return [mesh.get_group(a) for a in axes]


def _width(axes) -> int:
    """The number of ranks over the mesh ``axes``."""
    from repro_torch.models.param import mesh_shape

    shape = mesh_shape(_STATE["mesh"])
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _reduce(x: torch.Tensor, groups, op: str = "sum") -> torch.Tensor:
    """Sum (``op="max"``: the elementwise max of) ``x`` in place over each
    group (one counted ``all_reduce`` each); returns ``x``."""
    global ALL_REDUCES
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    for g in groups:
        dist.all_reduce(x, op=red, group=g)
        ALL_REDUCES += 1
        _issued("all-reduce", x, _group_size(g))
    return x


def _gather(x: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """Every rank's ``x`` over the groups joined along ``dim``, the first
    group the outer one (one counted ``all_gather`` a group)."""
    global ALL_GATHERS
    for g in reversed(groups):
        n = _group_size(g)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _gather_single(out, x, group=g)
        ALL_GATHERS += 1
        _issued("all-gather", out, n)
        x = torch.cat(out.chunk(n), dim) if n > 1 else out
    return x


def _scatter(x: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """Sum ``x`` over the groups and keep this rank's block along ``dim``
    (the first group the outer one): one counted ``reduce_scatter`` a
    group, the adjoint of :func:`_gather`."""
    global REDUCE_SCATTERS
    x = torch.movedim(x, dim, 0)
    for g in groups:
        n = _group_size(g)
        src = x.contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=g)
        REDUCE_SCATTERS += 1
        _issued("reduce-scatter", out, n)
        x = out
    return torch.movedim(x, 0, dim)


def _block(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over the mesh ``axes``
    (the first axis the outer one), as :func:`_gather` joins them."""
    from repro_torch.models.param import mesh_shape

    mesh = _STATE["mesh"]
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shape = mesh_shape(mesh)
    n, idx = 1, 0
    for a in axes:
        n, idx = n * shape[a], idx * shape[a] + coord[a]
    return x.chunk(n, dim)[idx]


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllReduce(torch.autograd.Function):
    """Sum over ``axes`` in place; backward the identity or, with
    ``bwd_sum``, the same sum (skipped over ranks of one)."""

    @staticmethod
    def forward(ctx, x, axes, bwd_sum):
        ctx.axes, ctx.bwd_sum = axes, bwd_sum
        _reduce(x, _groups(axes))
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd_sum and _width(ctx.axes) > 1:
            g = _reduce(g.clone(), _groups(ctx.axes))
        return g, None, None


class _CopyTo(torch.autograd.Function):
    """The identity; backward a sum over ``axes`` (skipped over ranks of
    one)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _width(ctx.axes) > 1:
            g = _reduce(g.clone(), _groups(ctx.axes))
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather over ``axes`` along ``dim``; backward this rank's block
    (``bwd="slice"``, the gradient downstream being the same on every
    rank) or a reduce-scatter (``bwd="scatter"``, the ranks' gradients
    summed)."""

    @staticmethod
    def forward(ctx, x, dim, axes, bwd):
        ctx.dim, ctx.axes, ctx.bwd = dim, axes, bwd
        return _gather(x, dim, _groups(axes))

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd == "slice":
            g = _block(g, ctx.dim, ctx.axes).contiguous()
        elif _width(ctx.axes) > 1:
            g = _scatter(g, ctx.dim, _groups(ctx.axes))
        return g, None, None, None


def all_reduce(x: torch.Tensor, axes=("model",),
               backward: str = "identity") -> torch.Tensor:
    """Sum ``x`` over the ranks of the mesh ``axes`` in ``x``'s dtype (one
    ``all_reduce`` an axis, each counted), in place; returns ``x``.  Under
    autograd the backward is ``backward``: ``"identity"`` (the sum feeds
    what every rank computes alike) or ``"sum"`` (module docstring)."""
    if backward not in ("identity", "sum"):
        raise ValueError(f"backward must be 'identity' or 'sum', got "
                         f"{backward!r}")
    axes = tuple(axes)
    if _needs_grad(x):
        return _AllReduce.apply(x, axes, backward == "sum")
    return _reduce(x, _groups(axes))


def all_max(x: torch.Tensor, axes) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of the mesh ``axes``
    (one counted ``all_reduce`` an axis), in place; returns ``x``.  No
    autograd: the decode-time softmax combine is its one use."""
    if _needs_grad(x):
        raise ValueError("all_max has no backward")
    return _reduce(x, _groups(tuple(axes)), op="max")


def copy_to(x: torch.Tensor, axes=("model",)) -> torch.Tensor:
    """The entry of a replicated ``x`` to this rank's share of an axis
    sharded over ``axes``: the identity, whose backward sums the ranks'
    partial gradients (Megatron's ``f``).  Outside autograd, or over ranks
    of one, ``x`` itself (the graph is then the unsharded one)."""
    if not _needs_grad(x) or _width(axes) == 1:
        return x
    return _CopyTo.apply(x, tuple(axes))


def unshard(x: torch.Tensor, dim: Optional[int], axes=("data",),
            sum_axes=()) -> torch.Tensor:
    """FSDP's gather of a leaf at its use: this rank's shard ``x``, sharded
    over ``axes`` along ``dim`` (None: held whole), joined over them; its
    backward reduce-scatters the gradient over ``axes`` (all-reduces it
    where ``dim`` is None), and sums it over ``sum_axes`` (the batch axes
    the leaf is replicated over).  Over ranks of one nothing is issued and
    ``x`` is used as it is."""
    axes, sum_axes = tuple(axes), tuple(sum_axes)
    if dim is None:
        sum_axes, axes = axes + sum_axes, ()
    if axes and _width(axes) > 1:
        x = _Gather.apply(x, dim, axes, "scatter") if _needs_grad(x) \
            else _gather(x, dim, _groups(axes))
    if sum_axes and _width(sum_axes) > 1:
        x = copy_to(x, sum_axes)
    return x


class _MixedMM(torch.autograd.Function):
    """``a @ w`` of bf16 or fp16 operands with float32 output (one
    rounding, after the sum over ranks); the backward in the operands'
    dtype, as autograd of one ``a @ w`` takes it."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        if a.is_cuda:
            return torch.mm(a, w, out_dtype=torch.float32)
        return a.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ w.T, a.T @ g


def row_parallel(a: torch.Tensor, w: torch.Tensor,
                 lay: Layout) -> torch.Tensor:
    """``a @ w`` where ``w`` holds this rank's rows of the contraction,
    all-reduced over ``model``.  On one rank the product is the unsharded
    one (the all-reduce the identity); on several a bf16 or fp16 product's
    partial sums are kept in float32 and rounded once, after the sum, as
    one product rounds once.  The all-reduce's backward is the identity."""
    if lay.model == 1 or a.dtype == torch.float32:
        return all_reduce(a @ w)
    a2 = a.reshape(-1, a.shape[-1])
    if _needs_grad(a2) or _needs_grad(w):
        part = _MixedMM.apply(a2, w)
    else:
        part = torch.mm(a2, w, out_dtype=torch.float32) if a.is_cuda \
            else a2.float() @ w.float()
    out = all_reduce(part).to(a.dtype)
    return out.reshape(*a.shape[:-1], w.shape[-1])


def all_gather(x: torch.Tensor, dim: int, axes=("model",)) -> torch.Tensor:
    """Every rank's ``x`` over the mesh ``axes`` joined along ``dim`` in
    mesh order (the first axis the outer one); one counted
    ``all_gather`` an axis.  Under autograd the backward keeps this
    rank's block of the gradient (the vocabulary gather's: the gradient
    downstream is the same on every rank)."""
    axes = tuple(axes)
    if _needs_grad(x):
        return _Gather.apply(x, dim, axes, "slice")
    return _gather(x, dim, _groups(axes))
