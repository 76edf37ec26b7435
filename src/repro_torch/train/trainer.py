"""The LLM train step: forward and backward, OTA or exact aggregation, AdamW.

Counterpart of ``repro/train/trainer.py`` for every family.  The forward
is the differentiable one (``transformer.forward(..., differentiable=True)``:
``attend``, not K3, the encoder's and the hybrid's shared block's
included, and the SSM mixer's plain scan, not K4); the moe family's
load-balance loss is added to the CE, as JAX's ``lm_loss(...) + aux``; the
vlm and encdec families' ``memory`` rides in the batch.  One forward runs
over the whole microbatch, every agent's slice together, so the MoE
capacity is the JAX trainer's.  The paper's technique enters through one seam, the gradient
aggregation:

* ``aggregator="exact"`` — Algorithm 1: the batch gradient is the plain
  mean;
* ``aggregator="ota"`` — Algorithm 2: per-agent channel gains weight the
  per-sequence loss *before* autograd (so autograd gives ``(1/N) sum_i h_i
  g_i``), then the server AWGN ``n_k / N`` and the ``m_h`` debias are
  applied to the flattened gradient by ``ota.add_awgn``: one K1 launch
  over a ``(1, d)`` unit-gain row on the card.  Each contiguous slice of
  the batch is one agent.

Microbatching (gradient accumulation) uses the agent-major layout
``(n_micro, n_agents, per, ...)``.  The accumulation starts from the first
microbatch's gradient where JAX starts from zeros (``0 + g`` is ``g``).

Randomness: step ``k`` draws its gains, then the K1 seed, from
``utils.device.index_generator(seed, k)`` (JAX: ``fold_in(key, step)``),
so a resumed run takes the draws an uninterrupted one took; ``draws=(gains,
seed)`` injects them (the parity tests feed the JAX package's).

States: ``TrainState.params`` is the model's nested dict;
``opt_state``'s moments are flat dicts keyed by ``/``-joined parameter
paths (``utils.tree.flatten_paths``), so a checkpoint has the JAX
package's key paths (``opt_state/mu/embed/tok``); ``step`` is an int32
scalar on the host, so reading it costs no device synchronisation.

A train step consumes its state: it writes the new parameters and
moments into the old state's tensors, one leaf at a time, as JAX's buffer
donation does, so a step holds one state (at llama3.2-3b's full width two
states of bf16 parameters and float32 moments do not fit one NVIDIA H100
80GB HBM3 beside the gradients).  The returned state holds the same
tensors.

Autograd sees each stacked layer leaf as one leaf per layer, unbound once
a step, and stacks each leaf's gradient once.  Which leaves are stacked,
and over how many axes, the plan's declarations say: the leading axes
named in ``transformer.STACK_AXES`` (``layers``; the hybrid's and vlm's
groups also ``sublayers``, unbound over both).  Indexing the stacked leaf
in the forward instead would make every layer's backward add a
zero-filled gradient of the whole stack.  The hybrid's ``shared`` block is
one leaf; its gradient sums over its uses.

:func:`make_psum_train_step` is the data-parallel form over an agent mesh
(JAX's ``shard_map`` step): each rank of the group is one agent, takes its
slice of the global batch, computes its gradient by autograd, and
``ota.aggregate(..., mesh=)`` in the ``"axis"`` form weights it by the
rank's gain (one K1 launch at ``(1, d)``, sigma 0), sums the ranks' rows in
one ``all_reduce`` (in the wire dtype when one is set, else the gradient's)
and runs K1's server pass at ``(1, d)`` (the noise and the debias over the
group size); clipping and AdamW follow as in :func:`make_train_step`.

:func:`shard_for_training` is the tensor-parallel production step (JAX's
``make_train_step`` as ``launch/dryrun.py`` lowers it on a ``("data",
"model")`` mesh): the state laid out by ``train_rules(fsdp=True)``, each
data shard one group of agents, the model on each rank's shards with
autograd collectives (``utils/shard_hints.py``), K1 over the rank's row
of shards with the unsharded step's noise, and the same function as
:func:`make_train_step` (on one rank, bit for bit).
"""
from __future__ import annotations

import collections
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import ota
from repro_torch.core.channel import make_channel, noise_sigma_from_db
from repro_torch.launch.mesh import AgentMesh
from repro_torch.models.layers import lm_loss
from repro_torch.models.model import Model
from repro_torch.models import transformer
from repro_torch.optim.optimizers import (
    OptState, Optimizer, adamw, apply_updates, clip_by_global_norm,
    warmup_cosine,
)
from repro_torch.utils import shard_hints
from repro_torch.utils.device import (
    DeviceLike, index_generator, make_generator,
)
from repro_torch.utils.tree import (
    fixed_sum, flatten_paths, replace_paths, tree_add, tree_scale,
)

Draws = Tuple[torch.Tensor, Any]     # (gains (N,), K1 seed)


@dataclass(frozen=True)
class TrainConfig:
    # paper technique ------------------------------------------------------
    aggregator: str = "ota"            # "exact" (Alg. 1) | "ota" (Alg. 2)
    channel: str = "rayleigh"
    channel_kwargs: Tuple = ()
    noise_db: float = -60.0            # sigma^2 of the uplink AWGN, in dB
    debias: bool = True                # divide aggregated grad by m_h
    n_agents: int = 16                 # data-parallel replica groups
    # optimisation ---------------------------------------------------------
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatch: int = 1                # gradient-accumulation steps
    grad_accum_dtype: str = ""         # "" = param dtype; "float32" for exact
    seed: int = 0
    # uplink implementation ------------------------------------------------
    ota_backend: str = "auto"          # "torch" | "cuda" | "auto"
    wire_dtype: str = ""               # K1's uplink payload ("bfloat16")

    def __post_init__(self):
        ota.AggregateSpec(backend=self.ota_backend)   # validates it

    def ota_config(self) -> Optional[ota.OTAConfig]:
        if self.aggregator == "exact":
            return None
        if self.aggregator != "ota":
            raise ValueError(f"unknown aggregator {self.aggregator!r}")
        return ota.OTAConfig(
            channel=make_channel(self.channel, **dict(self.channel_kwargs)),
            noise_sigma=noise_sigma_from_db(self.noise_db),
            debias=self.debias, wire_dtype=self.wire_dtype)


class TrainState(NamedTuple):
    params: Any              # the model's nested dict
    opt_state: OptState      # moments keyed by parameter path
    step: torch.Tensor       # int32 scalar on the host


def make_optimizer(tcfg: TrainConfig) -> Optimizer:
    sched = warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.total_steps)
    return adamw(sched, weight_decay=tcfg.weight_decay)


def init_state(model: Model, tcfg: TrainConfig,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> TrainState:
    """Parameters from ``generator`` (default: one seeded ``tcfg.seed`` on
    ``device``, which None makes cuda), zero moments, step 0."""
    gen = generator or make_generator(tcfg.seed, device)
    params = model.init(gen, device if generator is None else gen.device)
    return TrainState(params=params,
                      opt_state=make_optimizer(tcfg).init(
                          flatten_paths(params)),
                      step=torch.zeros((), dtype=torch.int32))


def _agent_major(batch: Dict[str, torch.Tensor], n_agents: int,
                 n_micro: int) -> Dict[str, torch.Tensor]:
    """(B, ...) -> (n_micro, n_agents, B/(N*mu), ...), agent i keeping the
    i-th contiguous slice of the batch."""

    def _r(x):
        per = x.shape[0] // n_agents
        if per % n_micro:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{n_agents} agents x {n_micro} microbatches")
        y = x.reshape((n_agents, n_micro, per // n_micro) + x.shape[1:])
        return torch.movedim(y, 1, 0)

    return {k: _r(v) for k, v in batch.items()}


def make_loss_fn(model: Model) -> Callable:
    """loss(params, microbatch, weights) over (n_agents, per, ...) batches:
    the differentiable forward over the flattened ``n_agents * per``
    sequences and :func:`lm_loss` + aux, as the JAX trainer's."""

    def loss_fn(params, mb, weights):
        na, per = mb["tokens"].shape[:2]
        fb = {k: v.reshape((na * per,) + v.shape[2:]) for k, v in mb.items()}
        logits, aux = transformer.forward(params, model.cfg, fb["tokens"],
                                          fb.get("memory"),
                                          differentiable=True)
        w = None if weights is None else torch.repeat_interleave(weights, per)
        return lm_loss(logits, fb["labels"], w) + aux

    return loss_fn


def _stack_depth(decl) -> int:
    """How many leading axes of a declared leaf are stacked layers."""
    n = 0
    while n < len(decl.axes) and decl.axes[n] in transformer.STACK_AXES:
        n += 1
    return n


def _autograd_leaves(flat: Dict[str, torch.Tensor],
                     plan) -> Dict[str, Any]:
    """Leaves that require grad: a tensor per key, or for a stacked leaf
    the (nested, one level a stacked axis) list of its layers; ``plan`` is
    the model's (module docstring)."""
    depth = {k: _stack_depth(d) for k, d in flatten_paths(plan).items()}

    def unbind(x, n):
        if n == 0:
            return x.requires_grad_()
        return [unbind(y, n - 1) for y in x.unbind(0)]

    return {k: unbind(v.detach(), depth[k]) for k, v in flat.items()}


def _nested(v) -> list:
    """The tensors of a leaf, a stacked leaf's in layer order."""
    return [x for y in v for x in _nested(y)] if isinstance(v, list) else [v]


def _grads(loss: torch.Tensor, leaves: Dict[str, Any]) -> Dict[str, Any]:
    """d loss / d leaves, each stacked leaf's layers stacked back (in one
    copy, whatever its number of stacked axes).  Each layer's gradient is
    released once it is stacked, so at most one leaf is held twice."""
    inputs = [x for v in leaves.values() for x in _nested(v)]
    g, out = collections.deque(torch.autograd.grad(loss, inputs)), {}
    for k, v in leaves.items():
        lead = []
        while isinstance(v, list):
            lead.append(len(v))
            v = v[0]
        out[k] = (torch.stack([g.popleft() for _ in range(math.prod(lead))])
                  .unflatten(0, lead) if lead else g.popleft())
    return out


def _step_draws(ota_cfg, tcfg: TrainConfig, step: int, n: int, dev,
                draws: Optional[Draws]):
    """Step ``step``'s ``n`` gains, then its K1 seed, from
    ``index_generator(tcfg.seed, step)``, or ``draws`` injected; ``(None,
    None)`` for the exact uplink."""
    if ota_cfg is None:
        return None, None
    if draws is None:
        gen = index_generator(tcfg.seed, step, dev)
        return ota.sample_gains(ota_cfg, gen, n, dev), \
            ota.sample_seed(gen, dev)
    gains, seed = draws
    return gains.to(device=dev, dtype=torch.float32), seed


def _accumulate(loss_fn: Callable, tree_of: Callable, leaves, mbs,
                weights, tcfg: TrainConfig, dev, scale: float = 1.0):
    """The mean loss and mean gradients (of ``leaves``) over the agent-major
    microbatches ``mbs``; ``tree_of()`` is the parameter tree a
    microbatch's forward reads, ``scale`` multiplies each loss before
    autograd (not the loss returned)."""
    acc_dtype = (getattr(torch, tcfg.grad_accum_dtype)
                 if tcfg.grad_accum_dtype else None)
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    grads = None
    for i in range(tcfg.microbatch):
        loss = loss_fn(tree_of(), {k: v[i] for k, v in mbs.items()}, weights)
        obj = loss if scale == 1.0 else loss * scale
        g = {k: (x if acc_dtype is None else x.to(acc_dtype))
             for k, x in _grads(obj, leaves).items()}
        loss_sum = loss_sum + loss.detach()
        grads = g if grads is None else tree_add(grads, g)
        del loss, obj, g
    inv = 1.0 / tcfg.microbatch
    if tcfg.microbatch > 1:
        grads = tree_scale(grads, inv)
    return loss_sum * inv, grads


def _metrics(loss, gnorm, gains, upd_sq, dev) -> Dict[str, torch.Tensor]:
    gain_mean = (torch.mean(gains) if gains is not None
                 else torch.ones((), device=dev))
    return {
        # the loss is channel-weighted; de-scale by the mean gain so the
        # reported value estimates the plain CE
        "loss": loss / torch.clamp(gain_mean, min=1e-6),
        "grad_norm": gnorm,
        "gain_mean": gain_mean,
        "update_norm": torch.sqrt(upd_sq),
    }


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch, draws=None) -> (state',
    metrics)``; ``metrics`` holds device scalars ``loss`` (de-scaled by the
    gain mean), ``grad_norm``, ``gain_mean`` and ``update_norm``.  The step
    writes into ``state``'s tensors and returns them (module docstring)."""
    opt = make_optimizer(tcfg)
    ota_cfg = tcfg.ota_config()
    loss_fn = make_loss_fn(model)
    n = tcfg.n_agents

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Draws] = None):
        flat = flatten_paths(state.params)
        dev = next(iter(flat.values())).device
        gains, seed = _step_draws(ota_cfg, tcfg, int(state.step), n, dev,
                                  draws)
        leaves = _autograd_leaves(flat, model.plan)
        tree = replace_paths(state.params, leaves)
        loss, grads = _accumulate(loss_fn, lambda: tree, leaves,
                                  _agent_major(batch, n, tcfg.microbatch),
                                  gains, tcfg, dev)
        del leaves, tree

        # --- the paper's uplink: server AWGN + optional m_h debias --------
        if ota_cfg is not None:
            grads = ota.add_awgn(ota_cfg, seed, grads, n,
                                 backend=tcfg.ota_backend)

        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        state, upd_sq = _adamw_into(opt, state, flat, grads)
        return state, _metrics(loss, gnorm, gains, upd_sq, dev)

    return train_step


def _adamw_into(opt: Optimizer, state: TrainState,
                flat: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                counted=None) -> Tuple[TrainState, torch.Tensor]:
    """AdamW leaf by leaf in key order, written into the old state's
    tensors, so the step holds one leaf's new moments at a time; consumes
    ``grads``.  Returns the next state and the update's squared norm (over
    the keys in ``counted``, default all)."""
    mu, nu, new_flat, upd_sq = {}, {}, {}, None
    st = state.opt_state
    for k in sorted(flat):
        upd, st_k = opt.update(
            {k: grads.pop(k)},
            OptState(step=st.step, mu={k: st.mu[k]}, nu={k: st.nu[k]}),
            {k: flat[k]})
        p_k = apply_updates({k: flat[k]}, upd)[k]
        if counted is None or k in counted:
            sq = fixed_sum(torch.square(upd[k].float()).reshape(-1), -1)
            upd_sq = sq if upd_sq is None else upd_sq + sq
        for old, new in ((st.mu[k], st_k.mu[k]), (st.nu[k], st_k.nu[k]),
                         (flat[k], p_k)):
            old.copy_(new)
        mu[k], nu[k], new_flat[k] = st.mu[k], st.nu[k], flat[k]
        del upd, st_k, p_k
    if upd_sq is None:
        upd_sq = torch.zeros((), dtype=torch.float32, device=st.step.device)
    return TrainState(params=replace_paths(state.params, new_flat),
                      opt_state=OptState(step=st.step + 1, mu=mu, nu=nu),
                      step=state.step + 1), upd_sq


def _rank_slice(x: torch.Tensor, mesh: AgentMesh) -> torch.Tensor:
    """Rank r's contiguous slice of a global batch's leading axis."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"global batch {x.shape[0]} does not split into "
                         f"{mesh.size} ranks")
    per = x.shape[0] // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def make_psum_train_step(model: Model, tcfg: TrainConfig,
                         mesh: AgentMesh) -> Callable:
    """The data-parallel OTA train step over an agent mesh (module
    docstring; JAX ``make_psum_train_step``): ``train_step(state, batch,
    draws=None) -> (state', metrics)`` on every rank, ``batch`` the global
    batch (the same on every rank), ``state`` on the rank's device.  The
    group's ranks are the agents (``tcfg.n_agents`` is not read): step
    ``k`` draws the group's gains, then the K1 seed, from
    ``index_generator(tcfg.seed, k)`` on every rank, and rank r takes gain
    r; ``draws=(gains (W,), seed)`` injects them.  ``aggregator="exact"``
    averages the ranks' gradients (one ``all_reduce``, no K1).  No
    microbatching.  ``metrics``: ``loss`` (the ranks' mean, one more
    ``all_reduce`` of a scalar), ``grad_norm``, ``gain_mean`` (of the
    group's gains) and ``update_norm``; every rank holds the same state
    after the step, which it writes into ``state``'s tensors."""
    if tcfg.microbatch != 1:
        raise ValueError("make_psum_train_step takes no microbatching "
                         "(microbatch=1)")
    opt = make_optimizer(tcfg)
    ota_cfg = tcfg.ota_config()
    loss_fn = make_loss_fn(model)
    w = mesh.size

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Draws] = None):
        flat = flatten_paths(state.params)
        dev = mesh.device
        gains, seed = _step_draws(ota_cfg, tcfg, int(state.step), w, dev,
                                  draws)

        local = {k: _rank_slice(v, mesh)[None] for k, v in batch.items()}
        leaves = _autograd_leaves(flat, model.plan)
        loss = loss_fn(replace_paths(state.params, leaves), local, None)
        grads, _ = ota.aggregate(_grads(loss, leaves), ota_cfg, mesh=mesh,
                                 gains=gains, seed=seed,
                                 backend=tcfg.ota_backend)
        del leaves
        loss = mesh.all_reduce(loss.detach().float().reshape(1))[0] / w

        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        state, upd_sq = _adamw_into(opt, state, flat, grads)
        gain_mean = (torch.mean(gains) if gains is not None
                     else torch.ones((), device=dev))
        metrics = {"loss": loss, "grad_norm": gnorm, "gain_mean": gain_mean,
                   "update_norm": torch.sqrt(upd_sq)}
        return state, metrics

    return train_step


# --------------------------------------------------------------------------
# The sharded train step: FSDP over data, tensor parallelism over model
# --------------------------------------------------------------------------

def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


class _Gathered(list):
    """A stacked leaf's layers (a list; nested for two stacked axes) whose
    tensors are FSDP-gathered at their use: ``transformer.layer`` indexes
    it once a layer, and each index gathers that layer's shards."""

    def __init__(self, items, unshard):
        super().__init__(items)
        self._unshard = unshard

    def __getitem__(self, i):
        x = list.__getitem__(self, i)
        return x if isinstance(x, list) else self._unshard(x)


def _gathered(v, unshard):
    """An autograd leaf as the model sees it: a tensor gathered now, a
    stacked leaf's layers gathered at their use."""
    if isinstance(v, list):
        return _Gathered([_gathered(y, unshard) if isinstance(y, list)
                          else y for y in v], unshard)
    return unshard(v)


@dataclass(eq=False)
class ShardedTrainer:
    """What :func:`shard_for_training` builds once: the mesh, the hints,
    this rank's layout, each leaf's FSDP gather, the keys this rank counts
    in a global norm and K1's counter map of its row."""

    model: Model
    tcfg: TrainConfig
    mesh: Any
    hint_map: Dict
    layout: Any
    unshard: Dict[str, Callable]
    counted: frozenset
    counter_map: Any

    def hints(self):
        return shard_hints.hints(self.mesh, **self.hint_map)

    def loss_and_grads(self, params, flat: Dict[str, torch.Tensor],
                       batch: Dict[str, torch.Tensor],
                       gains: Optional[torch.Tensor]):
        """The data ranks' mean loss and this rank's gradient shards (each
        leaf's local block, before the uplink) of ``params`` (the state's
        tree), ``flat`` its local tensors by path, at ``batch`` (whole or
        DTensors) under the step's ``gains`` (None: the exact mean)."""
        lay, tcfg = self.layout, self.tcfg
        per = tcfg.n_agents // lay.n_batch
        dev = next(iter(flat.values())).device
        leaves = _autograd_leaves(flat, self.model.plan)
        mbs = _agent_major({k: shard_hints.batch_shard(v, lay)
                            for k, v in batch.items()}, per, tcfg.microbatch)
        with self.hints():
            loss, grads = _accumulate(
                make_loss_fn(self.model), lambda: replace_paths(params, {
                    k: _gathered(v, self.unshard[k])
                    for k, v in leaves.items()}),
                leaves, mbs,
                None if gains is None else
                gains[lay.batch_rank * per:(lay.batch_rank + 1) * per],
                tcfg, dev,
                # the data ranks' losses sum to the global-mean loss
                scale=1.0 / lay.n_batch)
            del leaves
            loss = shard_hints.all_reduce(loss, lay.batch_axes)
            if lay.n_batch > 1:
                loss = loss / lay.n_batch
        return loss, grads


def _leaf_unshard(spec, depth: int, batch_axes) -> Callable:
    """The FSDP gather of one leaf's layer (its stacked axes indexed
    away): along the dimension its spec shards over the batch axes, and
    its gradient summed over the batch axes it is replicated on."""
    from repro_torch.models.param import entry_axes

    dim = next((i for i, e in enumerate(spec)
                if set(entry_axes(e)) & set(batch_axes)), None)
    if dim is None:
        return lambda x: shard_hints.unshard(x, None, (), batch_axes)
    axes = entry_axes(spec[dim])
    rest = tuple(a for a in batch_axes if a not in axes)
    return lambda x: shard_hints.unshard(x, dim - depth, axes, rest)


def distribute_state(state: TrainState, plan, rules, mesh) -> TrainState:
    """A train state of whole tensors (the same on every rank) as DTensors
    on the ``DeviceMesh`` per ``rules``: the params and both moments laid
    out alike, each rank keeping its shards; the steps stay as they
    are."""
    from repro_torch.models.param import distribute_flat, distribute_params

    st = state.opt_state
    return TrainState(
        params=distribute_params(state.params, plan, rules, mesh),
        opt_state=OptState(step=st.step,
                           mu=distribute_flat(st.mu, plan, rules, mesh),
                           nu=distribute_flat(st.nu, plan, rules, mesh)),
        step=state.step)


def shard_for_training(model: Model, tcfg: TrainConfig, state: TrainState,
                       mesh) -> Tuple[TrainState, Callable]:
    """The sharded train step of ``model`` on a ``("data", "model")``
    ``DeviceMesh`` (JAX: ``launch/dryrun.py``'s ``build_train_lowering``,
    ``make_train_step`` partitioned under ``train_rules(fsdp=True)``).

    Returns ``(state, train_step)``: ``state`` (whole tensors, the same on
    every rank, or DTensors already laid out) as DTensors under
    ``train_rules(fsdp=True)``, the params and both moments alike, each
    rank keeping its shards; ``train_step(state, batch, draws=None) ->
    (state', metrics)`` computes :func:`make_train_step`'s function with
    the same ``n_agents``, on every rank:

    * ``batch``: the whole batch (each rank takes its shard over the data
      axes) or DTensors laid out by ``data.make_batch_specs``;
    * data rank ``r`` holds agents ``[r A, (r + 1) A)``, ``A = n_agents /
      n_data_shards(mesh)``, in the agent-major layout inside its shard;
      microbatching as in :func:`make_train_step`;
    * step ``k`` draws the gains and the K1 seed from
      ``index_generator(tcfg.seed, k)`` on every rank (``draws`` injects
      them), so they are the unsharded step's;
    * the forward runs inside ``hints(mesh, **attn_hints(cfg, mesh,
      "train"))`` on the rank's shards, each leaf's ``data`` shards
      gathered at its use (``shard_hints.unshard``, a reduce-scatter in
      backward), and each rank's loss scaled by ``1 / n_data`` so that the
      ranks' losses sum to the global-mean loss (the MoE load-balance
      loss, the same on every data rank, included);
    * the server AWGN over the rank's row of shards in one K1 launch (its
      counter map: each element's noise is the unsharded step's at that
      element), the global norm and the update norm over the mesh (each
      distinct block counted once), AdamW on the local shards, written
      into them;
    * ``metrics``: ``loss`` the data ranks' mean, de-scaled by the gain
      mean; ``grad_norm``, ``gain_mean``, ``update_norm`` over the mesh;
      the same on every rank.

    On a ``(1, 1)`` mesh the step is the unsharded one, bit for bit.
    Every family is sharded; the hybrid's ``shared`` leaves are gathered
    once a microbatch and used at each group, so autograd sums their uses'
    gradients before the one reduce-scatter.  Raises
    ``NotImplementedError`` for a layout not ported
    (``shard_hints.Layout``) and ``ValueError`` for an ``n_agents`` that
    is not a multiple of the data shards.  ``train_step.sharded`` is the :class:`ShardedTrainer` it
    runs (its layout, counter map and the keys it counts in a norm)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import n_data_shards
    from repro_torch.models.param import (
        held_once, shard_block, spec_for, train_rules,
    )

    cfg = model.cfg
    n_data = n_data_shards(mesh)
    if tcfg.n_agents % n_data:
        raise ValueError(f"n_agents = {tcfg.n_agents} is not a multiple of "
                         f"the {n_data} data shards of the mesh")
    rules = train_rules(fsdp=True)
    hint_map = shard_hints.attn_hints(cfg, mesh, "train")
    with shard_hints.hints(mesh, **hint_map):
        lay = shard_hints.layout(cfg)     # raises for what is not sharded
    decls = flatten_paths(flatten_paths(model.plan))
    specs = {k: spec_for(d, rules, mesh) for k, d in decls.items()}
    trainer = ShardedTrainer(
        model=model, tcfg=tcfg, mesh=mesh, hint_map=hint_map, layout=lay,
        unshard={k: _leaf_unshard(specs[k], _stack_depth(d), lay.batch_axes)
                 for k, d in decls.items()},
        counted=frozenset(k for k in decls if held_once(specs[k], mesh)),
        counter_map=ota.shard_counter_map(
            [decls[k].shape for k in decls],
            [shard_block(decls[k].shape, specs[k], mesh) for k in decls]))
    if not any(hasattr(v, "to_local")
               for v in flatten_paths(state.params).values()):
        state = distribute_state(state, model.plan, rules, mesh)
    return state, _sharded_step(trainer, dist.group.WORLD)


def _sharded_step(tr: ShardedTrainer, world) -> Callable:
    import torch.distributed as dist

    tcfg = tr.tcfg
    opt = make_optimizer(tcfg)
    ota_cfg = tcfg.ota_config()
    n = tcfg.n_agents

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Draws] = None):
        flat = {k: _local(v) for k, v in flatten_paths(state.params).items()}
        st = state.opt_state
        local_state = TrainState(
            params=state.params,
            opt_state=OptState(step=st.step,
                               mu={k: _local(v) for k, v in st.mu.items()},
                               nu={k: _local(v) for k, v in st.nu.items()}),
            step=state.step)
        dev = next(iter(flat.values())).device
        gains, seed = _step_draws(ota_cfg, tcfg, int(state.step), n, dev,
                                  draws)
        loss, grads = tr.loss_and_grads(state.params, flat, batch, gains)
        if ota_cfg is not None:
            grads = ota.add_awgn(ota_cfg, seed, grads, n,
                                 backend=tcfg.ota_backend,
                                 counter_map=tr.counter_map)
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm, tr.counted,
                                           world)
        new, upd_sq = _adamw_into(opt, local_state, flat, grads, tr.counted)
        dist.all_reduce(upd_sq, op=dist.ReduceOp.SUM, group=world)
        return TrainState(params=state.params,
                          opt_state=OptState(step=new.opt_state.step,
                                             mu=st.mu, nu=st.nu),
                          step=new.step), _metrics(loss, gnorm, gains,
                                                   upd_sq, dev)

    train_step.sharded = tr
    return train_step
