"""The LLM train step: forward and backward, OTA or exact aggregation, AdamW.

Counterpart of ``repro/train/trainer.py`` for the dense family.  The
paper's technique enters through one seam, the gradient aggregation:

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

Autograd sees each stacked layer leaf (``layers/...``, leading axis
``n_layers``) as one leaf per layer, unbound once a step, and stacks each
leaf's gradient once.  Indexing the stacked leaf in the forward instead
would make every layer's backward add a zero-filled gradient of the whole
stack.

:func:`make_psum_train_step` is the data-parallel form over an agent mesh
(JAX's ``shard_map`` step): each rank of the group is one agent, takes its
slice of the global batch, computes its gradient by autograd, and
``ota.aggregate(..., mesh=)`` in the ``"axis"`` form weights it by the
rank's gain (one K1 launch at ``(1, d)``, sigma 0), sums the ranks' rows in
one ``all_reduce`` (in the wire dtype when one is set, else the gradient's)
and runs K1's server pass at ``(1, d)`` (the noise and the debias over the
group size); clipping and AdamW follow as in :func:`make_train_step`.
Families other than dense raise.
"""
from __future__ import annotations

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
from repro_torch.utils.device import (
    DeviceLike, index_generator, make_generator,
)
from repro_torch.utils.tree import (
    fixed_sum, flatten_paths, replace_paths, tree_add, tree_scale,
)

Draws = Tuple[torch.Tensor, Any]     # (gains (N,), K1 seed)
TRAINED_FAMILIES = ("dense",)


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


def _check_family(model: Model) -> None:
    if model.cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"training family {model.cfg.family!r} is not ported; the port "
            f"trains {TRAINED_FAMILIES} (ROADMAP.md lists the rest)")


def init_state(model: Model, tcfg: TrainConfig,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> TrainState:
    """Parameters from ``generator`` (default: one seeded ``tcfg.seed`` on
    ``device``, which None makes cuda), zero moments, step 0."""
    _check_family(model)
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
    the materialised forward and :func:`lm_loss`, as the JAX trainer's."""
    _check_family(model)

    def loss_fn(params, mb, weights):
        na, per = mb["tokens"].shape[:2]
        fb = {k: v.reshape((na * per,) + v.shape[2:]) for k, v in mb.items()}
        logits, aux = transformer.forward(params, model.cfg, fb["tokens"],
                                          fb.get("memory"))
        w = None if weights is None else torch.repeat_interleave(weights, per)
        return lm_loss(logits, fb["labels"], w) + aux

    return loss_fn


def _autograd_leaves(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Leaves that require grad: a tensor per key, or for a stacked layer
    leaf the list of its layers (module docstring)."""
    return {k: ([x.requires_grad_() for x in v.detach().unbind(0)]
                if k.startswith("layers/") else v.detach().requires_grad_())
            for k, v in flat.items()}


def _grads(loss: torch.Tensor, leaves: Dict[str, Any]) -> Dict[str, Any]:
    """d loss / d leaves, each stacked leaf's layers stacked back."""
    inputs = [x for v in leaves.values()
              for x in (v if isinstance(v, list) else [v])]
    g, out = list(torch.autograd.grad(loss, inputs)), {}
    for k, v in leaves.items():
        if isinstance(v, list):
            out[k] = torch.stack(g[:len(v)])
            del g[:len(v)]
        else:
            out[k] = g.pop(0)
    return out


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch, draws=None) -> (state',
    metrics)``; ``metrics`` holds device scalars ``loss`` (de-scaled by the
    gain mean), ``grad_norm``, ``gain_mean`` and ``update_norm``.  The step
    writes into ``state``'s tensors and returns them (module docstring)."""
    opt = make_optimizer(tcfg)
    ota_cfg = tcfg.ota_config()
    loss_fn = make_loss_fn(model)
    n = tcfg.n_agents
    acc_dtype = (getattr(torch, tcfg.grad_accum_dtype)
                 if tcfg.grad_accum_dtype else None)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Draws] = None):
        flat = flatten_paths(state.params)
        dev = next(iter(flat.values())).device
        gains = seed = None
        if ota_cfg is not None:
            if draws is None:
                gen = index_generator(tcfg.seed, int(state.step), dev)
                gains = ota.sample_gains(ota_cfg, gen, n, dev)
                seed = ota.sample_seed(gen, dev)
            else:
                gains, seed = draws
                gains = gains.to(device=dev, dtype=torch.float32)

        leaves = _autograd_leaves(flat)
        tree = replace_paths(state.params, leaves)
        mbs = _agent_major(batch, n, tcfg.microbatch)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        grads = None
        for i in range(tcfg.microbatch):
            loss = loss_fn(tree, {k: v[i] for k, v in mbs.items()}, gains)
            g = {k: (x if acc_dtype is None else x.to(acc_dtype))
                 for k, x in _grads(loss, leaves).items()}
            loss_sum = loss_sum + loss.detach()
            grads = g if grads is None else tree_add(grads, g)
            del loss, g
        del leaves, tree
        inv = 1.0 / tcfg.microbatch
        loss = loss_sum * inv
        if tcfg.microbatch > 1:
            grads = tree_scale(grads, inv)

        # --- the paper's uplink: server AWGN + optional m_h debias --------
        if ota_cfg is not None:
            grads = ota.add_awgn(ota_cfg, seed, grads, n,
                                 backend=tcfg.ota_backend)

        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        state, upd_sq = _adamw_into(opt, state, flat, grads)

        gain_mean = (torch.mean(gains) if gains is not None
                     else torch.ones((), device=dev))
        metrics = {
            # the loss is channel-weighted; de-scale by the mean gain so the
            # reported value estimates the plain CE
            "loss": loss / torch.clamp(gain_mean, min=1e-6),
            "grad_norm": gnorm,
            "gain_mean": gain_mean,
            "update_norm": torch.sqrt(upd_sq),
        }
        return state, metrics

    return train_step


def _adamw_into(opt: Optimizer, state: TrainState,
                flat: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
                ) -> Tuple[TrainState, torch.Tensor]:
    """AdamW leaf by leaf in key order, written into the old state's
    tensors, so the step holds one leaf's new moments at a time; consumes
    ``grads``.  Returns the next state and the update's squared norm."""
    mu, nu, new_flat, upd_sq = {}, {}, {}, None
    st = state.opt_state
    for k in sorted(flat):
        upd, st_k = opt.update(
            {k: grads.pop(k)},
            OptState(step=st.step, mu={k: st.mu[k]}, nu={k: st.nu[k]}),
            {k: flat[k]})
        p_k = apply_updates({k: flat[k]}, upd)[k]
        sq = fixed_sum(torch.square(upd[k].float()).reshape(-1), -1)
        upd_sq = sq if upd_sq is None else upd_sq + sq
        for old, new in ((st.mu[k], st_k.mu[k]), (st.nu[k], st_k.nu[k]),
                         (flat[k], p_k)):
            old.copy_(new)
        mu[k], nu[k], new_flat[k] = st.mu[k], st.nu[k], flat[k]
        del upd, st_k, p_k
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
    _check_family(model)
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
        gains = seed = None
        if ota_cfg is not None:
            if draws is None:
                gen = index_generator(tcfg.seed, int(state.step), dev)
                gains = ota.sample_gains(ota_cfg, gen, w, dev)
                seed = ota.sample_seed(gen, dev)
            else:
                gains, seed = draws
                gains = gains.to(device=dev, dtype=torch.float32)

        local = {k: _rank_slice(v, mesh)[None] for k, v in batch.items()}
        leaves = _autograd_leaves(flat)
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
