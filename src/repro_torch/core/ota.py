"""Over-the-air aggregation (Eq. 6-7), stacked form.

Counterpart of ``repro/core/ota.py`` for the form the RL loops use: per-agent
gradient dicts stacked on a leading N axis.  The channel superposes the
agents' signals, ``v_k = sum_i h_{i,k} g_i + n_k``, and the server applies
``theta <- theta - alpha * u_k`` with ``u_k = v_k * scale`` and
``scale = 1 / (N * m_h)`` under ``debias`` (``1 / N`` otherwise).

Backends (:class:`AggregateSpec`):

* ``"torch"`` — the plain PyTorch chain over the dict leaves
  (:func:`_aggregate_stacked_torch`, the counterpart of the XLA chain);
* ``"cuda"``  — the hand-written kernel K1 over the flattened parameter
  vector (``repro_torch.kernels.ota_fused``); a CPU tensor raises;
* ``"auto"``  — the kernel for CUDA tensors, the plain chain on the CPU.

Random streams: each noisy round draws the gains ``h`` and then one uint32
kernel seed from the round's ``torch.Generator``.  Both backends take their
AWGN from the kernel's counter PRNG keyed on that seed and the absolute flat
index, so the two backends see the same gains and the same noise for the
same generator state.  ``gains=`` and ``seed=`` inject the draws (the parity
tests feed the JAX package's own).  ``power_control`` shapes the transmit
power, so the effective gain is ``h = c * p(c)`` and a debiased update
divides by the effective mean (``repro_torch.core.power_control``).

``agent_blocks`` streams the agent axis (:func:`stream_fold_block`): the
superposition is a strict sequential left fold ``acc + h_0 g_0 + h_1 g_1 +
...`` over blocks of agents, then one server tail (:func:`stream_finalize`),
so the result is bitwise the same for every block size.  On the ``cuda``
backend one K1 launch folds a whole block: K1's ``agg`` mode folds its rows
from zero in order, so the stack ``[acc; g_block]`` with gains ``[1;
h_block]``, sigma 0 and scale 1 gives ``acc + h_0 g_0 + ...`` with the
roundings of the per-agent fold (``0 + 1 * acc`` is ``acc`` exactly).  The
tail is K1's unit-gain server pass.  The lane-batched run folds many runs'
blocks in one launch of K1's lane form (``core/lanes.py``).

The axis forms (``mesh=``, JAX's ``axis=`` forms inside ``shard_map``) run
on every rank of an agent mesh (``launch.mesh.AgentMesh``): ``"axis"``
(one agent a rank, ``local_stack=False``) and ``"axis_stacked"`` (a stack
of the rank's agents, streamed with ``agent_blocks``, exact with
``cfg=None``).  A rank folds its gain-weighted rows into one float32
partial sum (one K1 launch, sigma 0, scale 1), the sums meet in ONE
``all_reduce`` in the gradient's dtype (JAX psums in it; in the wire
dtype when the uplink has one), and every rank runs K1's unit-gain server
pass over the sum with the same seed, so every
rank adds the server's one noise draw with no broadcast.  Every rank draws
the whole fleet's gains (or takes them injected) and uses its own; rows of
a padded local stack whose global index is past ``n_agents`` are phantoms
and fold exact zeros; every normaliser uses the true count.  Over-the-air
aggregation adds no communication volume over exact data-parallel
aggregation: the gains weight the rows before the one sum.

The LLM trainer's form (the channel-weighted loss, JAX's Form 3) is
:func:`example_weights` and :func:`add_awgn`: the gains enter the loss
before autograd, and the server tail is one K1 launch over the flattened
gradient as a ``(1, d)`` unit-gain row.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.channel import Channel
from repro_torch.core.power_control import PowerPolicy, effective_moments
from repro_torch.kernels import ota_fused, ref
from repro_torch.launch.mesh import AgentMesh
from repro_torch.utils.tree import (
    Params, _unflattener, fixed_sum, flat_norm_sq, flatten_agent_stack,
    flatten_params, flatten_paths, replace_paths, theta_device, tree_keys,
)

Seed = Union[int, torch.Tensor]


@dataclass(frozen=True)
class OTAConfig:
    """Static configuration of the over-the-air uplink.

    ``power_control`` shapes the transmit power so the effective gain is
    ``h = c * p(c)``; with ``debias=True`` the update is then divided by the
    effective mean ``E[c p(c)]`` (:meth:`norm_const_for`).
    ``update_scale`` overrides the server normalisation ``1 / (N * m_h)``;
    ``wire_dtype="bfloat16"`` narrows the uplink payload on the kernel path
    (compute and the parameter master copy stay float32)."""

    channel: Channel
    noise_sigma: float = 0.0   # sigma of the AWGN on the *sum* (Eq. 6)
    debias: bool = False       # divide by m_h (unbiased grad estimate)
    power_control: Optional[PowerPolicy] = None
    update_scale: Optional[float] = None
    wire_dtype: str = ""       # "" (native) | "bfloat16"

    def __post_init__(self):
        if self.power_control is not None \
                and not isinstance(self.power_control, PowerPolicy):
            raise TypeError(f"power_control must be a PowerPolicy, got "
                            f"{type(self.power_control).__name__}")
        if self.wire_dtype not in ("", "bfloat16"):
            raise ValueError(f"wire_dtype must be '' or 'bfloat16', got "
                             f"{self.wire_dtype!r}")
        if self.debias and self.update_scale is None \
                and not math.isfinite(self.channel.mean):
            raise ValueError(
                f"debias=True needs a finite channel mean, got "
                f"m_h={self.channel.mean!r}; build power-controlled channels "
                f"with make_controlled_channel so their effective moments "
                f"are computed")

    @property
    def norm_const(self) -> float:
        """The raw-channel debias normaliser m_h (1 without debias); the
        aggregation uses :meth:`norm_const_for`, which folds in
        ``power_control``."""
        return self.channel.mean if self.debias else 1.0

    def norm_const_for(self, n_agents: Optional[int] = None) -> float:
        """The normaliser the aggregation divides by: the effective mean
        ``E[c p(c)]`` when ``power_control`` is set (closed form or the
        fixed-seed Monte Carlo of ``effective_moments``), the channel mean
        otherwise.  ``n_agents`` is needed by per-agent policies."""
        if not self.debias or self.power_control is None:
            return self.norm_const
        return effective_moments(self.channel, self.power_control,
                                 n_agents=n_agents)[0]


_BACKENDS = ("auto", "torch", "cuda")


@dataclass(frozen=True)
class AggregateSpec:
    """One aggregation call: ``exact`` (Algorithm 1's plain mean) and the
    ``backend`` (``"torch"`` | ``"cuda"`` | ``"auto"``)."""

    exact: bool = False
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; one of {_BACKENDS}")

    def resolved_backend(self, device: torch.device) -> str:
        """The backend this spec runs on for tensors on ``device``."""
        if self.exact:
            return "torch"
        if self.backend == "auto":
            return "cuda" if device.type == "cuda" else "torch"
        if self.backend == "cuda" and device.type != "cuda":
            raise ValueError(f"backend='cuda' needs CUDA tensors, got "
                             f"{device} (use backend='auto' or 'torch')")
        return self.backend


def sample_gains(cfg: OTAConfig, generator: torch.Generator, n_agents: int,
                 device) -> torch.Tensor:
    """h_{i,k} for every agent for one round: shape (n_agents,).  With
    power control the effective gain is ``h = c * p(c)``."""
    c = cfg.channel.sample(generator, (n_agents,), device)
    if cfg.power_control is not None:
        c = c * cfg.power_control.apply(c)
    return c


def flat_signal_power_sq(flat: torch.Tensor, gains: torch.Tensor,
                         sizes) -> torch.Tensor:
    """``||sum_i h_i g_i||^2`` of flat ``(..., N, P)`` stacks with ``(...,
    N)`` gains (leaf slices of ``sizes``): the agent sum and each leaf's
    squares in the fixed order of ``fixed_sum``, so a lane of a batched run
    gets a run's bits."""
    v = fixed_sum(gains.float().unsqueeze(-1) * flat, -2)
    return flat_norm_sq(v, sizes)


def signal_power_sq(grads_stacked: Params,
                    gains: torch.Tensor) -> torch.Tensor:
    """``||sum_i h_i g_i||^2``, the received signal power of one uplink;
    the telemetry SNR probe divides it by ``d * sigma^2``."""
    flat, _, _ = flatten_agent_stack(grads_stacked)
    sizes = [int(grads_stacked[k][0].numel()) for k in tree_keys(grads_stacked)]
    return flat_signal_power_sq(flat, gains, sizes)


def effective_gain_mean(cfg: Optional[OTAConfig],
                        n_agents: Optional[int] = None) -> float:
    """The effective gain mean m_h a config realises (what ``mean(h)``
    estimates): 1 for the exact uplink, the mean a debiased ``update_scale``
    implies, the channel mean without power control, else the closed-form /
    Monte-Carlo ``effective_moments``."""
    if cfg is None:
        return 1.0
    if cfg.debias and cfg.update_scale is not None and n_agents is not None:
        return 1.0 / (n_agents * cfg.update_scale)
    if cfg.power_control is None:
        return cfg.channel.mean
    return effective_moments(cfg.channel, cfg.power_control,
                             n_agents=n_agents)[0]


def sample_seed(generator: torch.Generator, device) -> torch.Tensor:
    """One uint32 counter-PRNG seed (as an int64 0-dim tensor on ``device``,
    so a draw on the card needs no host synchronisation) — the counterpart
    of ``_kernel_seed``."""
    return torch.randint(0, 2 ** 32, (), generator=generator, device=device,
                         dtype=torch.int64)


def _round_draws(cfg: OTAConfig, generator: Optional[torch.Generator],
                 n: int, device, gains: Optional[torch.Tensor],
                 seed: Optional[Seed]) -> Tuple[torch.Tensor, Seed]:
    """This round's gains and kernel seed: drawn from ``generator`` in that
    order, unless injected."""
    if generator is None and (gains is None or seed is None):
        raise ValueError("noisy aggregation needs a generator, or injected "
                         "gains= and seed=")
    h = sample_gains(cfg, generator, n, device) if gains is None else gains
    s = sample_seed(generator, device) if seed is None else seed
    return h.to(device=device, dtype=torch.float32), s


def _server_scale(cfg: OTAConfig, n_total: int,
                  n_agents: Optional[int]) -> float:
    """The epilogue's multiplier, in Python double: ``update_scale`` or
    ``1 / (n_total * m_h)``.  Kernels round it to float32 once."""
    if cfg.update_scale is not None:
        return cfg.update_scale
    return 1.0 / (n_total * cfg.norm_const_for(n_agents))


def _participation_rescale(n_total: int, n_eff) -> torch.Tensor:
    """``n_total / n_eff`` in float32: the round service's correction that
    retargets the full-fleet normaliser ``1 / (n_total * m_h)`` at the
    round's contribution weight ``n_eff`` (the realised participating count,
    or its closed-form expectation, fractional under staleness decay).  An
    exact zero at ``n_eff == 0``: an empty round commits a zero update,
    never the amplified noise draw.  ``n_eff`` may be a device tensor; the
    factor stays on its device."""
    w = torch.as_tensor(n_eff, dtype=torch.float32)
    # a tensor numerator: ``n_total / w`` would be reciprocal(w) * n_total
    # in PyTorch, an ulp off the division the JAX package (and K1) rounds
    num = torch.full_like(w, float(n_total))
    return torch.where(w > 0, num / torch.where(w > 0, w, 1.0),
                       torch.zeros_like(w))


def _server_epilogue(cfg: OTAConfig, seed: Seed, v: Params,
                     n_total: int, n_agents: Optional[int],
                     n_eff=None) -> Params:
    """The server tail of the plain chain: AWGN on the summed signal from
    the counter stream over the flat layout, then the normalisation.
    ``n_eff`` (round service) multiplies the scale by
    :func:`_participation_rescale` in float32, as K1 does with its device
    factor; ``None`` leaves the scale as it was."""
    dev = theta_device(v)
    if cfg.noise_sigma > 0.0:
        flat, unflatten = flatten_params(v)
        noise = unflatten(ref.counter_noise(seed, flat.numel(), dev))
        sigma = ref.f32(cfg.noise_sigma)
        v = {k: v[k] + sigma * noise[k] for k in tree_keys(v)}
    scale = ref.f32(_server_scale(cfg, n_total, n_agents))
    if n_eff is not None:
        scale = scale * _participation_rescale(n_total, n_eff)
    return {k: v[k] * scale for k in tree_keys(v)}


def _aggregate_stacked_torch(cfg: OTAConfig, h: torch.Tensor, seed: Seed,
                             grads: Params) -> Params:
    """u_k = (sum_i h_i g_i + sigma n_k) * scale over the dict leaves."""
    n = grads[tree_keys(grads)[0]].shape[0]

    def combine(g):
        hb = h.reshape((n,) + (1,) * (g.ndim - 1)).to(g.dtype)
        return torch.sum(hb * g, dim=0)

    v = {k: combine(grads[k]) for k in tree_keys(grads)}
    return _server_epilogue(cfg, seed, v, n, n)


def _exact_mean(grads: Params) -> Params:
    """Algorithm 1: the exact mean of the per-agent gradients, the agent sum
    in the fixed order of ``fixed_sum`` (a lane of a batched run sums its
    agents in the same order)."""
    n = grads[tree_keys(grads)[0]].shape[0]
    return {k: fixed_sum(grads[k], 0) / n for k in tree_keys(grads)}


def _wire_dtype(cfg: OTAConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.wire_dtype == "bfloat16" else None


def _aggregate_stacked_cuda(cfg: OTAConfig, h: torch.Tensor, seed: Seed,
                            grads: Params) -> Params:
    flat, n, unflatten = flatten_agent_stack(grads)
    u = ota_fused.fused_aggregate(
        flat, h, sigma=cfg.noise_sigma, scale=_server_scale(cfg, n, n),
        seed=seed, with_noise=cfg.noise_sigma > 0.0,
        wire_dtype=_wire_dtype(cfg))
    return unflatten(u)


def _aggregate_apply_cuda(cfg: OTAConfig, h: torch.Tensor, seed: Seed,
                          grads: Params, params: Params, alpha) -> Params:
    flat, n, _ = flatten_agent_stack(grads)
    pflat, punflatten = flatten_params(params)
    p_next = ota_fused.fused_aggregate_sgd(
        flat, h, pflat, alpha=alpha, sigma=cfg.noise_sigma,
        scale=_server_scale(cfg, n, n), seed=seed,
        with_noise=cfg.noise_sigma > 0.0,
        wire_dtype=_wire_dtype(cfg))
    return punflatten(p_next)


# ---------------------------------------------------------------------------
# Agent streaming (``agent_blocks``): a strict sequential fold over blocks of
# agents, then one server tail.  The fold's association never depends on
# where the block boundaries fall, so every partition of the agent axis
# (dividing or not) gives the same bits; gains and noise are the unblocked
# form's draws.
# ---------------------------------------------------------------------------

def blocked_layout(n_agents: int, agent_blocks: int) -> Tuple[int, int, int]:
    """Resolve a block partition: ``(n_blocks, block, pad)``.

    ``pad`` phantom agents fill the tail block when ``block`` does not
    divide ``n_agents``.  The block is capped at ``ceil(n_agents / 2)``, as
    in the JAX package (where a one-step scan would be inlined and fuse
    differently), so every ``agent_blocks`` resolves as it does there."""
    if agent_blocks < 1:
        raise ValueError(f"agent_blocks must be >= 1, got {agent_blocks}")
    block = min(int(agent_blocks), max(1, -(-n_agents // 2)))
    n_blocks = -(-n_agents // block)
    return n_blocks, block, n_blocks * block - n_agents


def pad_agent_axis(tree: Union[Params, torch.Tensor],
                   pad: int) -> Union[Params, torch.Tensor]:
    """Append ``pad`` phantom rows (copies of row 0) to every leaf's leading
    axis; every streamed consumer masks them."""
    if pad == 0:
        return tree
    if isinstance(tree, torch.Tensor):
        return torch.cat([tree, tree[:1].expand((pad,) + tree.shape[1:])])
    return {k: pad_agent_axis(v, pad) for k, v in tree.items()}


def block_view(tree: Union[Params, torch.Tensor], n_blocks: int,
               block: int) -> Union[Params, torch.Tensor]:
    """Reshape padded leading-axis leaves to ``(n_blocks, block, ...)``;
    block b holds agents ``[b*block, (b+1)*block)``."""
    if isinstance(tree, torch.Tensor):
        return tree.reshape((n_blocks, block) + tree.shape[1:])
    return {k: block_view(v, n_blocks, block) for k, v in tree.items()}


def block_valid_mask(n_agents: int, n_blocks: int, block: int,
                     device=None) -> torch.Tensor:
    """(n_blocks, block) bool: False on phantom (padding) rows."""
    return (torch.arange(n_blocks * block, device=device)
            < n_agents).reshape(n_blocks, block)


def _fold_backend(spec: AggregateSpec, device: torch.device) -> str:
    """Where a streamed fold runs.  The exact uplink's fold has no backend
    of its own: it takes K1 for CUDA tensors unless ``"torch"`` was asked
    for (both folds give the same bits)."""
    if spec.exact:
        return ("cuda" if device.type == "cuda" and spec.backend != "torch"
                else "torch")
    return spec.resolved_backend(device)


def stream_fold_block(acc: Params, grads_block: Params,
                      gains_block: Optional[torch.Tensor] = None,
                      valid: Optional[torch.Tensor] = None, *,
                      wire_dtype: Optional[torch.dtype] = None,
                      backend: str = "torch") -> Params:
    """Fold one agent block into the running sum, strictly sequentially:
    ``acc + h_0 g_0 + h_1 g_1 + ...`` (``gains_block=None`` folds the plain
    gradients, the exact-mean numerator).  ``valid`` masks phantom rows to
    exact zeros, a bitwise no-op (``acc`` is never ``-0.0``).
    ``wire_dtype`` quantises each row (cast down and back to float32), as
    the kernel's wire does.

    ``backend="cuda"`` is one K1 launch over the stack ``[acc; g_block]``
    with gains ``[1; h_block]`` (phantom gains 0), sigma 0 and scale 1:
    K1's fold from zero with ``__fmul_rn``/``__fadd_rn`` makes it bitwise
    the per-agent fold of ``backend="torch"``."""
    if backend == "cuda":
        acc_flat, unflatten = flatten_params(acc)
        g, n, _ = flatten_agent_stack(grads_block)
        if wire_dtype is not None:
            g = g.to(wire_dtype).float()
        h = (torch.ones(n, device=g.device) if gains_block is None
             else gains_block.float())
        if valid is not None:
            h = torch.where(valid, h, torch.zeros_like(h))
        ones = torch.ones(1, device=g.device)
        out = ota_fused.fused_aggregate(
            torch.cat([acc_flat.reshape(1, -1), g]), torch.cat([ones, h]),
            sigma=0.0, scale=1.0, with_noise=False)
        return unflatten(out)
    n = grads_block[tree_keys(grads_block)[0]].shape[0]
    acc = dict(acc)
    for i in range(n):
        for k in tree_keys(acc):
            row = grads_block[k][i]
            if wire_dtype is not None:
                row = row.to(wire_dtype).float()
            if gains_block is not None:
                row = gains_block[i].to(row.dtype) * row
            if valid is not None:
                row = torch.where(valid[i], row, torch.zeros_like(row))
            acc[k] = acc[k] + row.to(acc[k].dtype)
    return acc


def stream_zeros(like: Params, backend: str) -> Params:
    """The fold's starting value: zeros of each leaf's shape (float32 on
    the kernel path, the leaf's dtype on the plain chain)."""
    return {k: torch.zeros(v.shape, device=v.device,
                           dtype=torch.float32 if backend == "cuda"
                           else v.dtype) for k, v in like.items()}


def _stream_superpose(grads_stacked: Params, gains: Optional[torch.Tensor],
                      agent_blocks: int, *,
                      wire_dtype: Optional[torch.dtype] = None,
                      backend: str = "torch",
                      valid: Optional[torch.Tensor] = None) -> Params:
    """Blocked fold over an already-materialised agent stack: the running
    superposition ``sum_i h_i g_i`` (or ``sum_i g_i``); ``valid`` (N,)
    marks the real rows of a padded stack (the rest fold exact zeros)."""
    keys = tree_keys(grads_stacked)
    n = grads_stacked[keys[0]].shape[0]
    dev = grads_stacked[keys[0]].device
    n_blocks, block, pad = blocked_layout(n, agent_blocks)
    gp = block_view(pad_agent_axis(grads_stacked, pad), n_blocks, block)
    if valid is None:
        valid = block_valid_mask(n, n_blocks, block, dev)
    else:
        valid = torch.cat([valid, valid.new_zeros(pad)]).reshape(n_blocks,
                                                                 block)
    hp = None
    if gains is not None:
        hp = block_view(torch.cat([gains, gains.new_zeros(pad)]), n_blocks,
                        block)
    v = stream_zeros({k: grads_stacked[k][0] for k in keys}, backend)
    for b in range(n_blocks):
        v = stream_fold_block(v, {k: gp[k][b] for k in keys},
                              None if hp is None else hp[b], valid[b],
                              wire_dtype=wire_dtype, backend=backend)
    return v


def _device_rescale(n_agents: int, n_eff, device) -> Optional[torch.Tensor]:
    """K1's device factor for ``n_eff`` (None when there is none)."""
    if n_eff is None:
        return None
    return _participation_rescale(n_agents, n_eff).to(device).reshape(1)


def stream_finalize(cfg: OTAConfig, seed: Seed, v: Params, n_agents: int, *,
                    backend: str = "torch", n_eff=None) -> Params:
    """Server tail over a streamed superposition: ONE AWGN draw and the
    debias normalisation.  The noise is the counter stream on the absolute
    flat index, so it too is the unblocked form's.  On ``"cuda"`` the tail
    is K1's unit-gain server pass over the flattened ``v``.  ``n_eff``
    retargets the normaliser at the round service's contribution weight
    (:func:`_participation_rescale`); on ``"cuda"`` it reaches K1 as a
    device factor, so a weight computed on the card costs no host sync."""
    if backend == "cuda":
        flat, unflatten = flatten_params(v)
        return unflatten(ota_fused.fused_server_pass(
            flat, sigma=cfg.noise_sigma,
            scale=_server_scale(cfg, n_agents, n_agents), seed=seed,
            with_noise=cfg.noise_sigma > 0.0,
            rescale=_device_rescale(n_agents, n_eff, flat.device)))
    return _server_epilogue(cfg, seed, v, n_agents, n_agents, n_eff)


def stream_finalize_apply(cfg: OTAConfig, seed: Seed, v: Params,
                          params: Params, alpha, n_agents: int, *,
                          backend: str = "torch", n_eff=None) -> Params:
    """:func:`stream_finalize` fused with the server SGD step
    ``theta' = theta - alpha * u`` (one K1 launch on ``"cuda"``)."""
    if backend == "cuda":
        flat, _ = flatten_params(v)
        pflat, punflatten = flatten_params(params)
        return punflatten(ota_fused.fused_server_pass(
            flat, sigma=cfg.noise_sigma,
            scale=_server_scale(cfg, n_agents, n_agents), seed=seed,
            with_noise=cfg.noise_sigma > 0.0, alpha=alpha, params=pflat,
            rescale=_device_rescale(n_agents, n_eff, flat.device)))
    u = _server_epilogue(cfg, seed, v, n_agents, n_agents, n_eff)
    return {k: params[k] - alpha * u[k] for k in tree_keys(params)}


def _aggregate_stacked_streamed(cfg: OTAConfig, h: torch.Tensor, seed: Seed,
                                grads: Params, agent_blocks: int,
                                backend: str) -> Params:
    """The stacked form as a blocked fold: the same gains and noise as the
    unblocked form of the same backend; only the agent-sum association
    differs."""
    n = grads[tree_keys(grads)[0]].shape[0]
    wire = _wire_dtype(cfg) if backend == "cuda" else None
    v = _stream_superpose(grads, h, agent_blocks, wire_dtype=wire,
                          backend=backend)
    u = stream_finalize(cfg, seed, v, n, backend=backend)
    return {k: u[k].to(grads[k].dtype) for k in tree_keys(u)}


def _aggregate_apply_streamed_cuda(cfg: OTAConfig, h: torch.Tensor,
                                   seed: Seed, grads: Params, params: Params,
                                   alpha, agent_blocks: int) -> Params:
    n = grads[tree_keys(grads)[0]].shape[0]
    v = _stream_superpose(grads, h, agent_blocks, wire_dtype=_wire_dtype(cfg),
                          backend="cuda")
    return stream_finalize_apply(cfg, seed, v, params, alpha, n,
                                 backend="cuda")


def _exact_mean_streamed(grads: Params, agent_blocks: int,
                         backend: str = "torch") -> Params:
    """Algorithm 1's mean as a blocked fold: ``(fold_i g_i) / N``."""
    n = grads[tree_keys(grads)[0]].shape[0]
    v = _stream_superpose(grads, None, agent_blocks, backend=backend)
    return {k: (v[k] / n).to(grads[k].dtype) for k in tree_keys(v)}


# ---------------------------------------------------------------------------
# The axis forms: one rank of an agent mesh (JAX's shard_map / psum forms).
# ---------------------------------------------------------------------------

def _axis_row(grads: Params,
              wire: Optional[torch.dtype]) -> Tuple[torch.Tensor, Callable]:
    """One agent's gradient dict as a ``(P,)`` row, and the map back to the
    dict.  The row's dtype is the one the ranks sum in: the uplink's wire
    dtype when it has one, else the leaves' (float32 where they differ).
    JAX psums each leaf in its own dtype; one row takes one, and a bf16
    wire reads every row in bf16 anyway (a model's float32 norm scales
    too)."""
    keys = tree_keys(grads)
    dtypes = {grads[k].dtype for k in keys}
    dt = wire or (dtypes.pop() if len(dtypes) == 1 else torch.float32)
    row = torch.cat([grads[k].reshape(-1).to(dt) for k in keys])
    return row, _unflattener(keys, [grads[k].shape for k in keys],
                             [grads[k].dtype for k in keys])


def _rank_fold(rows: torch.Tensor, gains: torch.Tensor,
              wire: Optional[torch.dtype], backend: str) -> torch.Tensor:
    """This rank's partial superposition ``sum_i h_i g_i`` of its ``(A,
    P)`` rows as a ``(P,)`` float32 fold from zero: one launch of K1 with
    sigma 0 and scale 1 on ``"cuda"`` (the rows read through ``wire``),
    K1's plain version otherwise."""
    gains = gains.float().contiguous()
    if backend == "cuda":
        return ota_fused.fused_aggregate(rows.contiguous(), gains, sigma=0.0,
                                         scale=1.0, with_noise=False,
                                         wire_dtype=wire)
    return ref.ota_fused_ref(rows, gains)


def _server_row(cfg: OTAConfig, v: torch.Tensor, seed: Seed, n_total: int,
               n_agents: Optional[int], backend: str) -> torch.Tensor:
    """The server tail over a reduced ``(P,)`` superposition ``v`` (float32,
    or bfloat16 read as K1's wire): the AWGN and ``scale = 1 / (n_total
    m_h)``, one unit-gain K1 pass on ``"cuda"``, its plain version (the
    plain chain's epilogue) otherwise; ``(P,)`` float32."""
    row = v.reshape(1, -1)
    ones = torch.ones(1, dtype=torch.float32, device=v.device)
    noisy = cfg.noise_sigma > 0.0
    scale = _server_scale(cfg, n_total, n_agents)
    if backend == "cuda":
        return ota_fused.fused_aggregate(
            row, ones, sigma=cfg.noise_sigma, scale=scale, seed=seed,
            with_noise=noisy,
            wire_dtype=torch.bfloat16 if v.dtype == torch.bfloat16 else None)
    noise = ref.counter_noise(seed, row.shape[1], v.device) if noisy else None
    return ref.ota_fused_ref(row, ones, noise, sigma=cfg.noise_sigma,
                             scale=scale)


def _local_rows(mesh: AgentMesh, n_local: int,
                n_total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global agent index of each local row (``rank * n_local + j``,
    clipped to the fleet) and whether it is a real agent (a phantom row
    lies past ``n_total``)."""
    idx = mesh.rank * n_local + torch.arange(n_local, device=mesh.device)
    return idx.clamp(max=n_total - 1), idx < n_total


def _axis_aggregate(grads: Params, cfg: Optional[OTAConfig],
                    mesh: AgentMesh, generator, gains, seed,
                    n_agents: Optional[int], backend: str
                    ) -> Tuple[Params, torch.Tensor]:
    """``form="axis"``: one agent a rank (JAX ``_psum_axis``; ``pmean``
    for the exact uplink).  Each ``(P,)`` buffer is dropped as soon as the
    next exists, so beside ``grads`` at most the float32 fold and one row
    in the summed dtype (:func:`_axis_row`) live at once: the LLM train
    step's uplink holds what ``add_awgn``'s does."""
    row, unflatten = _axis_row(grads, None if cfg is None
                               else _wire_dtype(cfg))
    dev, dtype = row.device, row.dtype
    if cfg is None:
        v = mesh.all_reduce(row)
        return unflatten(v.float() / mesh.size), torch.ones((), device=dev)
    n_total = mesh.size if n_agents is None else n_agents
    h_all, s = _round_draws(cfg, generator, mesh.size, dev, gains, seed)
    h = h_all[mesh.rank]
    be = AggregateSpec(backend=backend).resolved_backend(dev)
    v = _rank_fold(row.reshape(1, -1), h.reshape(1), None, be)
    del row
    v = mesh.all_reduce(v.to(dtype))
    u = _server_row(cfg, v, s, n_total, n_agents, be)
    del v
    return unflatten(u), h


def _axis_stacked_aggregate(grads: Params, cfg: Optional[OTAConfig],
                            mesh: AgentMesh, generator, gains, seed,
                            n_agents: Optional[int],
                            agent_blocks: Optional[int], backend: str
                            ) -> Tuple[Params, torch.Tensor]:
    """``form="axis_stacked"``: a stack of this rank's agents (JAX
    ``_psum_axis_stacked[_streamed]``, ``_exact_mean_axis_stacked
    [_streamed]``); phantom rows fold exact zeros."""
    keys = tree_keys(grads)
    n_local = grads[keys[0]].shape[0]
    dev = theta_device(grads)
    n_total = mesh.size * n_local if n_agents is None else n_agents
    idx, valid = _local_rows(mesh, n_local, n_total)
    spec = AggregateSpec(exact=cfg is None, backend=backend)
    be = _fold_backend(spec, dev)
    h = None
    if cfg is not None:
        h_all, s = _round_draws(cfg, generator, n_total, dev, gains, seed)
        h = torch.where(valid, h_all[idx], torch.zeros((), device=dev))
    wire = _wire_dtype(cfg) if cfg is not None and be == "cuda" else None
    if agent_blocks is not None:
        v = _stream_superpose(grads, h, agent_blocks, wire_dtype=wire,
                              backend=be, valid=valid)
        flat, unflatten = flatten_params(v)
    else:
        rows, _, unflatten = flatten_agent_stack(grads)
        rows = torch.where(valid[:, None], rows, torch.zeros((), device=dev))
        flat = (fixed_sum(rows, 0) if cfg is None
                else _rank_fold(rows, h, wire, be))
    v = mesh.all_reduce(flat)
    if cfg is None:
        return unflatten(v / n_total), torch.ones((), device=dev)
    return unflatten(_server_row(cfg, v, s, n_total, n_agents, be)), h


def aggregate(grads: Params, cfg: Optional[OTAConfig], *,
              generator: Optional[torch.Generator] = None,
              backend: str = "auto", gains: Optional[torch.Tensor] = None,
              seed: Optional[Seed] = None,
              agent_blocks: Optional[int] = None,
              mesh: Optional[AgentMesh] = None, local_stack: bool = False,
              n_agents: Optional[int] = None
              ) -> Tuple[Params, torch.Tensor]:
    """OTA-aggregate the (N, ...) stack ``grads``; returns ``(u_k, h)``.

    ``cfg=None`` is the exact Algorithm-1 uplink (mean; ``h == 1``).
    ``gains``/``seed`` inject the round's draws instead of drawing them from
    ``generator``.  ``agent_blocks`` streams the agent sum in blocks of that
    many agents (see :func:`stream_fold_block`): the same draws, a result
    bitwise invariant to the block size.

    ``mesh`` (an agent mesh; call on every rank) selects the axis forms
    (module docstring): ``grads`` is this rank's gradient (``local_stack=
    False``, ``"axis"``) or the ``(n_local, ...)`` stack of its agents
    ``rank * n_local + j`` (``local_stack=True``, ``"axis_stacked"``);
    ``n_agents`` the true fleet size (default: every row real).  ``gains``
    are the whole fleet's (one a rank in ``"axis"``) and ``h`` comes back as
    this rank's, phantoms zeroed."""
    if mesh is not None:
        if local_stack:
            return _axis_stacked_aggregate(grads, cfg, mesh, generator, gains,
                                           seed, n_agents, agent_blocks,
                                           backend)
        if agent_blocks is not None:
            raise ValueError(
                "agent_blocks streams an agent stack; the one-agent-per-rank "
                "'axis' form has nothing to block (use local_stack=True)")
        return _axis_aggregate(grads, cfg, mesh, generator, gains, seed,
                               n_agents, backend)
    if local_stack:
        raise ValueError("local_stack=True is the axis-stacked form: it needs "
                         "an agent mesh (mesh=)")
    spec = AggregateSpec(exact=cfg is None, backend=backend)
    dev = theta_device(grads)
    be = _fold_backend(spec, dev)
    if spec.exact:
        if agent_blocks is not None:
            return (_exact_mean_streamed(grads, agent_blocks, be),
                    torch.ones((), device=dev))
        return _exact_mean(grads), torch.ones((), device=dev)
    n = grads[tree_keys(grads)[0]].shape[0]
    h, s = _round_draws(cfg, generator, n, dev, gains, seed)
    if agent_blocks is not None:
        return _aggregate_stacked_streamed(cfg, h, s, grads, agent_blocks,
                                           be), h
    if be == "cuda":
        return _aggregate_stacked_cuda(cfg, h, s, grads), h
    return _aggregate_stacked_torch(cfg, h, s, grads), h


def aggregate_apply(grads: Params, cfg: Optional[OTAConfig], params: Params,
                    *, alpha, generator: Optional[torch.Generator] = None,
                    backend: str = "auto",
                    gains: Optional[torch.Tensor] = None,
                    seed: Optional[Seed] = None,
                    agent_blocks: Optional[int] = None
                    ) -> Tuple[Params, torch.Tensor]:
    """Aggregate + server SGD step ``theta' = theta - alpha * u_k``; returns
    ``(theta', h)``.  On the kernel path the gain matvec, AWGN, debias and
    update are one launch of K1 (``fused_aggregate_sgd``); with
    ``agent_blocks`` the blocks fold through K1 and the noise, debias and
    update are one more launch (the server pass)."""
    spec = AggregateSpec(exact=cfg is None, backend=backend)
    dev = theta_device(grads)
    if spec.exact or spec.resolved_backend(dev) == "torch":
        u, h = aggregate(grads, cfg, generator=generator, backend=backend,
                         gains=gains, seed=seed, agent_blocks=agent_blocks)
        return {k: params[k] - alpha * u[k] for k in tree_keys(params)}, h
    n = grads[tree_keys(grads)[0]].shape[0]
    h, s = _round_draws(cfg, generator, n, dev, gains, seed)
    if agent_blocks is not None:
        return _aggregate_apply_streamed_cuda(cfg, h, s, grads, params, alpha,
                                              agent_blocks), h
    return _aggregate_apply_cuda(cfg, h, s, grads, params, alpha), h


# ---------------------------------------------------------------------------
# Form 3: the channel-weighted loss (the distortion folded into autograd),
# the LLM trainer's uplink.
# ---------------------------------------------------------------------------

def example_weights(gains: torch.Tensor, global_batch: int, *,
                    dtype=torch.float32) -> torch.Tensor:
    """Expand per-agent gains ``(N,)`` to per-example weights
    ``(global_batch,)``: agent i owns the contiguous slice ``[i*B/N,
    (i+1)*B/N)``.  With the loss ``(1/B) sum_e w_e l_e`` and ``w_e =
    h_{agent(e)}``, autograd gives ``(1/N) sum_i h_i grad J_i = v_k / N``
    before the noise."""
    n_agents = gains.shape[0]
    if global_batch % n_agents != 0:
        raise ValueError(f"global_batch={global_batch} not divisible by "
                         f"n_agents={n_agents}")
    return torch.repeat_interleave(gains.to(dtype), global_batch // n_agents)


def add_awgn(cfg: OTAConfig, seed: Seed, grad, n_agents: int, *,
             backend: str = "auto",
             counter_map: Optional[ota_fused.CounterMap] = None):
    """The server tail of the channel-weighted loss: ``grad`` (a nested dict
    equal to ``(1/N) sum_i h_i g_i``) plus ``n_k / N``, times the debias
    normaliser (``N * update_scale`` when set, else ``1 / m_h`` under
    ``debias``).  Counterpart of ``_add_awgn_pallas``: the gradient,
    flattened in the JAX package's leaf order, is one unit-gain ``(1, d)``
    row through K1's ``agg`` mode with ``sigma / N`` (rounded in float32 as
    JAX rounds it) and the wire dtype.  On the ``"cuda"`` backend that is
    one K1 launch; ``"torch"`` (and ``"auto"`` for CPU tensors) is K1's
    plain version.  The noise is K1's counter stream keyed on ``seed``;
    there is no other stream.  Returns the same tree, each leaf in its
    dtype.

    On a mesh ``grad`` is this rank's shards of every leaf and
    ``counter_map`` (:func:`shard_counter_map`) gives each element of
    their row its position in the whole flattened gradient, so each
    element takes the noise the unsharded step adds to it (one K1 launch,
    its mapped instance, on the card)."""
    flat = flatten_paths(grad)
    dev = next(iter(flat.values())).device
    be = AggregateSpec(backend=backend).resolved_backend(dev)
    wire = _wire_dtype(cfg)
    row = torch.cat([g.reshape(-1).to(wire or torch.float32)
                     for g in flat.values()]).reshape(1, -1)
    if cfg.update_scale is not None:
        scale = n_agents * cfg.update_scale
    elif cfg.debias:
        scale = 1.0 / cfg.norm_const_for(n_agents)
    else:
        scale = 1.0
    sigma = float(ref.f32(cfg.noise_sigma) / n_agents)
    noisy = cfg.noise_sigma > 0.0
    ones = torch.ones(1, dtype=torch.float32, device=dev)
    if be == "cuda":
        u = ota_fused.fused_aggregate(row, ones, sigma=sigma, scale=scale,
                                      seed=seed, with_noise=noisy,
                                      wire_dtype=wire,
                                      counter_map=counter_map)
    else:
        noise = None
        if noisy:
            noise = ref.counter_noise(seed, row.shape[1], dev) \
                if counter_map is None \
                else ref.counter_noise_at(seed, counter_map.counters(dev))
        u = ref.ota_fused_ref(row, ones, noise, sigma=sigma, scale=scale)
    del row
    out, off = {}, 0
    for k, g in flat.items():
        out[k] = u[off:off + g.numel()].reshape(g.shape).to(g.dtype)
        off += g.numel()
    return replace_paths(grad, out)


def shard_counter_map(global_shapes: Sequence[Sequence[int]],
                      blocks: Sequence[Tuple[Sequence[int], Sequence[int]]]
                      ) -> ota_fused.CounterMap:
    """The counter map of a row made of one block of each leaf: leaf ``i``
    of the whole gradient has shape ``global_shapes[i]`` (the leaves in
    the JAX package's order, so leaf ``i`` starts at the sum of the sizes
    before it in the flat gradient) and this rank holds the block
    ``blocks[i] = (offsets, local shape)`` of it.  Each segment's
    dimensions are the block's, with the trailing ones it holds whole
    merged (strides in the whole leaf), so a whole leaf is one segment
    of one dimension and the map of a one-rank mesh draws each element
    at its own index."""
    segments, row, start = [], 0, 0
    for shape, (offsets, local) in zip(global_shapes, blocks):
        strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
        base = start + sum(o * t for o, t in zip(offsets, strides))
        dims: List[List[int]] = []        # [size, stride], outer first
        for size, stride in zip(local, strides):
            if size == 1:
                continue
            dims.append([size, stride])
        merged: List[List[int]] = []
        for size, stride in reversed(dims):
            if merged and stride == merged[0][0] * merged[0][1]:
                merged[0] = [size * merged[0][0], merged[0][1]]
            else:
                merged.insert(0, [size, stride])
        if not merged:
            merged = [[1, 1]]
        count = math.prod(local)
        segments.append((row, base, [m[0] for m in merged],
                         [m[1] for m in merged]))
        row += count
        start += math.prod(shape)
    return ota_fused.CounterMap(segments)
