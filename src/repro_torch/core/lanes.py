"""The lane-batched run: many runs of one structure as one round per step.

The port's form of ``jax.vmap(fedpg.run)``.  L lanes — Monte-Carlo runs,
and the scenarios of a sweep partition times their runs — share every
structural setting (N, M, T, K, the estimator, the channel family, the
power policy's type, the env family, the participation structure) and may
differ in the continuous ones: the step size, the noise sigma, the channel
and power-control parameters, the env's float fields, the Bernoulli rate,
the fault deadline and the staleness decay.  Each round runs all lanes at
once:

* every lane has its own ``torch.Generator``, seeded as :func:`fedpg.run`
  seeds it, and makes that run's draws in that run's order: theta_0, the
  service seed, then each round's initial states, each step's policy and
  environment noise, the gains and the kernel seed;
* the rollouts and the G(PO)MDP estimates run as one computation over a
  leading lane axis with per-lane parameters (the policies' fixed-order
  products and closed-form ``grad_log_prob``, ``rl/policy.py``);
* the uplink is ONE launch of K1's lane form (``fused_aggregate_sgd_lanes``,
  or ``fused_aggregate_lanes`` in a service round) with the per-lane sigma,
  scale, step size, seed and service factor as device arrays made once per
  run; the exact uplink (Algorithm 1) takes its SGD step in torch;
* with ``agent_blocks`` the round goes block by block over the agent axis
  (:func:`_streamed_round`, :func:`_streamed_service_round`): each lane's
  draws are made up front in its run's order (the rollouts' draws for all
  N agents, then the gains and the kernel seed) and sliced per block; the
  lanes' rollouts and estimates for a block are one computation over
  ``(L, block)``; each of the block's folds (the exact-mean numerator and
  the channel signal; in a service round the masked estimates, the stale
  rows and the channel signal) is ONE launch of K1's lane form over the
  ``(L, 1 + block, d)`` stack ``[acc; g_block]`` with gains ``[1;
  h_block]``, sigma 0 and scale 1 (``ota.stream_fold_block``'s kernel path
  with a lane axis), and the server tail one more launch with the per-lane
  sigma, scale, seed, step size and service factor ``N / W`` as device
  arrays.  K1 launches a batched streamed round: ``2 n_blocks + 1`` (plain),
  ``2-3 n_blocks + 1`` (service), whatever L.  A lane holds O(block x d)
  gradients at once, plus its O(N x d) stale buffer under staleness;
* the metrics and probes reduce in the fixed order of
  ``utils.tree.fixed_sum``, lane by lane.

The contract: lane l is bitwise :func:`fedpg.run` of its settings and seed,
on the CPU and on the card.  Values that vary across lanes reach the round
as float32 tensors holding the float32 rounding of the per-run Python
value, so they enter every op as the run's literal does; constants stay
the run's own Python floats.  Host-side derived constants (the server
scale ``1 / (N m_h)``, the expected participating count, the drift
reference) are computed per lane in double as the run computes them, so
unlike JAX the port needs no exception for a varying debias normaliser,
and none for LQR: its matrix products are fixed-order too.

On the CPU (``ota_backend="torch"``, what ``"auto"`` means there) the uplink
is the plain chain of :func:`ota.aggregate_apply`, lane by lane; K1's lane
form is the card's path.

These are the port's only rounds, stacked and streamed:
:func:`fedpg.run` runs as one lane, and :func:`fedpg.make_round_fn`'s
round is :func:`lane_round_fn`, one lane over a run's dict parameters that
also takes injected :class:`RoundDraws`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import gpomdp, ota
from repro_torch.core.channel import (
    BatchedChannel, batched_channel_arrays, channel_kind, lane_param,
    sample_lanes,
)
from repro_torch.core.fedpg import (
    FedPGConfig, History, RoundDraws, _round_mask, _round_weights,
    _service_gain_mean, _service_probes, _service_reward, env_on, predraw,
)
from repro_torch.core.ota import OTAConfig, sample_seed
from repro_torch.core.power_control import LaneBudgets, check_agent_count
from repro_torch.kernels import ota_fused
from repro_torch.rl.envs.heterogeneous import (
    HeterogeneousEnv, check_agent_count as check_env_agent_count,
)
from repro_torch.rl.envs.registry import (
    batched_env_arrays, build_lane_env, env_kind, values_vary,
)
from repro_torch.rl.sampler import (
    discounted_return, empirical_reward, rollout_batch,
)
from repro_torch.service import participation as svc_part
from repro_torch.service import staleness as svc_stale
from repro_torch.service.participation import ParticipationConfig
from repro_torch.service.staleness import StalenessConfig
from repro_torch.telemetry import probes as _probes
from repro_torch.telemetry.probes import TelemetryConfig
from repro_torch.utils.device import DeviceLike, make_generator, resolve_device
from repro_torch.utils.tree import (
    Params, fixed_mean, fixed_sum, flat_norm_sq, flatten_agent_stack,
    flatten_params,
)


class LaneSpec(NamedTuple):
    """One lane's settings: what :func:`fedpg.run` would be called with."""

    seed: int
    alpha: float
    ota: Optional[OTAConfig] = None
    env: Any = None
    participation: Optional[ParticipationConfig] = None
    staleness: Optional[StalenessConfig] = None


def _f32(vals) -> np.ndarray:
    return np.asarray(np.asarray(vals, np.float64), np.float32)


def pack_lanes(specs: Sequence[LaneSpec], n_agents: int) -> Dict[str, Any]:
    """The settings that vary across ``specs`` as float32 arrays (numpy,
    one value per lane), in the layout of the JAX sweep's
    ``_pack_partition``: ``env`` (a dict, from the registry packer),
    ``alpha``, ``noise_sigma``, ``channel`` (a dict, from
    ``batched_channel_arrays``), ``power_control`` (a dict of the policy's
    fields), ``update_scale`` (under debias, when the channel or the power
    policy varies), ``participation_rate``, ``participation_deadline``
    (realised debias with active faults) and ``staleness_decay``.  A
    setting that does not vary is left out: the lanes use the run's own
    value."""
    packed: Dict[str, Any] = {}
    proto = specs[0]
    envs = [s.env for s in specs]
    if proto.env is not None and values_vary(envs):
        _, arrays = batched_env_arrays(envs)
        if arrays:
            packed["env"] = {k: _f32(v) for k, v in arrays.items()}
    if values_vary([s.alpha for s in specs]):
        packed["alpha"] = _f32([s.alpha for s in specs])
    if proto.ota is not None:
        otas = [s.ota for s in specs]
        if values_vary([o.noise_sigma for o in otas]):
            packed["noise_sigma"] = _f32([o.noise_sigma for o in otas])
        chans = [o.channel for o in otas]
        if values_vary(chans):
            _, arrays = batched_channel_arrays(chans)
            packed["channel"] = {k: _f32(v) for k, v in arrays.items()}
        pcs = [o.power_control for o in otas]
        if proto.ota.power_control is not None and values_vary(pcs):
            packed["power_control"] = {
                f.name: _f32([float(getattr(p, f.name)) for p in pcs])
                for f in dataclasses.fields(proto.ota.power_control)}
        if proto.ota.debias and ("channel" in packed
                                 or "power_control" in packed):
            packed["update_scale"] = _f32(
                [ota._server_scale(o, n_agents, n_agents) for o in otas])
    p0 = proto.participation
    if p0 is not None:
        parts = [s.participation for s in specs]
        if p0.kind == "bernoulli":
            rates = [float(p.rate) for p in parts]
            if values_vary(rates):
                packed["participation_rate"] = _f32(rates)
        if p0.debias == "realized" and p0.faults is not None \
                and p0.faults.active:
            dls = [float(p.faults.deadline) for p in parts]
            if values_vary(dls):
                packed["participation_deadline"] = _f32(dls)
        if proto.staleness is not None:
            decays = [float(s.staleness.decay) for s in specs]
            if values_vary(decays):
                packed["staleness_decay"] = _f32(decays)
    return packed


def structure_key(spec: LaneSpec) -> Tuple:
    """Everything of a lane's settings that changes the shape or the ops
    of its round: the uplink's form (debias, the channel's kind tag, the
    power policy's type, noise on/off, the wire dtype), the participation
    structure (kind, subset, debias, active faults with their deadline
    unless it is realised), the staleness window and the env's kind tag.
    Lanes of one batched run share it, and the sweep partitions by it;
    ``participation`` and ``staleness`` must be normalised."""
    o = spec.ota
    okey = None if o is None else (
        o.debias, kind_tag(o.channel, channel_kind),
        None if o.power_control is None
        else type(o.power_control).__name__,
        o.noise_sigma > 0.0, o.wire_dtype)
    p = spec.participation
    pkey = None
    if p is not None:
        f = p.faults if p.faults is not None and p.faults.active else None
        pkey = (p.kind, p.subset, p.debias, None if f is None else (
            f.stragglers, None if p.debias == "realized" else f.deadline,
            f.crashes))
    st = spec.staleness
    return (okey, pkey, None if st is None else st.max_age,
            None if spec.env is None else kind_tag(spec.env, env_kind))


def kind_tag(obj, kind) -> str:
    """The registry's kind tag of a channel or env, else its class name."""
    try:
        return kind(obj)
    except ValueError:
        return type(obj).__name__


def _check_structure(specs: Sequence[LaneSpec], n_agents: int) -> None:
    """Lanes must share their :func:`structure_key`."""
    keys = {structure_key(s) for s in specs}
    if len(keys) != 1:
        raise ValueError(f"lanes of one batched run must share their "
                         f"structure; got {len(keys)} structures")
    for s in specs:
        if s.ota is not None:
            check_agent_count(s.ota.channel, n_agents)
        check_env_agent_count(s.env, n_agents)


def _dev_f32(vals, dev) -> torch.Tensor:
    return torch.as_tensor(_f32(vals), device=dev)


def _lane_value(packed: Dict[str, Any], name: str, shared, dev):
    """A lane setting: an ``(L,)`` float32 device tensor where it varies,
    else the shared Python value."""
    return torch.as_tensor(packed[name], device=dev) if name in packed \
        else shared


class _Lanes:
    """The run-constant per-lane state of a lane-batched run; ``shapes``
    the parameters' (key, shape) pairs in key order; ``agent_blocks``
    streams the agent axis (``blocks``: the ``(lo, hi)`` agent ranges,
    None for the stacked round)."""

    def __init__(self, env, policy, cfg: FedPGConfig,
                 specs: Sequence[LaneSpec], dev: torch.device,
                 ota_backend: str, shapes: List[Tuple[str, torch.Size]],
                 agent_blocks: Optional[int] = None):
        self.cfg, self.policy, self.dev = cfg, policy, dev
        self.specs = list(specs)
        self.n_lanes = len(specs)
        self.shapes = shapes
        self.sizes = [shape.numel() for _, shape in shapes]
        n = cfg.n_agents
        self.blocks = None
        if agent_blocks is not None:
            n_blocks, block, _ = ota.blocked_layout(n, agent_blocks)
            self.blocks = [(b * block, min((b + 1) * block, n))
                           for b in range(n_blocks)]
        proto = specs[0]
        packed = pack_lanes(specs, n)
        self.packed = packed
        # --- env: one batched env, and each lane's own view for its draws
        base_env = env_on(proto.env if proto.env is not None else env, dev)
        self.base_env, self.env_arrays = base_env, None
        if "env" in packed:
            self.env_kind = env_kind(proto.env)
            arrays = {k: torch.as_tensor(v, device=dev)
                      for k, v in packed["env"].items()}
            self.env_arrays = arrays
            self.env = build_lane_env(self.env_kind, base_env, arrays)
            self.env_views = [build_lane_env(self.env_kind, base_env,
                                             {k: v[i] for k, v in
                                              arrays.items()}, lanes=False)
                              for i in range(self.n_lanes)]
        else:
            self.env = base_env.lanes() if isinstance(
                base_env, HeterogeneousEnv) else base_env
            self.env_views = [base_env] * self.n_lanes
        # --- step size: a (L,) device array for K1 and the probes; the
        # torch SGD step multiplies by the run's literal or the lane value
        alphas = [s.alpha for s in specs]
        self.alpha_t = _dev_f32(alphas, dev)
        self.alpha = _lane_value(packed, "alpha", proto.alpha, dev)
        # --- uplink
        self.ota = proto.ota
        self.otas = [s.ota for s in specs]
        self.noisy = self.ota is not None and self.ota.noise_sigma > 0.0
        self.fold_backend = ota._fold_backend(ota.AggregateSpec(
            exact=self.ota is None, backend=ota_backend), dev)
        if self.ota is not None:
            spec = ota.AggregateSpec(exact=False, backend=ota_backend)
            self.backend = spec.resolved_backend(dev)
            chans = [o.channel for o in self.otas]
            if "channel" in packed:
                kind, _ = batched_channel_arrays(chans[:1])
                self.channel = BatchedChannel(kind=kind, params={
                    k: torch.as_tensor(v, device=dev)
                    for k, v in packed["channel"].items()})
            else:
                try:
                    self.channel = BatchedChannel.of(chans[0])
                except ValueError:   # not registered: sampled lane by lane
                    self.channel = chans[0]
            pc = self.ota.power_control
            if pc is not None and "power_control" in packed:
                if pc.per_agent:
                    pc = LaneBudgets.of([o.power_control for o in self.otas],
                                        n, dev)
                else:
                    pc = type(pc)(**{
                        k: torch.as_tensor(v, device=dev).reshape(-1, 1)
                        for k, v in packed["power_control"].items()})
            self.power = pc
            self.sigma_t = _dev_f32([o.noise_sigma for o in self.otas], dev)
            self.scale_t = _dev_f32(
                [ota._server_scale(o, n, n) for o in self.otas], dev)
            self.wire = ota._wire_dtype(self.ota) \
                if self.backend == "cuda" else None
        # --- service
        self.part = proto.participation
        self.stale = proto.staleness
        if self.part is not None:
            self.rate = _lane_value(packed, "participation_rate", None, dev)
            if self.rate is not None:
                self.rate = self.rate.reshape(-1, 1)
            self.deadline = _lane_value(packed, "participation_deadline",
                                        None, dev)
            if self.deadline is not None:
                self.deadline = self.deadline.reshape(-1, 1)
            self.decay = _lane_value(packed, "staleness_decay", None, dev)
            if self.decay is not None:
                self.decay = self.decay.reshape(-1, 1)
            expected = [svc_part.expected_count(s.participation, n)
                        for s in specs]
            self.expected_t = _dev_f32(expected, dev)
            rates = [e / n for e in expected]
            self.rate_expected = (_dev_f32(rates, dev) if values_vary(rates)
                                  else rates[0])

    def block_env(self, lo: int, hi: int):
        """The batched env of agents ``[lo, hi)``: a fleet's per-agent
        stacks sliced (``HeterogeneousEnv``), else the batched env."""
        if not isinstance(self.base_env, HeterogeneousEnv) \
                or (lo, hi) == (0, self.cfg.n_agents):
            return self.env
        if self.env_arrays is None:
            return self.base_env.lanes(lo, hi)
        return build_lane_env(self.env_kind, self.base_env,
                              {k: v[:, lo:hi]
                               for k, v in self.env_arrays.items()})

    def gains(self, gens) -> torch.Tensor:
        """``(L, N)`` effective gains, lane l from ``gens[l]``."""
        c = sample_lanes(self.channel, gens, (self.cfg.n_agents,), self.dev)
        if self.power is not None:
            c = c * self.power.apply(c)
        return c.float()

    def noise_power(self) -> Optional[torch.Tensor]:
        """``(L,)`` ``d sigma^2`` of the SNR probe, made once per run."""
        if not self.noisy:
            return None
        if not hasattr(self, "_noise_pow"):
            self._noise_pow = torch.stack([
                _probes.noise_power(sum(self.sizes), o.noise_sigma, self.dev)
                for o in self.otas])
        return self._noise_pow

    def drift_ref(self):
        """The moment-drift reference: 1 for the exact uplink, else each
        lane's effective m_h (a device array where it varies)."""
        if self.ota is None:
            return 1.0
        if not hasattr(self, "_drift_ref"):
            n = self.cfg.n_agents
            refs = [ota.effective_gain_mean(o, n) for o in self.otas]
            self._drift_ref = (_dev_f32(refs, self.dev) if values_vary(refs)
                               else refs[0])
        return self._drift_ref


class _LaneDraws(NamedTuple):
    """Every lane's rollout draws of one round, for all N agents: ``s0``
    ``(L, N, M, obs)``, the policy's and the env's step noise ``(T+1, L,
    N, M, ...)`` (None when injected or drawless), and the one lane's
    injected actions ``(1, N, M, T+1[, act])``."""

    s0: torch.Tensor
    policy_noise: Optional[torch.Tensor]
    env_noise: Optional[torch.Tensor]
    actions: Optional[torch.Tensor]


def _draw_rollouts(lanes: _Lanes, gens, d: RoundDraws) -> _LaneDraws:
    """Each lane's rollout draws for all N agents, made in a run's order
    (or the one lane's injected ``d``)."""
    pre = [predraw(view, lanes.policy, g, lanes.cfg, lanes.dev, d)
           for view, g in zip(lanes.env_views, gens)]
    pol = None if pre[0].policy_noise is None else torch.stack(
        [p.policy_noise for p in pre], dim=1)
    envn = None if pre[0].env_noise is None else torch.stack(
        [p.env_noise for p in pre], dim=1)
    return _LaneDraws(torch.stack([p.s0 for p in pre]), pol, envn,
                      None if d.actions is None else d.actions.unsqueeze(0))


def _rollout_and_grads(lanes: _Lanes, theta: torch.Tensor, dr: _LaneDraws,
                       lo: int, hi: int):
    """Agents ``[lo, hi)``'s rollouts in every lane from the round's draws,
    over per-lane parameters, and their ``(L, hi - lo, P)`` G(PO)MDP
    estimates."""
    cfg = lanes.cfg
    # each lane's parameters as (L, 1, 1, ...) leaves over the (L, N, M)
    # batch: views of the flat (L, P) rows
    params = {k: v.reshape((v.shape[0], 1, 1) + tuple(v.shape[1:]))
              for k, v in _unflatten_stack(theta, lanes.shapes).items()}
    trajs = rollout_batch(
        lanes.block_env(lo, hi), lanes.policy, params, None, cfg.horizon,
        (lanes.n_lanes, hi - lo, cfg.batch_m), s0=dr.s0[:, lo:hi],
        actions=None if dr.actions is None else dr.actions[:, lo:hi],
        policy_noise=(None if dr.policy_noise is None
                      else dr.policy_noise[:, :, lo:hi]),
        env_noise=None if dr.env_noise is None else dr.env_noise[:, :, lo:hi])
    grads = gpomdp.estimate_flat(lanes.policy, params, trajs, cfg.gamma,
                                 cfg.estimator)
    return trajs, grads                                        # (L, b, P)


def _uplink_draws(lanes: _Lanes, gens, d: RoundDraws):
    """Each lane's ``(N,)`` gains, then its kernel seed, from its generator
    in that order, or the one lane's injected ``d``."""
    h = lanes.gains(gens) if d.gains is None else d.gains.to(
        device=lanes.dev, dtype=torch.float32).reshape(1, -1)
    if d.seed is None:
        seeds = torch.stack([sample_seed(g, lanes.dev) for g in gens])
    else:
        seeds = torch.as_tensor(d.seed, dtype=torch.int64,
                                device=lanes.dev).reshape(1)
    return h, seeds


def _uplink(lanes: _Lanes, grads: torch.Tensor, h: torch.Tensor,
            seeds: torch.Tensor,
            theta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The over-the-air update ``u`` (L, P), or the stepped parameters when
    ``theta`` is given: ONE launch of K1's lane form on the card, else the
    plain chain lane by lane."""
    if lanes.backend == "cuda":
        kw = dict(sigma=lanes.sigma_t, scale=lanes.scale_t, seed=seeds,
                  with_noise=lanes.noisy, wire_dtype=lanes.wire)
        if theta is None:
            return ota_fused.fused_aggregate_lanes(grads, h, **kw)
        return ota_fused.fused_aggregate_sgd_lanes(grads, h, theta,
                                                   alpha=lanes.alpha_t, **kw)
    out = []
    for i, o in enumerate(lanes.otas):
        g = _unflatten_stack(grads[i], lanes.shapes)
        u = ota._aggregate_stacked_torch(o, h[i], seeds[i], g)
        uf, _ = flatten_params(u)
        out.append(uf if theta is None
                   else theta[i] - lanes.specs[i].alpha * uf)
    return torch.stack(out)


def _unflatten_stack(flat: torch.Tensor, shapes) -> Params:
    """(N, P) -> dict of (N, ...) leaves, as ``gpomdp._estimate`` lays
    them out (views of the flat rows); ``shapes`` the (key, shape) pairs
    in key order."""
    out, off = {}, 0
    for k, shape in shapes:
        size = shape.numel()
        out[k] = flat[:, off:off + size].reshape((flat.shape[0],)
                                                 + tuple(shape))
        off += size
    return out


def _plain_round(lanes: _Lanes, theta: torch.Tensor, gens,
                 telem: Optional[TelemetryConfig], d: RoundDraws):
    """Algorithm 1 (exact uplink) or 2 for every lane: ``(theta',
    (reward, grad_sq, gain_mean), probes)``, each with a leading lane
    axis."""
    cfg, n, sizes = lanes.cfg, lanes.cfg.n_agents, lanes.sizes
    trajs, grads = _rollout_and_grads(lanes, theta,
                                      _draw_rollouts(lanes, gens, d), 0, n)
    mean = fixed_sum(grads, 1) / n                              # (L, P)
    if lanes.ota is None:
        theta_next = theta - lane_param(lanes.alpha, 1) * mean
        gain_mean = torch.ones(lanes.n_lanes, device=lanes.dev)
        h = None
    else:
        h, seeds = _uplink_draws(lanes, gens, d)
        theta_next = _uplink(lanes, grads, h, seeds, theta)
        gain_mean = fixed_mean(h, 1)
    reward = empirical_reward(trajs, cfg.gamma, 2)
    grad_sq = flat_norm_sq(mean, sizes)
    probes = None
    if telem is not None:
        if h is None:
            gains = torch.ones((lanes.n_lanes, n), device=lanes.dev)
            update_norm = torch.sqrt(grad_sq)
        else:
            gains = h
            update_norm = torch.sqrt(flat_norm_sq(theta - theta_next, sizes)) \
                / lanes.alpha_t
        probes = _probes.flat_round_probes(
            telem, flat=grads, sizes=sizes, gains=gains,
            noise_pow=lanes.noise_power(), drift_ref=lanes.drift_ref(),
            gain_mean=gain_mean, update_norm=update_norm)
    return theta_next, (reward, grad_sq, gain_mean), probes


class _StaleLanes(NamedTuple):
    grads: torch.Tensor      # (L, N, P)
    age: torch.Tensor        # (L, N) int32


def _service_round(lanes: _Lanes, theta: torch.Tensor, gens,
                   telem: Optional[TelemetryConfig], svc_seed, k: int,
                   stale: Optional[_StaleLanes], d: RoundDraws):
    """The service round for every lane (``fedpg``'s module docstring):
    :func:`_plain_round`'s results and the next staleness buffer."""
    cfg, n, dev, sizes = lanes.cfg, lanes.cfg.n_agents, lanes.dev, lanes.sizes
    part = lanes.part
    mask = _round_mask(part, svc_seed, k, n, dev, d, rate=lanes.rate,
                      deadline=lanes.deadline).expand(lanes.n_lanes, n)
    age = None if stale is None else stale.age
    rw = _round_weights(part, lanes.stale, mask, age, lanes.expected_t,
                       lanes.decay)

    trajs, grads = _rollout_and_grads(lanes, theta,
                                      _draw_rollouts(lanes, gens, d), 0, n)
    keep = mask.unsqueeze(-1)
    gm = torch.where(keep, grads, torch.zeros_like(grads))
    ssum = stale_next = None
    if lanes.stale is not None:
        ssum = fixed_sum(rw.rw.unsqueeze(-1) * stale.grads, 1)
        stale_next = _StaleLanes(
            grads=torch.where(keep, grads, stale.grads),
            age=svc_stale.next_age(stale.age, mask))
    gsum = fixed_sum(gm, 1)
    if ssum is not None:
        gsum = gsum + ssum
    mean = gsum * rw.inv_w.unsqueeze(-1)
    if lanes.ota is None:
        gain_mean = torch.ones(lanes.n_lanes, device=dev)
        update = mean
        hm = None
    else:
        h, seeds = _uplink_draws(lanes, gens, d)
        hm = torch.where(mask, h, torch.zeros_like(h))
        pf = svc_part.participation_factor(n, rw.w_norm)
        update = _uplink(lanes, gm, hm, seeds) * pf.unsqueeze(-1)
        if ssum is not None:
            update = update + ssum * rw.inv_w.unsqueeze(-1)
        gain_mean = _service_gain_mean(hm, rw)
    theta_next = theta - lane_param(lanes.alpha, 1) * update
    reward = _service_reward(discounted_return(trajs.losses, cfg.gamma), rw,
                            cfg.batch_m)
    grad_sq = flat_norm_sq(mean, sizes)
    probes = None
    if telem is not None:
        probes = _probes.flat_round_probes(
            telem, flat=gm, sizes=sizes,
            gains=mask.float() if hm is None else hm,
            noise_pow=lanes.noise_power(), drift_ref=lanes.drift_ref(),
            gain_mean=gain_mean,
            update_norm=torch.sqrt(flat_norm_sq(update, sizes)))
        probes = _service_probes(telem, probes, lanes.stale, rw, age, n,
                                lanes.rate_expected, lanes.decay)
    return theta_next, (reward, grad_sq, gain_mean), probes, stale_next


def _fold(lanes: _Lanes, acc: torch.Tensor, g: torch.Tensor,
          h: Optional[torch.Tensor] = None,
          wire: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fold a block into each lane's running sum, strictly sequentially:
    ``acc + h_0 g_0 + h_1 g_1 + ...`` over ``(L, P)`` sums, ``(L, b, P)``
    rows and ``(L, b)`` gains (``h=None``: the plain rows).  On the card
    ONE launch of K1's lane form over ``[acc; g]`` with gains ``[1; h]``,
    sigma 0 and scale 1, the rows cast through ``wire`` first; on the CPU
    the per-row fold of ``ota.stream_fold_block``'s plain chain."""
    if lanes.fold_backend == "cuda":
        if wire is not None:
            g = g.to(wire).float()
        ones = torch.ones((g.shape[0], 1), device=g.device)
        gains = torch.cat([ones, torch.ones(g.shape[:2], device=g.device)
                           if h is None else h.float()], 1)
        return ota_fused.fused_aggregate_lanes(
            torch.cat([acc.unsqueeze(1), g], 1), gains, sigma=0.0, scale=1.0,
            with_noise=False)
    for i in range(g.shape[1]):
        row = g[:, i]
        acc = acc + (row if h is None else h[:, i:i + 1] * row)
    return acc


def _tail(lanes: _Lanes, v: torch.Tensor, seeds: torch.Tensor,
          theta: Optional[torch.Tensor] = None,
          w_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The streamed server tail over each lane's superposition ``v``: the
    AWGN and the normalisation, retargeted at the service weight
    ``w_norm`` (``ota._participation_rescale``) when given, and the SGD
    step when ``theta`` is.  ONE launch of K1's lane form on the card
    (``ota.stream_finalize[_apply]`` with a lane axis), the plain chain
    lane by lane on the CPU."""
    n = lanes.cfg.n_agents
    if lanes.backend == "cuda":
        ones = torch.ones((v.shape[0], 1), device=v.device)
        kw = dict(sigma=lanes.sigma_t, scale=lanes.scale_t, seed=seeds,
                  with_noise=lanes.noisy,
                  rescale=None if w_norm is None
                  else ota._participation_rescale(n, w_norm).contiguous())
        if theta is None:
            return ota_fused.fused_aggregate_lanes(v.unsqueeze(1), ones, **kw)
        return ota_fused.fused_aggregate_sgd_lanes(
            v.unsqueeze(1), ones, theta, alpha=lanes.alpha_t, **kw)
    out = []
    for i, o in enumerate(lanes.otas):
        u = ota._server_epilogue(
            o, seeds[i], _unflatten_stack(v[i:i + 1], lanes.shapes), n, n,
            None if w_norm is None else w_norm[i])
        uf, _ = flatten_params(u)
        out.append(uf if theta is None
                   else theta[i] - lanes.specs[i].alpha * uf)
    return torch.stack(out)


def _streamed_round(lanes: _Lanes, theta: torch.Tensor, gens,
                    telem: Optional[TelemetryConfig], d: RoundDraws):
    """:func:`_plain_round` block by block over the agent axis (module
    docstring): the exact-mean numerator and the channel signal are strict
    sequential folds, so the history is bitwise the same for every block
    size; only the per-agent returns, O(N) scalars, outlive a block."""
    cfg, n, sizes = lanes.cfg, lanes.cfg.n_agents, lanes.sizes
    dr = _draw_rollouts(lanes, gens, d)
    h = None
    if lanes.ota is not None:
        h, seeds = _uplink_draws(lanes, gens, d)
    want_norms = telem is not None and (telem.grad_norms or telem.dispersion)
    gsum = v = torch.zeros_like(theta)
    returns, norms = [], []
    for lo, hi in lanes.blocks:
        trajs, grads = _rollout_and_grads(lanes, theta, dr, lo, hi)
        gsum = _fold(lanes, gsum, grads)
        if h is not None:
            v = _fold(lanes, v, grads, h[:, lo:hi], lanes.wire)
        returns.append(discounted_return(trajs.losses, cfg.gamma))
        if want_norms:
            norms.append(flat_norm_sq(grads, sizes))
    reward = -fixed_mean(torch.cat(returns, 1), 2)
    mean = gsum / n
    grad_sq = flat_norm_sq(mean, sizes)
    if h is None:
        theta_next = theta - lane_param(lanes.alpha, 1) * mean
        gain_mean = torch.ones(lanes.n_lanes, device=lanes.dev)
    else:
        theta_next = _tail(lanes, v, seeds, theta)
        gain_mean = fixed_mean(h, 1)
    probes = None
    if telem is not None:
        update_norm = torch.sqrt(grad_sq) if h is None else torch.sqrt(
            flat_norm_sq(theta - theta_next, sizes)) / lanes.alpha_t
        probes = _probes.flat_streamed_round_probes(
            telem, v=None if h is None else v, sizes=sizes,
            norms_sq=torch.cat(norms, 1) if want_norms else None,
            noise_pow=lanes.noise_power(), drift_ref=lanes.drift_ref(),
            gain_mean=gain_mean, update_norm=update_norm)
    return theta_next, (reward, grad_sq, gain_mean), probes


def _streamed_service_round(lanes: _Lanes, theta: torch.Tensor, gens,
                            telem: Optional[TelemetryConfig], svc_seed,
                            k: int, stale: Optional[_StaleLanes],
                            d: RoundDraws):
    """:func:`_service_round` block by block over the agent axis.  The
    mask, the replay weights and W come before the block loop; each block
    folds its masked estimates (gains: the mask), its stale rows (gains:
    the replay weights) and its channel signal (gains: the masked h); the
    server tail retargets the normaliser at W on the device."""
    cfg, n, dev, sizes = lanes.cfg, lanes.cfg.n_agents, lanes.dev, lanes.sizes
    part = lanes.part
    mask = _round_mask(part, svc_seed, k, n, dev, d, rate=lanes.rate,
                      deadline=lanes.deadline).expand(lanes.n_lanes, n)
    age = None if stale is None else stale.age
    rw = _round_weights(part, lanes.stale, mask, age, lanes.expected_t,
                       lanes.decay)
    pmask = rw.mask.float()
    dr = _draw_rollouts(lanes, gens, d)
    hm = None
    if lanes.ota is not None:
        h, seeds = _uplink_draws(lanes, gens, d)
        hm = torch.where(mask, h, torch.zeros_like(h))
    want_norms = telem is not None and (telem.grad_norms or telem.dispersion)
    gsum = ssum = v = torch.zeros_like(theta)
    returns, new_rows, norms = [], [], []
    for lo, hi in lanes.blocks:
        trajs, grads = _rollout_and_grads(lanes, theta, dr, lo, hi)
        gsum = _fold(lanes, gsum, grads, pmask[:, lo:hi])
        if stale is not None:
            old = stale.grads[:, lo:hi]
            ssum = _fold(lanes, ssum, old, rw.rw[:, lo:hi])
            new_rows.append(torch.where(mask[:, lo:hi, None], grads, old))
        if hm is not None:
            v = _fold(lanes, v, grads, hm[:, lo:hi], lanes.wire)
        returns.append(discounted_return(trajs.losses, cfg.gamma))
        if want_norms:
            norms.append(flat_norm_sq(grads, sizes))
    inv_w = rw.inv_w.unsqueeze(-1)
    if stale is not None:
        gsum = gsum + ssum
    mean = gsum * inv_w
    grad_sq = flat_norm_sq(mean, sizes)
    if hm is None:
        gain_mean = torch.ones(lanes.n_lanes, device=dev)
        update = mean
    else:
        update = _tail(lanes, v, seeds, w_norm=rw.w_norm)
        if stale is not None:
            update = update + ssum * inv_w
        gain_mean = _service_gain_mean(hm, rw)
    theta_next = theta - lane_param(lanes.alpha, 1) * update
    reward = _service_reward(torch.cat(returns, 1), rw, cfg.batch_m)
    stale_next = None if stale is None else _StaleLanes(
        grads=torch.cat(new_rows, 1), age=svc_stale.next_age(age, mask))
    probes = None
    if telem is not None:
        norms_sq = None
        if want_norms:
            norms_sq = torch.where(mask, torch.cat(norms, 1),
                                   torch.zeros((), device=dev))
        probes = _probes.flat_streamed_round_probes(
            telem, v=None if hm is None else v, sizes=sizes,
            norms_sq=norms_sq, noise_pow=lanes.noise_power(),
            drift_ref=lanes.drift_ref(), gain_mean=gain_mean,
            update_norm=torch.sqrt(flat_norm_sq(update, sizes)))
        probes = _service_probes(telem, probes, lanes.stale, rw, age, n,
                                lanes.rate_expected, lanes.decay)
    return theta_next, (reward, grad_sq, gain_mean), probes, stale_next


def _round(lanes: _Lanes, theta: torch.Tensor, gens,
           telem: Optional[TelemetryConfig], svc_seed, k: int,
           stale: Optional[_StaleLanes], d: RoundDraws):
    """One round of every lane, of the form ``lanes`` was built for:
    ``(theta', metrics, probes, stale')``."""
    if lanes.part is None:
        fn = _plain_round if lanes.blocks is None else _streamed_round
        return fn(lanes, theta, gens, telem, d) + (None,)
    fn = _service_round if lanes.blocks is None else _streamed_service_round
    return fn(lanes, theta, gens, telem, svc_seed, k, stale, d)


def run_lanes(env, policy, cfg: FedPGConfig, specs: Sequence[LaneSpec], *,
              theta0: Optional[Params] = None,
              telemetry: Optional[TelemetryConfig] = None,
              ota_backend: str = "auto",
              agent_blocks: Optional[int] = None,
              device: DeviceLike = None) -> Tuple[Params, History]:
    """Run the lanes ``specs`` (module docstring); returns ``(theta_K,
    History)`` with a leading lane axis on every leaf and field.  ``env``
    is the env of lanes whose spec names none; ``theta0``, when given, is
    every lane's start (no draw); ``agent_blocks`` streams the agent axis
    in blocks of that many agents.  Each spec's participation and
    staleness must be normalised (``service.*.normalize``)."""
    if not specs:
        raise ValueError("no lanes")
    if cfg.estimator not in gpomdp.ESTIMATORS:
        raise ValueError(f"unknown estimator {cfg.estimator!r}")
    dev = resolve_device(device)
    n = cfg.n_agents
    specs = list(specs)
    _check_structure(specs, n)
    telem = _probes.active(telemetry, specs[0].participation)
    gens = [make_generator(s.seed, dev) for s in specs]
    if theta0 is None:
        thetas = [policy.init(g, dev) for g in gens]
    else:
        thetas = [{k: v.to(dev) for k, v in theta0.items()}] * len(specs)
    theta = torch.stack([flatten_params(t)[0] for t in thetas])  # (L, P)
    lanes = _Lanes(env, policy, cfg, specs, dev, ota_backend,
                   [(k, thetas[0][k].shape) for k in sorted(thetas[0])],
                   agent_blocks)
    svc_seed = stale = None
    if lanes.part is not None:   # after theta_0, as a service run draws it
        svc_seed = torch.stack([sample_seed(g, dev) for g in gens]) \
            .reshape(-1, 1)
        if lanes.stale is not None:
            stale = _StaleLanes(
                grads=torch.zeros((len(specs), n, theta.shape[1]),
                                  device=dev),
                age=torch.full((len(specs), n), svc_stale.AGE_NEVER,
                               dtype=torch.int32, device=dev))
    d = RoundDraws()
    metrics, tele = [], []
    for k in range(cfg.n_rounds):
        theta, m, pr, stale = _round(lanes, theta, gens, telem, svc_seed, k,
                                     stale, d)
        metrics.append(m)
        tele.append(pr)
    rewards, grad_sq, gain_mean = (torch.stack(x, dim=1)
                                   for x in zip(*metrics))
    probes = _probes.stack(tele, 1) if telem is not None else None
    theta_k = _unflatten_stack(theta, lanes.shapes)
    return theta_k, History(rewards=rewards, grad_sq=grad_sq,
                            gain_mean=gain_mean, telemetry=probes)


def lane_round_fn(env, policy, cfg: FedPGConfig,
                  ota_cfg: Optional[OTAConfig], ota_backend: str,
                  part: Optional[ParticipationConfig],
                  stale_cfg: Optional[StalenessConfig],
                  telem: Optional[TelemetryConfig],
                  agent_blocks: Optional[int] = None):
    """:func:`fedpg.make_round_fn`'s round, stacked or streamed, plain or
    service: this module's round at one lane, over a run's dict parameters
    (a :class:`ServiceState` in a service round), drawing from the run's
    generator or taking :class:`RoundDraws`.  ``part`` and ``stale_cfg``
    normalised, ``telem`` active or None."""
    spec = LaneSpec(0, cfg.alpha, ota_cfg, None, part, stale_cfg)
    built: Dict[Any, _Lanes] = {}

    def round_fn(carry, generator: Optional[torch.Generator],
                 draws: Optional[RoundDraws] = None):
        d = draws or RoundDraws()
        params = carry if part is None else carry.theta
        theta, _ = flatten_params(params)
        shapes = [(k, params[k].shape) for k in sorted(params)]
        key = (theta.device, tuple(shapes))
        if key not in built:
            built[key] = _Lanes(env, policy, cfg, [spec], theta.device,
                                ota_backend, shapes, agent_blocks)
        lanes = built[key]
        stale = seed = None
        if part is not None:
            if stale_cfg is not None:
                flat, _, _ = flatten_agent_stack(carry.stale.grads)
                stale = _StaleLanes(flat[None], carry.stale.age[None])
            seed = carry.seed.reshape(1, 1) if isinstance(
                carry.seed, torch.Tensor) else carry.seed
        theta_next, metrics, probes, stale = _round(
            lanes, theta[None], [generator], telem, seed,
            0 if part is None else carry.round_idx, stale, d)
        theta_next = {k: v[0] for k, v in
                      _unflatten_stack(theta_next, shapes).items()}
        if part is None:
            carry_next = theta_next
        else:
            carry_next = carry._replace(
                theta=theta_next, round_idx=carry.round_idx + 1,
                stale=None if stale is None else svc_stale.StaleState(
                    grads=_unflatten_stack(stale.grads[0], shapes),
                    age=stale.age[0]))
        out = tuple(x[0] for x in metrics)
        if probes is not None:
            out += (_probes.index(probes, 0),)
        return carry_next, out

    return round_fn
