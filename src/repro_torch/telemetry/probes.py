"""In-round probes: per-round diagnostics beside the History metrics.

Counterpart of ``repro/telemetry/probes.py``.  A :class:`TelemetryConfig`
passed to ``fedpg.run`` / ``monte_carlo`` / ``sweep`` makes each round emit
a :class:`RoundTelemetry` of float32 values beside its metrics:

=================  =========================================================
``snr``            effective receive SNR ``||sum_i h_i g_i||^2 / (d sigma^2)``
                   (``inf`` for noiseless and exact uplinks)
``grad_norm_pre``  mean per-agent local gradient norm (pre-aggregation)
``grad_norm_post`` norm of the applied server update ``u_k``
``moment_drift``   realised ``mean(h)`` minus the closed-form effective
                   ``m_h`` (``ota.effective_gain_mean``): the debias error
``dispersion``     ``max_i ||g_i|| / mean_i ||g_i||``
=================  =========================================================

and, in a service round, ``participation_rate`` (realised count / N),
``participation_drift`` (realised minus expected rate) and
``staleness_mean`` (mean age of the replayed rows).  Disabled probes hold
NaN; the service fields are None outside service rounds.

The probes read what the round already holds (the gradient stack, the
gains, the update) and write nothing the round reads, so a run with
telemetry has the same history, bit for bit, as the run without it.  Every
sum runs in the fixed order of ``utils.tree.fixed_sum`` over flat
``(..., N, P)`` stacks, so a lane of a lane-batched run (a leading lane
axis) gets the probes of the same run alone, bitwise; the streamed round's
probes (:func:`flat_streamed_round_probes`) take the lane axis too.  Every
division that can take a per-lane value divides by a device tensor, in
both forms.

Not ported here: the agent-mesh forms (``sharded_*``), which wait for the
agent-mesh slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.utils.tree import (
    Params, fixed_mean, flat_norm_sq, flatten_agent_stack, flatten_params,
    leaf_sizes,
)

__all__ = ["RoundTelemetry", "TelemetryConfig", "active", "flat_round_probes",
           "flat_streamed_round_probes", "index", "noise_power",
           "participation_probes", "stacked_round_probes",
           "streamed_round_probes", "summarize"]

Value = Union[float, torch.Tensor]


@dataclass(frozen=True)
class TelemetryConfig:
    """Probe selection; all probes default on.  A config with every base
    probe off is inactive (:func:`active`): the run is the telemetry-off
    run."""

    snr: bool = True
    grad_norms: bool = True
    moment_drift: bool = True
    dispersion: bool = True
    participation: bool = True

    @property
    def active(self) -> bool:
        # excludes ``participation``: the service probes exist only in
        # service rounds, so the flag alone does not switch telemetry on
        return self.snr or self.grad_norms or self.moment_drift \
            or self.dispersion


def active(telemetry: Optional[TelemetryConfig],
           participation: Any = None) -> Optional[TelemetryConfig]:
    """Normalise: a config with every probe off is telemetry-off; the
    ``participation`` flag counts only with an active (normalised)
    participation config (JAX ``fedpg._active_telemetry``)."""
    if telemetry is None:
        return None
    if telemetry.active or (participation is not None
                            and telemetry.participation):
        return telemetry
    return None


class RoundTelemetry(NamedTuple):
    """Per-round probe values: float32 scalars in a round, ``(K,)`` over a
    run, ``(runs, K)`` from ``monte_carlo``, ``(S, runs, K)`` from the
    sweep.  Disabled probes hold NaN; the service fields are None outside
    service rounds."""

    snr: torch.Tensor
    grad_norm_pre: torch.Tensor
    grad_norm_post: torch.Tensor
    moment_drift: torch.Tensor
    dispersion: torch.Tensor
    participation_rate: Optional[torch.Tensor] = None
    participation_drift: Optional[torch.Tensor] = None
    staleness_mean: Optional[torch.Tensor] = None


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full(like.shape, value, dtype=torch.float32,
                      device=like.device)


def noise_power(dim: int, sigma: float, device) -> torch.Tensor:
    """``d * sigma^2`` rounded as the JAX probe forms it in float32
    (``square(float32(sigma))``, then times d), as a device scalar so the
    SNR divides tensor by tensor (no host-to-device copy)."""
    s = np.float32(sigma)
    return torch.full((), float(np.float32(dim) * (s * s)),
                      dtype=torch.float32, device=device)


def flat_round_probes(config: TelemetryConfig, *, flat: torch.Tensor,
                      sizes: List[int], gains: Optional[torch.Tensor],
                      noise_pow: Optional[torch.Tensor], drift_ref: Value,
                      gain_mean: torch.Tensor,
                      update_norm: torch.Tensor) -> RoundTelemetry:
    """The round probes over a flat ``(..., N, P)`` gradient stack (leaf
    slices of ``sizes``, key order) and ``(..., N)`` gains; ``noise_pow``
    is ``d sigma^2`` (``(...)``), None for a noiseless or exact uplink."""
    nan = _const(math.nan, gain_mean)
    snr = grad_pre = grad_post = drift = disp = nan
    if config.snr:
        if noise_pow is None:
            snr = _const(math.inf, gain_mean)
        else:
            from repro_torch.core import ota   # imports nothing of telemetry

            snr = ota.flat_signal_power_sq(flat, gains, sizes) / noise_pow
    if config.grad_norms or config.dispersion:
        norms = torch.sqrt(flat_norm_sq(flat, sizes))      # (..., N)
        mean = fixed_mean(norms, 1)
        if config.grad_norms:
            grad_pre = mean
            grad_post = update_norm.float()
        if config.dispersion:
            disp = torch.amax(norms, dim=-1) / mean
    if config.moment_drift:
        drift = (gain_mean - drift_ref).float()
    return RoundTelemetry(snr=snr, grad_norm_pre=grad_pre,
                          grad_norm_post=grad_post, moment_drift=drift,
                          dispersion=disp)


def _drift_reference(ota_cfg, n_agents: int) -> float:
    from repro_torch.core import ota

    return ota.effective_gain_mean(ota_cfg, n_agents)


def stacked_round_probes(config: TelemetryConfig, *, grads_stacked: Params,
                         gains: torch.Tensor, ota_cfg, n_agents: int,
                         gain_mean: torch.Tensor,
                         update_norm: torch.Tensor) -> RoundTelemetry:
    """Probes of the stacked round: ``grads_stacked`` a dict of ``(N, ...)``
    leaves, ``gains`` the round's ``(N,)`` realisation (ones for the exact
    uplink), ``update_norm`` ``||u_k||``."""
    flat, _, _ = flatten_agent_stack(grads_stacked)
    sizes = [int(grads_stacked[k][0].numel()) for k in sorted(grads_stacked)]
    noisy = ota_cfg is not None and ota_cfg.noise_sigma > 0.0
    return flat_round_probes(
        config, flat=flat, sizes=sizes, gains=gains,
        noise_pow=(noise_power(sum(sizes), ota_cfg.noise_sigma, flat.device)
                   if noisy else None),
        drift_ref=_drift_reference(ota_cfg, n_agents), gain_mean=gain_mean,
        update_norm=update_norm)


def streamed_round_probes(config: TelemetryConfig, *, v: Optional[Params],
                          norms_sq: Optional[torch.Tensor], ota_cfg,
                          n_agents: int, param_dim: int,
                          gain_mean: torch.Tensor,
                          update_norm: torch.Tensor) -> RoundTelemetry:
    """Probes of one agent-streamed round from its accumulators: ``v`` the
    channel superposition as a dict (None for the exact uplink),
    ``norms_sq`` the ``(N,)`` per-agent squared norms (None when both norm
    probes are off); :func:`flat_streamed_round_probes` on the flat
    layout."""
    noisy = ota_cfg is not None and ota_cfg.noise_sigma > 0.0
    flat = None if v is None else flatten_params(v)[0]
    return flat_streamed_round_probes(
        config, v=flat, sizes=None if v is None else leaf_sizes(v),
        norms_sq=norms_sq,
        noise_pow=(noise_power(param_dim, ota_cfg.noise_sigma,
                               gain_mean.device) if noisy else None),
        drift_ref=_drift_reference(ota_cfg, n_agents), gain_mean=gain_mean,
        update_norm=update_norm)


def flat_streamed_round_probes(config: TelemetryConfig, *,
                               v: Optional[torch.Tensor],
                               sizes: Optional[List[int]],
                               norms_sq: Optional[torch.Tensor],
                               noise_pow: Optional[torch.Tensor],
                               drift_ref: Value, gain_mean: torch.Tensor,
                               update_norm: torch.Tensor) -> RoundTelemetry:
    """Probes of the agent-streamed round from its accumulators, with any
    leading lane axis: ``v`` the flat ``(..., P)`` channel superposition
    (leaf slices of ``sizes``; None for the exact uplink), ``norms_sq``
    the ``(..., N)`` per-agent squared norms (None when both norm probes
    are off), ``noise_pow`` ``d sigma^2`` (None for a noiseless or exact
    uplink).  The norm statistics equal the stacked round's bitwise (the
    same per-agent values, the same reductions); the SNR's signal power
    folds the agents sequentially, so it agrees to summation order."""
    nan = _const(math.nan, gain_mean)
    snr = grad_pre = grad_post = drift = disp = nan
    if config.snr:
        snr = (_const(math.inf, gain_mean) if noise_pow is None
               else flat_norm_sq(v, sizes) / noise_pow)
    if config.grad_norms or config.dispersion:
        norms = torch.sqrt(norms_sq)
        mean = fixed_mean(norms, 1)
        if config.grad_norms:
            grad_pre = mean
            grad_post = update_norm.float()
        if config.dispersion:
            disp = torch.amax(norms, dim=-1) / mean
    if config.moment_drift:
        drift = (gain_mean - drift_ref).float()
    return RoundTelemetry(snr=snr, grad_norm_pre=grad_pre,
                          grad_norm_post=grad_post, moment_drift=drift,
                          dispersion=disp)


def participation_probes(config: TelemetryConfig, base: RoundTelemetry, *,
                         rate_realized: torch.Tensor, rate_expected: Value,
                         staleness_mean: Optional[torch.Tensor] = None
                         ) -> RoundTelemetry:
    """Attach the service probes: the realised participating fraction, its
    drift from the closed-form expectation, the mean replayed age (None
    without staleness).  With ``config.participation`` off they are NaN."""
    if not config.participation:
        nan = _const(math.nan, rate_realized)
        return base._replace(participation_rate=nan, participation_drift=nan,
                             staleness_mean=None if staleness_mean is None
                             else nan)
    rate = rate_realized.float()
    return base._replace(
        participation_rate=rate,
        participation_drift=(rate - rate_expected).float(),
        staleness_mean=None if staleness_mean is None
        else staleness_mean.float())


def stack(rounds: List[RoundTelemetry], dim: int = -1) -> RoundTelemetry:
    """Per-round probes stacked along a new round axis (None fields stay
    None)."""
    return RoundTelemetry(*(None if xs[0] is None else torch.stack(xs, dim)
                            for xs in zip(*rounds)))


def index(telemetry: Optional[RoundTelemetry],
          i) -> Optional[RoundTelemetry]:
    """Lane (run, or scenario) ``i`` of batched probes; None stays None."""
    if telemetry is None:
        return None
    return RoundTelemetry(*(None if x is None else x[i] for x in telemetry))


def summarize(telemetry) -> Optional[dict]:
    """NaN-aware mean of each probe over every axis (host side, for
    ledgers and tables): all-NaN (disabled) probes give None, a probe that
    is only ever infinite gives inf, absent service probes are skipped."""
    if telemetry is None:
        return None
    out = {}
    for name, arr in zip(RoundTelemetry._fields, telemetry):
        if arr is None:
            continue
        a = (arr.detach().cpu().double().numpy()
             if isinstance(arr, torch.Tensor) else np.asarray(arr, np.float64))
        finite = a[np.isfinite(a)]
        if finite.size:
            out[name] = float(np.mean(finite))
        elif np.isinf(a).any():
            out[name] = float("inf")
        else:
            out[name] = None
    return out
