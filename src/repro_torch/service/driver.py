"""Host-side continuous round service over the service rounds.

Counterpart of ``repro/service/driver.py``.  :class:`RoundService` runs the
service round of ``fedpg.make_round_fn(participation=..., staleness=...)``
as a long-running loop: rounds execute in *commit segments* of
``rounds_per_commit`` rounds (stacked, or agent-streamed with
``agent_blocks``); the :class:`~repro_torch.service.participation.
ServiceState` is carried between commits; each commit waits for the card
once, copies its metrics to the host in one transfer, and writes a ledger
event with the service's telemetry (realised participation rate,
realised-vs-expected debias drift, staleness age histogram) under a
``trace`` span.

Determinism and resume: round ``r`` draws from
``utils.device.index_generator(seed, r)``, a generator that is a function
of (seed, r) alone (the JAX driver's ``fold_in(round_key, r)``), and
theta_0 and the mask-stream seed come from ``index_generator(seed, -1)``.
The masks are the counter-hash stream keyed on that seed and the
checkpointed ``round_idx``.  So a service resumed from a checkpoint, which
holds theta, ``round_idx``, the mask seed and the stale buffer and no
generator state, replays the uninterrupted run bit for bit.

``draws=`` (round index -> ``fedpg.RoundDraws``) injects a round's draws
instead, the hook the parity tests use to replay the JAX driver's.
Checkpoints go through :mod:`repro_torch.checkpoint` (atomic ``.npz`` +
manifest).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import fedpg
from repro_torch.core.ota import sample_seed
from repro_torch.service import participation as svc_part
from repro_torch.service import staleness as svc_stale
from repro_torch.service.participation import ParticipationConfig, ServiceState
from repro_torch.service.staleness import StalenessConfig, StaleState
from repro_torch.telemetry import probes as _probes
from repro_torch.telemetry import trace
from repro_torch.telemetry.ledger import get_ledger
from repro_torch.telemetry.probes import RoundTelemetry, TelemetryConfig
from repro_torch.utils.device import DeviceLike, index_generator, resolve_device

__all__ = ["RoundService", "ServiceConfig"]


@dataclass(frozen=True)
class ServiceConfig:
    """Host-side service loop policy."""

    rounds_per_commit: int = 8     # rounds per segment / ledger event
    max_rounds: int = 64           # total rounds before the service stops
    round_deadline_s: Optional[float] = None  # wall-clock budget per round
    checkpoint_dir: str = ""       # "" disables checkpointing
    checkpoint_every: int = 1      # checkpoint every this many commits

    def __post_init__(self):
        if self.rounds_per_commit < 1:
            raise ValueError("rounds_per_commit must be >= 1")
        if self.max_rounds < 1:
            raise ValueError("max_rounds must be >= 1")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")


def _to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Device tensors -> numpy arrays of their shapes and dtypes, in one
    device-to-host copy (float64 holds every float32 and int32 value)."""
    flat = torch.cat([t.reshape(-1).double() for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        dtype = np.int64 if not t.is_floating_point() else np.float32
        out.append(flat[off:off + n].reshape(tuple(t.shape)).astype(dtype))
        off += n
    return out


class RoundService:
    """A continuous federated round service with partial participation.

    ``participation`` must be *active* (one that can drop agents, see
    :func:`repro_torch.service.participation.normalize`): a config that
    normalises away is plain ``fedpg.run``.  ``ota``, ``telemetry``,
    ``agent_blocks`` and ``ota_backend`` mean what they mean for
    :func:`repro_torch.core.fedpg.run`.  ``seed`` is the run's seed (module
    docstring); ``device=None`` means cuda and raises without a GPU."""

    def __init__(self, env, policy, cfg: fedpg.FedPGConfig, seed: int = 0, *,
                 participation: ParticipationConfig,
                 staleness: Optional[StalenessConfig] = None,
                 ota=None, telemetry: Optional[TelemetryConfig] = None,
                 agent_blocks: Optional[int] = None,
                 ota_backend: str = "auto",
                 service: ServiceConfig = ServiceConfig(),
                 theta0=None,
                 draws: Optional[Callable[[int], fedpg.RoundDraws]] = None,
                 device: DeviceLike = None):
        part = svc_part.normalize(participation, cfg.n_agents)
        if part is None:
            raise ValueError(
                "RoundService needs an active participation config (one "
                "that can drop agents); full participation is plain "
                "fedpg.run")
        stale = svc_stale.normalize(staleness, part)
        self.cfg = cfg
        self.service = service
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._stale = stale
        self._draws = draws
        self._round_fn = fedpg.make_round_fn(
            fedpg.env_on(env, self.device), policy, cfg, ota,
            ota_backend=ota_backend, telemetry=telemetry,
            agent_blocks=agent_blocks, participation=part, staleness=stale)
        gen = index_generator(self.seed, -1, self.device)
        theta = policy.init(gen, self.device) if theta0 is None else {
            k: v.to(self.device) for k, v in theta0.items()}
        self.state: ServiceState = svc_part.init_state(
            theta, sample_seed(gen, self.device), cfg.n_agents, stale)
        self._commits = 0

    # -- checkpointing -----------------------------------------------------

    def _ckpt_tree(self, state: ServiceState) -> Dict[str, Any]:
        tree = {
            "theta": state.theta,
            "round_idx": torch.tensor(state.round_idx, dtype=torch.int32),
            "mask_seed": state.seed,
        }
        if state.stale is not None:
            tree["stale_grads"] = state.stale.grads
            tree["stale_age"] = state.stale.age
        return tree

    def checkpoint(self) -> Optional[str]:
        """Write the current service state; returns the path (None when
        checkpointing is off)."""
        if not self.service.checkpoint_dir:
            return None
        from repro_torch import checkpoint as ckpt

        return ckpt.save(self.service.checkpoint_dir, self.state.round_idx,
                         self._ckpt_tree(self.state))

    def resume(self) -> bool:
        """Restore the latest checkpoint, if any; True when one was loaded.
        The next commit continues from its round, with the draws and masks
        of the uninterrupted run."""
        if not self.service.checkpoint_dir:
            return False
        from repro_torch import checkpoint as ckpt

        step = ckpt.latest_step(self.service.checkpoint_dir)
        if step is None:
            return False
        tree = ckpt.restore(self.service.checkpoint_dir, step,
                            self._ckpt_tree(self.state))
        stale = None
        if self._stale is not None:
            stale = StaleState(grads=tree["stale_grads"],
                               age=tree["stale_age"])
        self.state = ServiceState(theta=tree["theta"],
                                  round_idx=int(tree["round_idx"]),
                                  seed=tree["mask_seed"], stale=stale)
        return True

    # -- the service loop --------------------------------------------------

    def commit(self) -> Dict[str, Any]:
        """Run one commit segment (``rounds_per_commit`` service rounds);
        advances the state and returns the commit record, which is also
        written to the ambient ledger (if one is installed)."""
        svc = self.service
        seg = svc.rounds_per_commit
        r0 = self.state.round_idx
        with trace.span("service_commit", device=self.device, round_start=r0,
                        rounds=seg) as sp:
            state, metrics = self.state, []
            for r in range(r0, r0 + seg):
                draws = None if self._draws is None else self._draws(r)
                state, m = self._round_fn(
                    state, index_generator(self.seed, r, self.device), draws)
                metrics.append(m)
            tensors = [torch.stack([m[i] for m in metrics]) for i in range(3)]
            tel = (_probes.stack([m[3] for m in metrics], 0)
                   if len(metrics[0]) == 4 else None)
            fields = [] if tel is None else [
                i for i, x in enumerate(tel) if x is not None]
            tensors += [tel[i] for i in fields]
            if self._stale is not None:
                tensors.append(state.stale.age)
            host = _to_host(tensors)
        self.state = state
        self._commits += 1

        rewards, grad_sq, gain_mean = host[:3]
        rec: Dict[str, Any] = {
            "round_start": r0,
            "round_end": r0 + seg,
            "reward": float(np.mean(rewards)),
            "grad_sq": float(np.mean(grad_sq)),
            "gain_mean": float(np.mean(gain_mean)),
            "wall_us": sp.duration_us,
        }
        if tel is not None:
            values = [None] * len(RoundTelemetry._fields)
            for i, arr in zip(fields, host[3:]):
                values[i] = arr
            summary = _probes.summarize(RoundTelemetry(*values))
            rec.update({k: v for k, v in summary.items() if k in (
                "participation_rate", "participation_drift",
                "staleness_mean")})
        if self._stale is not None:
            # bucket k = agents whose copy is k rounds old; the last bucket
            # = too old or never contributed (AGE_NEVER saturates the clip)
            hist = np.bincount(np.clip(host[-1], 0, self._stale.max_age + 1),
                               minlength=self._stale.max_age + 2)
            rec["staleness_hist"] = [int(c) for c in hist]
        per_round_s = sp.duration_us / 1e6 / seg
        if svc.round_deadline_s is not None \
                and per_round_s > svc.round_deadline_s:
            rec["deadline_exceeded"] = True
            rec["per_round_s"] = per_round_s
        ledger = get_ledger()
        if ledger is not None:
            ledger.log_service(**rec)
        if svc.checkpoint_dir and self._commits % svc.checkpoint_every == 0:
            self.checkpoint()
        return rec

    def run(self) -> List[Dict[str, Any]]:
        """Run commits until ``max_rounds``; returns the commit records."""
        records = []
        while self.state.round_idx < self.service.max_rounds:
            records.append(self.commit())
        return records
