"""The paper's own experiment configuration (Section IV).

Counterpart of ``repro/configs/ota_pg_particle.py``: LandmarkNav particle
env, two-layer MLP policy (16 hidden, ReLU, softmax over 5 actions), T=20,
gamma=0.99, sigma^2 = -60 dB; Rayleigh (alpha=1e-4) and Nakagami-m (m=0.1,
Omega=1, alpha=1e-3) channel settings, 20 Monte Carlo runs.
"""
from dataclasses import dataclass

from repro_torch.core.channel import noise_sigma_from_db
from repro_torch.core.fedpg import FedPGConfig


@dataclass(frozen=True)
class PaperSetting:
    name: str
    channel: str
    channel_kwargs: tuple        # ((key, value), ...) — hashable
    alpha: float
    noise_sigma: float
    horizon: int = 20
    gamma: float = 0.99
    mc_runs: int = 20

    def fedpg(self, *, n_agents: int, batch_m: int, n_rounds: int) -> FedPGConfig:
        return FedPGConfig(
            n_agents=n_agents,
            batch_m=batch_m,
            horizon=self.horizon,
            gamma=self.gamma,
            alpha=self.alpha,
            n_rounds=n_rounds,
        )


RAYLEIGH = PaperSetting(
    name="rayleigh",
    channel="rayleigh",
    channel_kwargs=(),
    alpha=1e-4,
    noise_sigma=noise_sigma_from_db(-60.0),
)

NAKAGAMI = PaperSetting(
    name="nakagami",
    channel="nakagami",
    channel_kwargs=(("m", 0.1), ("omega", 1.0)),
    alpha=1e-3,
    noise_sigma=noise_sigma_from_db(-60.0),
)
