"""Closed-form constants and bounds from the paper's analysis.

Counterpart of ``repro/core/theory.py``, copied as it is: the port imports
nothing of the JAX package, and this module imports neither JAX nor torch.
Everything here is pure float math so the benchmark tables and the property
tests can evaluate the theory against the simulated algorithm:

* Lemma 1   — smoothness constant  L = (F + G^2 + 2 gamma G^2/(1-gamma))
              * gamma * l_bar / (1-gamma)^2.
* Lemma 3   — gradient-estimate distortion bound, with
              V = G * l_bar * gamma / (1-gamma)^2.
* Theorem 1 — average squared-gradient-norm bound under the channel
              condition sigma_h^2 <= (N+1) m_h^2 (Eq. 10), with
              Lambda = M (N+1) m_h^2 - (M-1) sigma_h^2.
* Theorem 2 — unconditional bound (Eq. 11) with the O(1/N) channel floor.
* Corollary 1 — communication/sampling complexity schedules.
* ``theorem1_floor``/``theorem2_floor``/``applicable_bound`` — the K -> inf
  variance floors and the tightest-applicable-bound dispatcher; evaluate
  them with a channel's *effective* (m_h, sigma_h^2) (power control folded
  in, see ``repro_torch.core.power_control.effective_moments``) to read
  off how a transmit power policy moves the channel-variance floor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MDPConstants:
    """Problem constants the assumptions are stated in terms of."""

    G: float        # sup ||grad log pi||            (Assumption 2)
    F: float        # sup |d^2/dtheta^2 log pi|      (Assumption 2)
    l_bar: float    # sup loss                        (Assumption 1)
    gamma: float    # discount factor

    def smoothness_L(self) -> float:
        """Lemma 1: J is L-smooth."""
        g, f, lb, gam = self.G, self.F, self.l_bar, self.gamma
        return (f + g * g + 2.0 * gam * g * g / (1.0 - gam)) * (
            gam * lb / (1.0 - gam) ** 2
        )

    def V(self) -> float:
        """Lemma 3's gradient-norm envelope: V = G l_bar gamma/(1-gamma)^2.

        (= G * l_bar * sum_{t>=0} t gamma^t, the sup of any G(PO)MDP
        single-trajectory estimate's norm.)
        """
        return self.G * self.l_bar * self.gamma / (1.0 - self.gamma) ** 2

    def max_stepsize(self, m_h: float) -> float:
        """Theorem 1/2 step-size condition alpha <= 1/(m_h L)."""
        return 1.0 / (m_h * self.smoothness_L())


def Lambda(n_agents: int, batch_m: int, m_h: float, sigma_h2: float) -> float:
    """Lambda_{N,M}^{sigma_h, m_h} = M (N+1) m_h^2 - (M-1) sigma_h^2."""
    return batch_m * (n_agents + 1) * m_h**2 - (batch_m - 1) * sigma_h2


def channel_condition_ok(n_agents: int, m_h: float, sigma_h2: float) -> bool:
    """Theorem 1's channel condition sigma_h^2 <= (N+1) m_h^2."""
    return sigma_h2 <= (n_agents + 1) * m_h**2


def lemma3_bound(
    *,
    n_agents: int,
    batch_m: int,
    m_h: float,
    sigma_h2: float,
    noise_sigma2: float,
    V: float,
    grad_sq: float,
) -> float:
    """Eq. (9): bound on E|| v_k/(m_h N) - grad J ||^2 given ||grad J||^2."""
    n, m = n_agents, batch_m
    return (
        noise_sigma2 / n**2 / m_h**2
        + sigma_h2 * V**2 / (m * n * m_h**2)
        + (m * (sigma_h2 - m_h**2) - sigma_h2) / (m * n * m_h**2) * grad_sq
    )


def theorem1_bound(
    *,
    K: int,
    n_agents: int,
    batch_m: int,
    alpha: float,
    m_h: float,
    sigma_h2: float,
    noise_sigma2: float,
    delta_J: float,   # J(theta^0) - J(theta^*)
    V: float,
) -> float:
    """Eq. (10): bound on (1/K) sum_k E ||grad J(theta^k)||^2."""
    n, m = n_agents, batch_m
    lam = Lambda(n, m, m_h, sigma_h2)
    if lam <= 0:
        return math.inf
    return (
        2.0 * m * n * m_h * delta_J / (alpha * lam * K)
        + m * m_h**2 * noise_sigma2 / (n * lam)
        + sigma_h2 * V**2 / lam
    )


def theorem2_bound(
    *,
    K: int,
    n_agents: int,
    batch_m: int,
    alpha: float,
    m_h: float,
    sigma_h2: float,
    noise_sigma2: float,
    delta_J: float,
    V: float,
) -> float:
    """Eq. (11): unconditional bound; note the O(1/N) channel-variance floor
    (second term) that neither K nor M can reduce (Remark 3)."""
    n, m = n_agents, batch_m
    denom = m * (n + 1) * m_h**2 + sigma_h2
    return (
        2.0 * m * n * m_h * delta_J / (alpha * K * denom)
        + m * sigma_h2 * V**2 / denom
        + sigma_h2 * V**2 / denom
        + m * m_h**2 * noise_sigma2 / (n * denom)
    )


def theorem1_floor(
    *,
    n_agents: int,
    batch_m: int,
    m_h: float,
    sigma_h2: float,
    noise_sigma2: float,
    V: float,
) -> float:
    """Theorem 1's K -> inf limit: the variance floor no round count can
    beat.  This is the quantity transmit-power control moves — it is
    monotone in ``sigma_h2 / m_h^2``, the normalised channel variance."""
    lam = Lambda(n_agents, batch_m, m_h, sigma_h2)
    if lam <= 0:
        return math.inf
    return (
        batch_m * m_h**2 * noise_sigma2 / (n_agents * lam)
        + sigma_h2 * V**2 / lam
    )


def theorem2_floor(
    *,
    n_agents: int,
    batch_m: int,
    m_h: float,
    sigma_h2: float,
    noise_sigma2: float,
    V: float,
) -> float:
    """Theorem 2's K -> inf limit (Remark 3's O(1/N) channel floor)."""
    n, m = n_agents, batch_m
    denom = m * (n + 1) * m_h**2 + sigma_h2
    return (
        m * sigma_h2 * V**2 / denom
        + sigma_h2 * V**2 / denom
        + m * m_h**2 * noise_sigma2 / (n * denom)
    )


def floor_report(
    *,
    n_agents: int,
    batch_m: int,
    m_h: float,
    sigma_h2: float,
    noise_sigma2: float,
    V: float,
) -> dict:
    """Both K -> inf floors plus which one applies — the flat record run
    ledgers attach to every measured scenario (``floor`` is the applicable
    one: Theorem 1 when its channel condition holds and the floor is
    finite, Theorem 2 otherwise)."""
    kw = dict(n_agents=n_agents, batch_m=batch_m, m_h=m_h,
              sigma_h2=sigma_h2, noise_sigma2=noise_sigma2, V=V)
    f1 = theorem1_floor(**kw)
    f2 = theorem2_floor(**kw)
    ok = channel_condition_ok(n_agents, m_h, sigma_h2)
    which = "theorem1" if ok and math.isfinite(f1) else "theorem2"
    return {
        "floor_theorem1": f1,
        "floor_theorem2": f2,
        "channel_condition_ok": ok,
        "floor_which": which,
        "floor": f1 if which == "theorem1" else f2,
    }


def applicable_bound(
    *,
    K: int,
    n_agents: int,
    batch_m: int,
    alpha: float,
    m_h: float,
    sigma_h2: float,
    noise_sigma2: float,
    delta_J: float,
    V: float,
) -> Tuple[str, float]:
    """The tightest applicable bound for a channel's *effective*
    (m_h, sigma_h^2): Theorem 1 when its channel condition (Eq. 10's
    premise) holds, Theorem 2 otherwise.  Returns (which, value)."""
    kw = dict(K=K, n_agents=n_agents, batch_m=batch_m, alpha=alpha, m_h=m_h,
              sigma_h2=sigma_h2, noise_sigma2=noise_sigma2, delta_J=delta_J,
              V=V)
    if channel_condition_ok(n_agents, m_h, sigma_h2):
        b = theorem1_bound(**kw)
        if math.isfinite(b):
            return "theorem1", b
    return "theorem2", theorem2_bound(**kw)


@dataclass(frozen=True)
class ComplexitySchedule:
    """Corollary 1: (K, N, M) achieving an eps-approximate stationary point."""

    epsilon: float
    K: int            # communication rounds,   O(1/eps)
    n_agents: int     # agents,                 O(1/sqrt(eps))
    batch_m: int      # per-agent batch,        O(1/(N eps))

    @property
    def total_trajectories(self) -> int:
        """Per-agent sampling complexity K*M = O(1/(N eps^2))... the paper
        reports the *per-round per-agent* sampling complexity M = O(1/(N eps))."""
        return self.K * self.batch_m


def corollary1_schedule(epsilon: float, *, c_k: float = 1.0, c_n: float = 1.0,
                        c_m: float = 1.0) -> ComplexitySchedule:
    """Instantiate Corollary 1's asymptotic schedule with unit constants:
    K = ceil(c_k/eps), N = ceil(c_n/sqrt(eps)), M = ceil(c_m/(N eps))."""
    K = max(1, math.ceil(c_k / epsilon))
    N = max(1, math.ceil(c_n / math.sqrt(epsilon)))
    M = max(1, math.ceil(c_m / (N * epsilon)))
    return ComplexitySchedule(epsilon=epsilon, K=K, n_agents=N, batch_m=M)


def env_l_bar(env, horizon: int) -> float:
    """The Assumption-1 loss envelope for ``env`` at the *actual* horizon.

    Prefers the env's ``l_bar_for(horizon)`` hook (horizon-dependent
    envelopes: the landmark tasks drift ``step_size * T`` from the arena,
    so a fixed-``T`` constant silently under-states l_bar for longer runs);
    falls back to a static ``l_bar`` attribute.
    """
    fn = getattr(env, "l_bar_for", None)
    if callable(fn):
        return float(fn(horizon))
    lb = getattr(env, "l_bar", None)
    if lb is not None:
        return float(lb)
    raise ValueError(
        f"environment {type(env).__name__} exposes neither l_bar_for() nor "
        "l_bar; pass MDPConstants explicitly"
    )


def constants_for_env(
    env, *, horizon: int, gamma: float, G: float, F: float
) -> MDPConstants:
    """``MDPConstants`` with ``l_bar`` derived from the env at the configured
    horizon — the safe way to build theory tables (Theorem 1/2 bounds scale
    with ``l_bar^2`` through V, so a stale fixed-horizon envelope corrupts
    every bound)."""
    return MDPConstants(G=G, F=F, l_bar=env_l_bar(env, horizon), gamma=gamma)


def mlp_policy_constants(
    *, weight_bound: float, input_bound: float, hidden: int, n_actions: int,
    l_bar: float, gamma: float,
) -> MDPConstants:
    """Conservative (G, F) envelopes for a 2-layer ReLU-softmax policy.

    For softmax output, ||grad_logits log pi|| <= sqrt(2); back-propagating
    through a ReLU layer with bounded weights/inputs gives the crude Lipschitz
    products below.  These are *envelopes* for plugging into the bounds, not
    tight constants.
    """
    # d log pi / d logits is bounded by sqrt(2) in l2 for categorical softmax.
    lip_logits = math.sqrt(2.0)
    # gradient wrt last-layer weights: |hidden activation| * lip_logits
    g_w2 = lip_logits * weight_bound * input_bound * math.sqrt(hidden)
    # gradient wrt first-layer weights: lip through W2 (bounded) * input
    g_w1 = lip_logits * weight_bound * input_bound * math.sqrt(hidden)
    G = math.sqrt(g_w1**2 + g_w2**2)
    F = 2.0 * (weight_bound * input_bound) ** 2 * (1.0 + hidden)
    return MDPConstants(G=G, F=F, l_bar=l_bar, gamma=gamma)
