"""The port's round-service driver (``repro_torch.service.driver``), its run
ledger and report (``repro_torch.telemetry.ledger`` / ``report``) and the
per-index draws (``utils.device.index_generator``), on the CPU.

Against JAX: the port's ``RoundService``, fed through ``draws=`` with each
round's JAX draws (initial states, actions, gains, K1 seed, from
``fold_in(round_key, r)`` as the JAX driver derives them) and the JAX mask
of ``state.part_key``, against the JAX ``RoundService`` over 2 commits of 2
rounds (Bernoulli 0.5, staleness (2, 0.5), Rayleigh, sigma 1e-3, debias,
telemetry): theta and each commit record's floats at rtol 1e-6 (atol
1e-7 for the drift, a difference of two rates that may be 0),
``staleness_hist`` and the round range exactly.

Within the port, bitwise: a resumed service (2 commits, a checkpoint, a
fresh service that resumes) against the uninterrupted one, stacked and
agent-streamed; ``rounds_per_commit`` 1, 2 and 4.  The ledger and the report
as the JAX package's ``tests/test_service.py`` checks them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedpg as jax_fedpg
from repro.core import ota as jax_ota
from repro.core.channel import RayleighChannel as JaxRayleigh
from repro.rl import sampler as jax_sampler
from repro.rl.env import LandmarkNav as JaxLandmarkNav
from repro.rl.policy import MLPPolicy as JaxMLPPolicy
from repro.service import driver as jax_driver
from repro.service import participation as jax_part
from repro.service import staleness as jax_stale
from repro.telemetry import TelemetryConfig as JaxTelemetryConfig
from repro_torch import interop
from repro_torch.core import fedpg, ota
from repro_torch.core.channel import RayleighChannel
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy
from repro_torch.service import (
    ParticipationConfig, RoundService, ServiceConfig, StalenessConfig,
)
from repro_torch.telemetry import (
    Ledger, TelemetryConfig, read_ledger, using_ledger,
)
from repro_torch.telemetry import report
from repro_torch.utils.device import index_generator, index_seed

CFG = fedpg.FedPGConfig(n_agents=7, batch_m=1, horizon=4, n_rounds=1)
SIGMA = 1e-3
STALE = (2, 0.5)
RPC, ROUNDS = 2, 4
FLOATS = ("reward", "grad_sq", "gain_mean", "participation_rate",
          "participation_drift", "staleness_mean")


def _port_ota():
    return ota.OTAConfig(RayleighChannel(), noise_sigma=SIGMA, debias=True)


@functools.lru_cache(maxsize=None)
def _jax_driver(seed=5):
    """The JAX driver's records and final state, theta_0, and every round's
    draws and mask, derived as its segments derive them."""
    env, pol = JaxLandmarkNav(), JaxMLPPolicy()
    ocfg = jax_ota.OTAConfig(JaxRayleigh(), noise_sigma=SIGMA, debias=True)
    part = jax_part.ParticipationConfig(rate=0.5)
    scfg = jax_stale.StalenessConfig(*STALE)
    key = jax.random.key(seed)
    svc = jax_driver.RoundService(
        env, pol, CFG, key, participation=part, staleness=scfg, ota=ocfg,
        telemetry=JaxTelemetryConfig(), ota_backend="pallas",
        service=jax_driver.ServiceConfig(rounds_per_commit=RPC,
                                         max_rounds=ROUNDS))
    theta0 = {k: np.asarray(v) for k, v in svc.state.theta.items()}
    state, round_key = svc.state, svc._round_key
    round_fn = jax.jit(jax_fedpg.make_round_fn(
        env, pol, CFG, ocfg, ota_backend="pallas", participation=part,
        staleness=scfg, telemetry=JaxTelemetryConfig()))
    ids = jnp.arange(CFG.n_agents, dtype=jnp.int32)
    draws = []
    for r in range(ROUNDS):
        k = jax.random.fold_in(round_key, r)
        key_samp, key_chan = jax.random.split(k)
        trajs = jax.vmap(lambda kk: jax_sampler.rollout_batch(
            env, pol, state.theta, kk, CFG.horizon, CFG.batch_m))(
                jax.random.split(key_samp, CFG.n_agents))
        key_h, key_n = jax.random.split(key_chan)
        mask = jax_part.round_mask(part, state.part_key, state.sched_key,
                                   jnp.int32(r), ids, CFG.n_agents)
        draws.append(fedpg.RoundDraws(
            s0=torch.from_numpy(np.array(trajs.obs[:, :, 0])),
            actions=torch.from_numpy(np.array(trajs.actions, np.int64)),
            gains=torch.from_numpy(np.array(
                jax_ota.sample_gains(ocfg, key_h, CFG.n_agents))),
            seed=int(jax.random.bits(key_n, (), jnp.uint32)),
            mask=torch.from_numpy(np.array(mask))))
        state, _ = round_fn(state, k)
    records = svc.run()
    theta = {k: np.asarray(v) for k, v in svc.state.theta.items()}
    return theta0, tuple(draws), records, theta


def _service(seed=0, ckpt="", agent_blocks=None, rpc=RPC, rounds=8,
             draws=None, theta0=None, telemetry=True):
    return RoundService(
        LandmarkNav(), MLPPolicy(), CFG, seed,
        participation=ParticipationConfig(rate=0.5),
        staleness=StalenessConfig(*STALE), ota=_port_ota(),
        telemetry=TelemetryConfig() if telemetry else None,
        agent_blocks=agent_blocks,
        service=ServiceConfig(rounds_per_commit=rpc, max_rounds=rounds,
                              checkpoint_dir=str(ckpt)),
        theta0=theta0, draws=draws, device="cpu")


def test_driver_matches_jax_on_injected_draws():
    theta0, draws, want, theta_j = _jax_driver()
    svc = _service(rounds=ROUNDS, draws=lambda r: draws[r],
                   theta0=interop.from_numpy(theta0, "cpu"))
    got = svc.run()
    assert len(got) == len(want) == ROUNDS // RPC
    for g, w in zip(got, want):
        assert (g["round_start"], g["round_end"]) == (w["round_start"],
                                                      w["round_end"])
        assert g["staleness_hist"] == w["staleness_hist"]
        for k in FLOATS:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    for k, v in theta_j.items():
        np.testing.assert_allclose(svc.state.theta[k].numpy(), v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    counts = [int(d.mask.sum()) for d in draws]
    assert any(0 < c < CFG.n_agents for c in counts)


def _state_bits(svc):
    st = svc.state
    out = {f"theta/{k}": v for k, v in st.theta.items()}
    out.update({f"stale/{k}": v for k, v in st.stale.grads.items()})
    out["age"], out["seed"] = st.stale.age, st.seed
    return st.round_idx, {k: v.numpy().tobytes() for k, v in out.items()}


@pytest.mark.parametrize("agent_blocks", [None, 3], ids=["stacked",
                                                         "streamed"])
def test_resume_bitwise(tmp_path, agent_blocks):
    """8 rounds in 4 commits, against 2 commits (checkpointed), then a FRESH
    service that resumes and finishes: state and later records bitwise."""
    ref = _service(agent_blocks=agent_blocks)
    recs = ref.run()
    a = _service(ckpt=tmp_path, agent_blocks=agent_blocks)
    a.commit(), a.commit()
    b = _service(ckpt=tmp_path, agent_blocks=agent_blocks)
    assert b.resume() and b.state.round_idx == 4
    later = b.run()
    assert _state_bits(b) == _state_bits(ref)
    for g, w in zip(later, recs[2:]):
        assert {k: g[k] for k in FLOATS + ("staleness_hist",)} == \
            {k: w[k] for k in FLOATS + ("staleness_hist",)}


def test_resume_without_checkpoints():
    svc = _service()
    assert svc.checkpoint() is None and not svc.resume()


def test_rounds_per_commit_invariance():
    """The same 8 rounds in commits of 1, 2 and 4: bitwise equal states."""
    states = []
    for rpc in (1, 2, 4):
        svc = _service(rpc=rpc, telemetry=False)
        svc.run()
        states.append(_state_bits(svc))
    assert states[0] == states[1] == states[2]


def test_driver_requires_active_participation():
    with pytest.raises(ValueError, match="active participation"):
        RoundService(LandmarkNav(), MLPPolicy(), CFG, 0,
                     participation=ParticipationConfig(rate=1.0),
                     device="cpu")
    with pytest.raises(ValueError, match="rounds_per_commit"):
        ServiceConfig(rounds_per_commit=0)


def test_driver_deadline_flag():
    cfg = fedpg.FedPGConfig(n_agents=3, batch_m=1, horizon=3, n_rounds=1)
    svc = RoundService(
        LandmarkNav(), MLPPolicy(), cfg, 0,
        participation=ParticipationConfig(rate=0.5),
        service=ServiceConfig(rounds_per_commit=1, max_rounds=1,
                              round_deadline_s=1e-9), device="cpu")
    rec = svc.commit()
    assert rec.get("deadline_exceeded") is True and rec["per_round_s"] > 0


def test_driver_ledger_and_report(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    with Ledger(path) as led, using_ledger(led):
        led.log_platform()
        _service(rounds=4).run()
    events = read_ledger(path)
    assert [e["kind"] for e in events][:2] == ["ledger_start", "platform"]
    service = [e for e in events if e["kind"] == "service"]
    assert len(service) == 2
    for ev in service:
        assert {"round_start", "round_end", "reward", "grad_sq",
                "participation_rate", "participation_drift",
                "staleness_hist", "wall_us"} <= set(ev)
        assert 0.0 <= ev["participation_rate"] <= 1.0
        assert sum(ev["staleness_hist"]) == CFG.n_agents
    text = report.render(events)
    assert "## Round service" in text and "participation_rate" in text
    assert "## Platform" in text
    out = tmp_path / "REPORT.md"
    assert report.main([path, "-o", str(out)]) == 0
    assert out.read_text() == text


def test_log_sweep_with_floors(tmp_path):
    """``Ledger.log_sweep`` over the port's ``SweepResult``: one ``sweep``
    event, one ``scenario`` event per scenario with the measured values and
    the Theorem-1/2 floors, rendered in the report's scenario table."""
    from repro_torch.core import sweep, theory

    scen = sweep.grid(channel=RayleighChannel(), alpha=[1e-3, 2e-3],
                      n_agents=3, batch_m=2, horizon=6, n_rounds=4,
                      noise_sigma=1e-2)
    res = sweep.sweep(LandmarkNav(), MLPPolicy(), scen, 0, 2, device="cpu",
                      telemetry=TelemetryConfig())
    path = str(tmp_path / "ledger.jsonl")
    with Ledger(path) as led:
        consts = theory.constants_for_env(LandmarkNav(), horizon=6,
                                          gamma=0.99, G=1.0, F=1.0)
        led.log_sweep(res, constants=consts, label="t")
    events = read_ledger(path)
    sw = [e for e in events if e["kind"] == "sweep"]
    sc = [e for e in events if e["kind"] == "scenario"]
    assert len(sw) == 1 and sw[0]["n_scenarios"] == 2 and len(sc) == 2
    for i, ev in enumerate(sc):
        assert ev["avg_grad_sq"] == pytest.approx(res.avg_grad_sq(i))
        assert ev["distance_to_floor"] == pytest.approx(
            ev["avg_grad_sq"] - ev["floor"])
        assert "telemetry" in ev and ev["floor_which"] in ("theorem1",
                                                            "theorem2")
    assert "### Scenarios" in report.render(events)


def test_index_generator_is_a_function_of_seed_and_index():
    """Fixed 64-bit values (a change would move every resumed stream), no
    two indices alike, and the draws repeat for the same (seed, index)."""
    assert index_seed(0, 0) == 12035550249420947055
    assert index_seed(0, -1) == 3303439293501059696
    seeds = {index_seed(s, i) for s in range(4) for i in range(-1, 50)}
    assert len(seeds) == 4 * 51
    a = torch.rand(3, generator=index_generator(7, 11, "cpu"))
    b = torch.rand(3, generator=index_generator(7, 11, "cpu"))
    c = torch.rand(3, generator=index_generator(7, 12, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
