"""Telemetry of the PyTorch port (``repro_torch.telemetry``) against the JAX
package, and its own contracts.

Against JAX:

* the round probes on the same gradients and gains —
  ``stacked_round_probes`` (exact and over-the-air), ``streamed_round_probes``
  and ``participation_probes``: rtol 1e-6, atol 1e-6 (the port sums in the
  fixed order of ``fixed_sum``, JAX in XLA's);
* K=4 chained rounds with telemetry on, at the golden suite's SMALL size
  (N=3, M=2, T=6), the port fed each round's JAX draws (initial states,
  actions, gains, kernel seed) through ``RoundDraws``: history, theta and
  every probe within rtol 1e-5, atol 1e-6 (``test_torch_fedpg.py``'s chain
  tolerance); the moment drift within atol 1e-6;
* ``summarize`` on the same arrays (NaN-only probes None, inf kept, absent
  service probes skipped): exact;
* the tracer: the same span tree and the same Chrome trace-event layout.

Within the port: telemetry off is bitwise the run without it (live runs —
the JAX package's golden test of this does not reproduce under jax 0.9.0),
for the stacked, streamed and service rounds; a config with every probe off
is telemetry-off; the streamed round's norm probes are bitwise the stacked
round's; a lane of a batched run has its run's probes, bitwise.
"""
import functools
import json
import math

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
from repro.telemetry import probes as jax_probes
from repro.telemetry import trace as jax_trace
from repro_torch import interop
from repro_torch.core import fedpg, lanes
from repro_torch.core.channel import RayleighChannel
from repro_torch.core.ota import OTAConfig
from repro_torch.rl.env import LandmarkNav
from repro_torch.rl.policy import MLPPolicy
from repro_torch.service.participation import ParticipationConfig
from repro_torch.service.staleness import StalenessConfig
from repro_torch.telemetry import TelemetryConfig, probes, summarize, trace

CFG = fedpg.FedPGConfig(n_agents=3, batch_m=2, horizon=6, n_rounds=4,
                        alpha=0.05, gamma=0.99)
SIGMA = 1e-2
PROBE_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-6)


def _ota(sigma=SIGMA):
    return OTAConfig(RayleighChannel(), noise_sigma=sigma, debias=True)


def _jax_ota(sigma=SIGMA):
    return jax_ota.OTAConfig(JaxRayleigh(), noise_sigma=sigma, debias=True)


def _grads(seed=0, n=4):
    rng = np.random.default_rng(seed)
    g = {"w": rng.standard_normal((n, 3, 5)).astype(np.float32),
         "b": rng.standard_normal((n, 5)).astype(np.float32)}
    h = (np.abs(rng.standard_normal(n)) + 0.2).astype(np.float32)
    return g, h


def _close(got: probes.RoundTelemetry, want, **tol):
    for name, a, b in zip(probes.RoundTelemetry._fields, got, want):
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol,
                                   err_msg=name)


@pytest.mark.parametrize("uplink", ["exact", "noisy", "noiseless"])
def test_stacked_probes_match_jax(uplink):
    g, h = _grads()
    ota_t = {"exact": None, "noisy": _ota(), "noiseless": _ota(0.0)}[uplink]
    ota_j = {"exact": None, "noisy": _jax_ota(),
             "noiseless": _jax_ota(0.0)}[uplink]
    gains = np.ones(4, np.float32) if uplink == "exact" else h
    kw = dict(n_agents=4, gain_mean=float(gains.mean()), update_norm=2.5)
    want = jax_probes.stacked_round_probes(
        jax_probes.TelemetryConfig(), grads_stacked={
            k: jnp.asarray(v) for k, v in g.items()},
        gains=jnp.asarray(gains), ota_cfg=ota_j, **{
            **kw, "gain_mean": jnp.float32(kw["gain_mean"]),
            "update_norm": jnp.float32(2.5)})
    got = probes.stacked_round_probes(
        TelemetryConfig(), grads_stacked={k: torch.from_numpy(v)
                                          for k, v in g.items()},
        gains=torch.from_numpy(gains), ota_cfg=ota_t, **{
            **kw, "gain_mean": torch.tensor(kw["gain_mean"]),
            "update_norm": torch.tensor(2.5)})
    _close(got, want, **PROBE_TOL)


def test_streamed_and_participation_probes_match_jax():
    g, h = _grads(1)
    v = {k: np.tensordot(h, x, axes=1).astype(np.float32)
         for k, x in g.items()}
    norms_sq = sum(np.sum(np.square(x).reshape(4, -1), 1) for x in g.values())
    want = jax_probes.streamed_round_probes(
        jax_probes.TelemetryConfig(dispersion=False),
        v={k: jnp.asarray(x) for k, x in v.items()},
        norms_sq=jnp.asarray(norms_sq), ota_cfg=_jax_ota(), n_agents=4,
        param_dim=20, gain_mean=jnp.float32(1.1), update_norm=jnp.float32(3))
    got = probes.streamed_round_probes(
        TelemetryConfig(dispersion=False),
        v={k: torch.from_numpy(x) for k, x in v.items()},
        norms_sq=torch.from_numpy(norms_sq.astype(np.float32)),
        ota_cfg=_ota(), n_agents=4, param_dim=20,
        gain_mean=torch.tensor(1.1), update_norm=torch.tensor(3.0))
    _close(got, want, **PROBE_TOL)
    for cfg_t, cfg_j in ((TelemetryConfig(), jax_probes.TelemetryConfig()),
                         (TelemetryConfig(participation=False),
                          jax_probes.TelemetryConfig(participation=False))):
        pj = jax_probes.participation_probes(
            cfg_j, want, rate_realized=jnp.float32(2 / 3),
            rate_expected=0.55, staleness_mean=jnp.float32(1.5))
        pt = probes.participation_probes(
            cfg_t, got, rate_realized=torch.tensor(2 / 3),
            rate_expected=0.55, staleness_mean=torch.tensor(1.5))
        _close(pt, pj, **PROBE_TOL)


@functools.partial(jax.jit, static_argnames="noisy")
def _jax_round(theta, key, noisy):
    round_fn = jax_fedpg.make_round_fn(
        JaxLandmarkNav(), JaxMLPPolicy(), _jax_cfg(),
        _jax_ota() if noisy else None, ota_backend="pallas",
        telemetry=jax_probes.TelemetryConfig())
    theta_next, metrics = round_fn(theta, key)
    key_samp, key_chan = jax.random.split(key)
    agent_keys = jax.random.split(key_samp, CFG.n_agents)
    trajs = jax.vmap(lambda k: jax_sampler.rollout_batch(
        JaxLandmarkNav(), JaxMLPPolicy(), theta, k, CFG.horizon,
        CFG.batch_m))(agent_keys)
    key_h, key_n = jax.random.split(key_chan)
    h = jax_ota.sample_gains(_jax_ota(), key_h, CFG.n_agents)
    seed = jax.random.bits(key_n, (), jnp.uint32)
    return theta_next, metrics, trajs, h, seed


def _jax_cfg():
    return jax_fedpg.FedPGConfig(**CFG.__dict__)


@pytest.mark.parametrize("algorithm", [1, 2])
def test_chained_rounds_with_telemetry_match_jax(algorithm):
    noisy = algorithm == 2
    theta_j = JaxMLPPolicy().init(jax.random.key(0))
    theta_t = interop.from_numpy({k: np.asarray(v)
                                  for k, v in theta_j.items()}, "cpu")
    round_fn = fedpg.make_round_fn(LandmarkNav(), MLPPolicy(), CFG,
                                   _ota() if noisy else None,
                                   telemetry=TelemetryConfig())
    keys = jax.random.split(jax.random.key(2), CFG.n_rounds)
    for k in range(CFG.n_rounds):
        theta_j, m_j, trajs, h, seed = _jax_round(theta_j, keys[k], noisy)
        draws = fedpg.RoundDraws(
            s0=torch.from_numpy(np.array(trajs.obs[:, :, 0])),
            actions=torch.from_numpy(np.array(trajs.actions, np.int64)),
            gains=torch.from_numpy(np.array(h)) if noisy else None,
            seed=int(seed) if noisy else None)
        theta_t, m_t = round_fn(theta_t, None, draws)
        np.testing.assert_allclose([x.item() for x in m_t[:3]],
                                   [float(x) for x in m_j[:3]], **TOL)
        _close(m_t[3], m_j[3], **TOL)
    for name in theta_j:
        np.testing.assert_allclose(theta_t[name].numpy(),
                                   np.asarray(theta_j[name]), **TOL)


def _run(telemetry=None, **kw):
    return fedpg.run(LandmarkNav(), MLPPolicy(), CFG, 3, telemetry=telemetry,
                     device="cpu", **kw)


SERVICE = dict(participation=ParticipationConfig(rate=0.5),
               staleness=StalenessConfig(2, 0.5))


@pytest.mark.parametrize("form", ["stacked", "streamed", "exact", "service",
                                  "service_streamed", "service_exact"])
def test_telemetry_off_is_bitwise_the_run_without_it(form):
    kw = {"stacked": dict(ota=_ota()),
          "streamed": dict(ota=_ota(), agent_blocks=2),
          "exact": dict(),
          "service": dict(ota=_ota(), **SERVICE),
          "service_streamed": dict(ota=_ota(), agent_blocks=2, **SERVICE),
          "service_exact": dict(**SERVICE)}[form]
    theta0, plain = _run(**kw)
    theta1, tele = _run(TelemetryConfig(), **kw)
    off = _run(TelemetryConfig(snr=False, grad_norms=False,
                               moment_drift=False, dispersion=False,
                               participation=False), **kw)[1]
    for x, y, z in zip(plain, tele, off):
        assert torch.equal(x, y) and torch.equal(x, z)
    for k in theta0:
        assert torch.equal(theta0[k], theta1[k])
    assert plain.telemetry is None and off.telemetry is None
    t = tele.telemetry
    assert t.snr.shape == (CFG.n_rounds,)
    assert (t.participation_rate is None) == ("service" not in form)
    assert (t.staleness_mean is None) == ("service" not in form)
    finite = [t.grad_norm_pre, t.grad_norm_post, t.moment_drift]
    assert all(torch.isfinite(x).all() for x in finite)


def test_streamed_norm_probes_are_the_stacked_ones():
    stacked = _run(TelemetryConfig(), ota=_ota())[1].telemetry
    for blocks in (1, 2):
        streamed = _run(TelemetryConfig(), ota=_ota(),
                        agent_blocks=blocks)[1].telemetry
        assert torch.equal(stacked.grad_norm_pre, streamed.grad_norm_pre)
        assert torch.equal(stacked.dispersion, streamed.dispersion)
        torch.testing.assert_close(stacked.snr, streamed.snr, rtol=1e-5,
                                   atol=0)


def test_lane_probes_are_bitwise_the_runs():
    """Two lanes of a service partition with staleness and varying rates:
    each lane's probes are its run's (NaN where the run has NaN)."""
    from repro_torch.service import participation, staleness
    specs = []
    for seed, rate in ((1, 0.5), (2, 0.8)):
        p = participation.normalize(ParticipationConfig(rate=rate), 3)
        specs.append(lanes.LaneSpec(seed, CFG.alpha, _ota(), participation=p,
                                    staleness=staleness.normalize(
                                        StalenessConfig(2, 0.5), p)))
    _, hist = lanes.run_lanes(LandmarkNav(), MLPPolicy(), CFG, specs,
                              telemetry=TelemetryConfig(), device="cpu")
    for i, s in enumerate(specs):
        one = fedpg.run(LandmarkNav(), MLPPolicy(), CFG, s.seed, ota=s.ota,
                        participation=s.participation,
                        staleness=s.staleness, telemetry=TelemetryConfig(),
                        device="cpu")[1].telemetry
        for name, a, b in zip(probes.RoundTelemetry._fields, one,
                              hist.telemetry):
            assert torch.equal(torch.nan_to_num(a, 7.0),
                               torch.nan_to_num(b[i], 7.0)), name


def test_summarize_matches_jax():
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal((2, 5)).astype(np.float32) for _ in range(5)]
    arrs[0][0, 0] = np.inf
    arrs[3][:] = np.nan
    arrs[4][1, 2] = np.nan
    snr_inf = np.full((2, 5), np.inf, np.float32)
    for fields in (arrs + [None, None, None],
                   [snr_inf] + arrs[1:] + [arrs[1], arrs[2], None]):
        want = jax_probes.summarize(jax_probes.RoundTelemetry(*fields))
        got = summarize(probes.RoundTelemetry(*(
            None if a is None else torch.from_numpy(a) for a in fields)))
        assert got == want
    assert summarize(None) is None


def _spans(mod, tracer):
    with tracer.span("sweep", n=2):
        with tracer.span("partition", mode="vmap", scenarios=3):
            pass
        with tracer.span("partition", mode="vmap", scenarios=1,
                         ratio=float("inf")):
            with tracer.span("materialize"):
                pass
    return tracer.to_chrome_trace()


def test_tracer_tree_and_chrome_trace_match_jax(tmp_path):
    doc_t = _spans(trace, trace.Tracer())
    doc_j = _spans(jax_trace, jax_trace.Tracer())
    assert doc_t.keys() == doc_j.keys()
    assert doc_t["displayTimeUnit"] == doc_j["displayTimeUnit"]
    assert len(doc_t["traceEvents"]) == len(doc_j["traceEvents"])
    for a, b in zip(doc_t["traceEvents"], doc_j["traceEvents"]):
        assert a.keys() == b.keys()
        for k in ("name", "ph", "tid"):
            assert type(a[k]) is type(b[k])
        assert a["name"] == b["name"] and a["ph"] == b["ph"]
        if a["ph"] == "X":
            assert a["args"] == b["args"]
            assert a["dur"] >= 0 and a["ts"] >= 0
    trace.reset()
    with trace.span("outer", device="cpu") as sp:
        with trace.span("inner"):
            pass
    roots = trace.spans()
    assert [s.name for s in roots] == ["outer"]
    assert [c.name for c in roots[0].children] == ["inner"]
    assert "device" not in sp.attrs and sp.duration_us >= 0
    path = tmp_path / "trace.json"
    doc = trace.export(str(path))
    assert json.loads(path.read_text()) == doc
    t = trace.timed_call(lambda x: x + 1, torch.ones(3), iters=3,
                         block=trace.sync_device, name="add")
    assert t.run_us >= 0 and t.compile_us is not None
    assert [s.name for s in trace.spans()][-2:] == ["compile:add", "run:add"]


def test_torch_profile_sees_host_ops(tmp_path):
    with trace.torch_profile(str(tmp_path / "prof.json")) as prof:
        torch.ones(8) + 1
    assert any("add" in e.key for e in prof.key_averages())
    assert (tmp_path / "prof.json").exists()
    assert math.isinf(probes.RoundTelemetry(*[torch.tensor(math.inf)] * 5)
                      .snr.item())
