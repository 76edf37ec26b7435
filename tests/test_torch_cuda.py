"""K1 on the card against its plain version, on the same inputs: bitwise for
agg given the kernel's own noise, rtol 1e-6 for sgd and adam.  Needs a CUDA
device and skips without one.  This file imports no JAX, so it also runs on a
GPU machine without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX.)
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ota_fused, ref


def _inputs(seed, n_agents=7, n_params=1000):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n_agents, n_params)).astype(np.float32)
    h = (np.abs(rng.standard_normal(n_agents)) + 0.1).astype(np.float32)
    p = rng.standard_normal(n_params).astype(np.float32)
    mu = (rng.standard_normal(n_params) * 0.1).astype(np.float32)
    nu = (np.abs(rng.standard_normal(n_params)) * 0.01).astype(np.float32)
    return g, h, p, mu, nu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU runs the plain version")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["agg", "sgd", "adam"])
@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, mode, wire):
    dev = cuda
    g, h, p, mu, nu = (torch.from_numpy(x).to(dev) for x in _inputs(3))
    noise = ota_fused.fused_aggregate(torch.zeros(1, g.shape[1], device=dev),
                                      torch.ones(1, device=dev), sigma=1.0,
                                      scale=1.0, seed=5)
    kw = dict(sigma=0.5, scale=0.2, seed=5, wire_dtype=wire)
    if wire is not None:  # the plain version sees the wire values
        g = g.to(wire)
    if mode == "agg":
        got = [ota_fused.fused_aggregate(g, h, **kw)]
        want = [ref.ota_fused_ref(g, h, noise, sigma=0.5, scale=0.2)]
    elif mode == "sgd":
        got = [ota_fused.fused_aggregate_sgd(g, h, p, alpha=0.05, **kw)]
        want = [ref.ota_fused_sgd_ref(g, h, p, noise, alpha=0.05, sigma=0.5,
                                      scale=0.2)]
    else:
        got = ota_fused.fused_aggregate_adam(g, h, p, mu, nu, alpha=1e-3,
                                             step=3, **kw)
        want = ref.ota_fused_adam_ref(g, h, p, mu, nu, noise, alpha=1e-3,
                                      step=3, sigma=0.5, scale=0.2)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if mode == "agg":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_launch_count_and_validation(cuda):
    g = torch.ones(3, 200, device=cuda)
    h = torch.ones(3, device=cuda)
    before = ota_fused.LAUNCHES
    ota_fused.fused_aggregate(g, h, sigma=0.1, seed=1)
    torch.cuda.synchronize()
    assert ota_fused.LAUNCHES == before + 1
    with pytest.raises(ValueError):
        ota_fused.fused_aggregate(g, h.double())
    with pytest.raises(ValueError):
        ota_fused.fused_aggregate(g.t(), torch.ones(200, device=cuda))
    with pytest.raises(ValueError):
        ota_fused.fused_aggregate(g, h, threads=100)
    assert ota_fused.LAUNCHES == before + 1
