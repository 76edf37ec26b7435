"""The port's kernels on the card against their plain versions, on the same
numpy-made inputs.  K3 and K4 each have two kernels: bf16 inputs of the
shapes and strides the tensor-core kernels take go there (and are also
held to those kernels' plain models, ``ref.flash_attention_tc`` and
``ref.ssd_tc``), the rest to the f32-core kernels; the launch counters
show which ran.  K1: bitwise for agg given the kernel's own noise, rtol
1e-6 for sgd and adam.  K3 (flash attention): atol = rtol = 3e-6 in f32 and
2e-2 in bf16 (the JAX sweep's tolerances, ``tests/test_kernels.py:43``), and
in bf16 also one bf16 ulp of the value (rtol 2**-7, atol 1e-5): both sides
compute in f32 from the same inputs, so only the output's rounding may part.
K4 (SSD scan): 5e-5 (``tests/test_kernels.py:84``) for f32 and bf16 inputs
alike, as its output is f32 either way; 1e-4 against the sequential
recurrence.  K2 (server-side update): bitwise, for f32 and bf16, and
bitwise K1's unit-gain server pass.  The streamed fold through K1 and the
streamed round: bitwise the per-agent fold and across block sizes (also
through K1's tall body at N = 10^4 in one block).  K1's tall body: bitwise
its plain version (agg) and the wide body (every mode), f32 and bf16; its
lanes bitwise one-lane launches; what it cannot take raises.  K1's device
rescale factor (the round service's N / W): bitwise its plain version (sgd
rtol 1e-6); the service's mask stream: the same bits on the card as on the
CPU; the streamed service round bitwise across block sizes.  The
lane-batched run (``core/lanes.py``) and ``sweep(mode="vmap")``: every
lane bitwise ``fedpg.run`` of its settings and seed on the card (plain,
varying channel / noise / step size, power control, env parameters, the
round service with staleness, the exact uplink, telemetry), one K1 launch
per batched round.  Needs a CUDA device and skips without one.  This file imports no JAX, so it also runs on a
GPU machine without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX.)
"""
import os

import numpy as np
import pytest

# deterministic cuBLAS for the training resume below; set before CUDA
# initialises
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

from repro_torch.kernels import (
    flash_attention, ota_channel, ota_fused, ref, ssd_scan,
)


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


# ---------------------------------------------------------------------------
# K3: flash attention
# ---------------------------------------------------------------------------

K3_CASES = [  # (b, h, hkv, sq, sk, dh, causal, window)
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 256, 256, 64, True, None),       # GQA g=2
    (1, 6, 2, 200, 200, 112, True, None),      # g=3, zamba2's head dim, ragged
    (1, 8, 2, 256, 256, 128, True, None),      # g=4
    (1, 2, 1, 1000, 1000, 64, True, 128),      # sliding window, ragged
    (2, 2, 2, 384, 384, 64, False, None),      # bidirectional
    (2, 4, 4, 48, 48, 128, True, None),        # a short prompt
    (1, 3, 1, 128, 256, 112, True, None),      # Sq != Sk
    (1, 24, 8, 2048, 2048, 128, True, None),   # llama3.2-3b's prefill heads
]


def _qkv(seed, b, h, hkv, sq, sk, dh, dtype, dev):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, dh)).astype(np.float32)
    return (torch.from_numpy(x).to(dev, dtype) for x in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K3_CASES, ids=str)
def test_flash_attention_matches_plain_version(cuda, case, dtype):
    b, h, hkv, sq, sk, dh, causal, window = case
    q, k, v = _qkv(sq + dh, b, h, hkv, sq, sk, dh, dtype, cuda)
    got = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    want = ref.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 3e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                                   rtol=2 ** -7)
    if dtype == torch.float32 and sq == sk and sq <= 1000:
        oracle = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, oracle, atol=tol, rtol=tol)
    # the model's (B, S, H, Dh) layout, read through strides
    pos_q = torch.arange(sq, device=cuda)
    pos_k = torch.arange(sk, device=cuda)
    got_bshd = flash_attention.attend_bshd(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), q_pos=pos_q, k_pos=pos_k,
        causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got_bshd.transpose(1, 2), got)


@pytest.mark.cuda
@pytest.mark.parametrize("shift,stride,window", [(100, 1, None), (0, 2, 1)])
def test_flash_attention_rows_that_see_no_key(cuda, shift, stride, window):
    """Positions where some queries see no key (keys after the first 100
    queries; keys on even positions with a window of 1, so odd queries are
    blind): such a row is the mean of V, as in the plain version, also
    where the kernel skips every key tile of the block."""
    q, k, v = (x.transpose(1, 2).contiguous() for x in
               _qkv(7, 2, 4, 2, 200, 200, 64, torch.float32, cuda))
    q_pos = torch.arange(200, device=cuda)
    k_pos = torch.arange(200, device=cuda) * stride + shift
    got = flash_attention.attend_bshd(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                      window=window)
    want = ref.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        window=window, q_pos=q_pos, k_pos=k_pos).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=3e-6, rtol=3e-6)
    blind = ~ref.visible(q_pos, k_pos, True, window).any(dim=1)
    assert blind.any()
    mean = v.float().mean(dim=1).repeat_interleave(2, dim=1)
    torch.testing.assert_close(got[:, blind], mean[:, None].expand_as(
        got[:, blind]), atol=3e-6, rtol=3e-6)


@pytest.mark.cuda
def test_flash_attention_launch_count_and_validation(cuda):
    q, k, v = _qkv(0, 1, 4, 2, 64, 64, 64, torch.float32, cuda)
    before = flash_attention.LAUNCHES
    flash_attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, k[:, :1].repeat(1, 3, 1, 1),
                                        v[:, :1].repeat(1, 3, 1, 1))
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, k, v, window=0)
    assert flash_attention.LAUNCHES == before + 1


K3_TC_EDGES = [  # (b, h, hkv, sq, sk, dh, window): the tensor-core kernel's tiles
    (1, 3, 1, 130, 300, 128, None),   # Sq != Sk, neither a multiple of 128
    (1, 4, 2, 300, 170, 80, None),    # Dh 80: a TMA box with zero columns
    (1, 2, 2, 200, 200, 112, 64),     # Dh 112 with a window
    (2, 4, 4, 48, 48, 128, None),     # one short query and key tile
    (1, 2, 2, 129, 129, 16, None),    # Dh 16; one row and key past a tile
]


def _within_one_ulp(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                               rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_TC_EDGES, ids=str)
def test_flash_attention_tensor_cores_edges(cuda, case):
    """bf16 shapes that leave the tensor-core kernel's 128-row tiles ragged
    or its 64-column boxes part empty: one launch of that kernel, within
    one bf16 ulp of the plain version and of its plain model."""
    b, h, hkv, sq, sk, dh, window = case
    q, k, v = _qkv(sq + sk + dh, b, h, hkv, sq, sk, dh, torch.bfloat16, cuda)
    before = (flash_attention.LAUNCHES, flash_attention.LAUNCHES_TC)
    got = flash_attention.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert (flash_attention.LAUNCHES, flash_attention.LAUNCHES_TC) == (
        before[0], before[1] + 1)
    _within_one_ulp(got, ref.flash_attention_plain(q, k, v, window=window))
    _within_one_ulp(got, ref.flash_attention_tc(q, k, v, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("shift,stride,window", [(100, 1, None), (0, 2, 1)])
def test_flash_attention_tensor_cores_rows_that_see_no_key(cuda, shift, stride,
                                                           window):
    """The tensor-core kernel gives a query that sees no key the mean of V,
    also where it skips every key tile of the block."""
    q, k, v = (x.transpose(1, 2).contiguous() for x in
               _qkv(7, 2, 4, 2, 200, 200, 64, torch.bfloat16, cuda))
    q_pos = torch.arange(200, device=cuda)
    k_pos = torch.arange(200, device=cuda) * stride + shift
    before = flash_attention.LAUNCHES_TC
    got = flash_attention.attend_bshd(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                      window=window)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES_TC == before + 1
    want = ref.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        window=window, q_pos=q_pos, k_pos=k_pos).transpose(1, 2)
    _within_one_ulp(got, want)
    blind = ~ref.visible(q_pos, k_pos, True, window).any(dim=1)
    assert blind.any()


@pytest.mark.cuda
def test_flash_attention_dispatch_counts(cuda):
    """bf16 with Dh a multiple of 16 and aligned strides takes the
    tensor-core kernel; f32, Dh 72 and a sequence stride of 68 take the
    f32-core kernel; each within its contract."""
    def run(dtype, dh, pad=0):
        rng = np.random.default_rng(dh + pad)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, 2, 160, dh + pad)).astype(np.float32)).to(cuda, dtype)[..., :dh]
            for _ in range(3))
        before = (flash_attention.LAUNCHES, flash_attention.LAUNCHES_TC)
        got = flash_attention.flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = ref.flash_attention_plain(q, k, v)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=3e-6, rtol=3e-6)
        else:
            _within_one_ulp(got, want)
        return (flash_attention.LAUNCHES - before[0],
                flash_attention.LAUNCHES_TC - before[1])
    assert run(torch.bfloat16, 128) == (0, 1)
    assert run(torch.bfloat16, 64) == (0, 1)
    assert run(torch.float32, 128) == (1, 0)
    assert run(torch.bfloat16, 72) == (1, 0)
    assert run(torch.bfloat16, 64, pad=4) == (1, 0)


# ---------------------------------------------------------------------------
# K4: SSD scan
# ---------------------------------------------------------------------------

K4_CASES = [  # (b, s, h, p, g, n, chunk)
    (1, 128, 2, 64, 1, 64, 64),
    (2, 256, 4, 64, 1, 128, 128),      # mamba2-130m-like
    (1, 256, 4, 32, 2, 16, 64),        # grouped B/C
    (2, 128, 8, 64, 2, 64, 32),
    (1, 200, 2, 32, 1, 16, 64),        # ragged: zero-padded tail chunk
    (2, 48, 4, 32, 1, 16, 128),        # S < chunk: chunk = S
    (4, 2048, 24, 64, 1, 128, 128),    # mamba2-130m's prefill
]


def _ssd_inputs(seed, b, s, h, p, g, n, dtype, dev):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1).astype(
        np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, h)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    to = lambda a, dt_=dtype: torch.from_numpy(a).to(dev, dt_)
    return to(x), to(dt), to(A, torch.float32), to(B), to(C)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K4_CASES, ids=str)
def test_ssd_scan_matches_plain_version(cuda, case, dtype):
    b, s, h, p, g, n, chunk = case
    x, dt, A, B, C = _ssd_inputs(s + h * p, b, s, h, p, g, n, dtype, cuda)
    got = ssd_scan.ssd_scan(x, dt, A, B, C, chunk=chunk)
    want = ref.ssd_ref(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)


@pytest.mark.cuda
def test_ssd_scan_matches_sequential_recurrence(cuda):
    x, dt, A, B, C = _ssd_inputs(11, 1, 256, 2, 32, 1, 32, torch.float32, cuda)
    got = ssd_scan.ssd_scan(x, dt, A, B, C, chunk=64)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.ssd_sequential_ref(x, dt, A, B, C),
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_ssd_scan_launch_count_and_validation(cuda):
    x, dt, A, B, C = _ssd_inputs(1, 1, 64, 2, 32, 1, 16, torch.float32, cuda)
    before = ssd_scan.LAUNCHES
    ssd_scan.ssd_scan(x, dt, A, B, C, chunk=32)
    torch.cuda.synchronize()
    assert ssd_scan.LAUNCHES == before + 1
    with pytest.raises(ValueError):
        ssd_scan.ssd_scan(x, dt, A, B.bfloat16(), C, chunk=32)
    with pytest.raises(ValueError):   # a chunk above the kernel's 128
        ssd_scan.ssd_scan(*_ssd_inputs(2, 1, 256, 2, 32, 1, 16,
                                       torch.float32, cuda), chunk=256)
    with pytest.raises(ValueError):
        ssd_scan.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2),
                          dt, A, B, C, chunk=32)
    assert ssd_scan.LAUNCHES == before + 1


K4_TC_EDGES = [  # (b, s, h, p, g, n, chunk): P, S off the slice and chunk
    (1, 200, 2, 40, 1, 16, 64),
    (1, 300, 3, 24, 1, 32, 40),     # a chunk that is not a multiple of 16
    (1, 130, 2, 8, 1, 8, 128),      # one slice narrower than 16
    (2, 48, 4, 32, 1, 16, 128),     # S < chunk
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_TC_EDGES, ids=str)
def test_ssd_scan_tensor_cores_edges(cuda, case):
    b, s, h, p, g, n, chunk = case
    x, dt, A, B, C = _ssd_inputs(s + h * p, b, s, h, p, g, n, torch.bfloat16,
                                 cuda)
    before = (ssd_scan.LAUNCHES, ssd_scan.LAUNCHES_TC)
    got = ssd_scan.ssd_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert (ssd_scan.LAUNCHES, ssd_scan.LAUNCHES_TC) == (before[0],
                                                        before[1] + 1)
    torch.testing.assert_close(got, ref.ssd_ref(x, dt, A, B, C, chunk),
                               atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(got, ref.ssd_tc(x, dt, A, B, C, chunk),
                               atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(got, ref.ssd_sequential_ref(x, dt, A, B, C),
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_ssd_scan_dispatch_counts(cuda):
    """bf16 with P and N multiples of 8 takes the tensor-core kernel; f32
    and P = 36 take the f32-core kernel."""
    def run(dtype, p):
        x, dt, A, B, C = _ssd_inputs(p, 1, 128, 2, p, 1, 16, dtype, cuda)
        before = (ssd_scan.LAUNCHES, ssd_scan.LAUNCHES_TC)
        got = ssd_scan.ssd_scan(x, dt, A, B, C, chunk=64)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.ssd_ref(x, dt, A, B, C, 64),
                                   atol=5e-5, rtol=5e-5)
        return (ssd_scan.LAUNCHES - before[0],
                ssd_scan.LAUNCHES_TC - before[1])
    assert run(torch.bfloat16, 32) == (0, 1)
    assert run(torch.float32, 32) == (1, 0)
    assert run(torch.bfloat16, 36) == (1, 0)


@pytest.mark.cuda
def test_model_init_takes_a_generator_of_its_device(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as model_lib

    m = model_lib.build(get_smoke_config("mamba2-130m"))
    with pytest.raises(ValueError, match="generator"):
        m.init(torch.Generator().manual_seed(0))
    params = m.init(torch.Generator(device=cuda).manual_seed(0))
    assert params["layers"]["w_x"].is_cuda


# ---------------------------------------------------------------------------
# K2 and the agent-streamed round
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7,), (37, 65), (3, 5, 129), (1000, 33)])
def test_k2_matches_plain_version(cuda, shape, dtype):
    """Bitwise: both sides round one float32 value per element, from the
    same counter bits and the same libdevice log/cos."""
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(shape)
                         .astype(np.float32)).to(cuda).to(dtype)
    for sigma in (0.0, 0.5):
        for debias in (True, False):
            kw = dict(sigma=sigma, n_agents=7, m_h=1.2533, debias=debias,
                      seed=11)
            got = ota_channel.ota_channel_apply(v, **kw)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == v.shape
            assert torch.equal(got, ref.ota_channel_plain(v, **kw))


@pytest.mark.cuda
def test_k2_is_k1_server_pass_and_unaligned_input(cuda):
    v = torch.randn(10_001, device=cuda)
    k2 = ota_channel.ota_channel_apply(v, sigma=0.5, n_agents=7, m_h=1.3,
                                       seed=5)
    k1 = ota_fused.fused_server_pass(v, sigma=0.5, scale=1.0 / (7 * 1.3),
                                     seed=5)
    assert torch.equal(k2, k1)
    odd = v[1:]                      # 4-byte aligned only: the scalar path
    assert torch.equal(
        ota_channel.ota_channel_apply(odd, sigma=0.5, n_agents=3, seed=2),
        ref.ota_channel_plain(odd, sigma=0.5, n_agents=3, seed=2))


@pytest.mark.cuda
def test_ota_update_launches_k2_once(cuda):
    from repro_torch.kernels import ops

    v = torch.randn(64, 128, device=cuda)
    before = ota_channel.LAUNCHES
    ops.ota_update(v, sigma=1e-3, n_agents=10, m_h=1.25, seed=3)
    torch.cuda.synchronize()
    assert ota_channel.LAUNCHES == before + 1
    with pytest.raises(ValueError):
        ota_channel.ota_channel_apply(v.half(), sigma=0.1, n_agents=1)
    assert ota_channel.LAUNCHES == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_kernel_fold_is_the_per_agent_fold_on_the_card(cuda, wire):
    from repro_torch.core import ota

    rng = np.random.default_rng(6)
    g = {"a": torch.from_numpy(rng.standard_normal((9, 4, 5))
                               .astype(np.float32)).to(cuda),
         "b": torch.from_numpy(rng.standard_normal((9, 3))
                               .astype(np.float32)).to(cuda)}
    h = torch.rand(9, device=cuda) + 0.1
    acc = {k: v[0] * 2.0 for k, v in g.items()}
    valid = torch.arange(9, device=cuda) < 7
    before = ota_fused.LAUNCHES
    a = ota.stream_fold_block(acc, g, h, valid, wire_dtype=wire,
                              backend="cuda")
    assert ota_fused.LAUNCHES == before + 1
    b = ota.stream_fold_block(acc, g, h, valid, wire_dtype=wire,
                              backend="torch")
    torch.cuda.synchronize()
    for k in g:
        assert torch.equal(a[k], b[k])


@pytest.mark.cuda
def test_streamed_round_is_bitwise_invariant_on_the_card(cuda):
    from repro_torch.core import fedpg
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.ota import OTAConfig
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    cfg = fedpg.FedPGConfig(n_agents=7, batch_m=4, horizon=9, n_rounds=3,
                            alpha=1e-2)
    ota_cfg = OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True)
    runs = [fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 3, ota=ota_cfg,
                      agent_blocks=b, device=cuda) for b in (None, 1, 2, 4)]
    torch.cuda.synchronize()
    _, stacked = runs[0]
    _, first = runs[1]
    for theta, hist in runs[2:]:
        assert all(torch.equal(x, y) for x, y in zip(first, hist))
        assert all(torch.equal(runs[1][0][k], theta[k]) for k in theta)
    assert torch.equal(first.gain_mean, stacked.gain_mean)
    torch.testing.assert_close(first.grad_sq, stacked.grad_sq, rtol=1e-5,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["agg", "sgd", "server_pass"])
@pytest.mark.parametrize("w", [3.0, 2.5, 0.0])
def test_k1_device_rescale_matches_plain_version(cuda, mode, w):
    """The round service's N / W reaches K1 as a device factor: given the
    kernel's own noise, agg and the server pass are bitwise their plain
    version, sgd within rtol 1e-6 (K1's sgd contract); W = 0 gives a zero
    update whatever the noise."""
    from repro_torch.core import ota

    g, h, p, _, _ = (torch.from_numpy(x).to(cuda) for x in _inputs(9))
    r = ota._participation_rescale(7, torch.tensor(w, device=cuda)).reshape(1)
    noise = ota_fused.fused_aggregate(
        torch.zeros(1, g.shape[1], device=cuda), torch.ones(1, device=cuda),
        sigma=1.0, scale=1.0, seed=5)
    kw = dict(sigma=0.5, scale=0.2, seed=5)
    one = torch.ones(1, device=cuda)
    before = ota_fused.LAUNCHES
    if mode == "agg":
        got = ota_fused.fused_aggregate(g, h, rescale=r, **kw)
        want = ref.ota_fused_ref(g, h, noise, sigma=0.5, scale=0.2,
                                 rescale=r)
    elif mode == "sgd":
        got = ota_fused.fused_aggregate_sgd(g, h, p, alpha=0.05, rescale=r,
                                            **kw)
        want = ref.ota_fused_sgd_ref(g, h, p, noise, alpha=0.05, sigma=0.5,
                                     scale=0.2, rescale=r)
    else:
        got = ota_fused.fused_server_pass(g[0], rescale=r, **kw)
        want = ref.ota_fused_ref(g[:1], one, noise, sigma=0.5, scale=0.2,
                                 rescale=r)
    torch.cuda.synchronize()
    assert ota_fused.LAUNCHES == before + 1
    if mode == "sgd":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    else:
        assert torch.equal(got, want)
        if w == 0.0:
            assert not bool(torch.any(got != 0))
    with pytest.raises(ValueError, match="rescale"):
        ota_fused.fused_aggregate(g, h, rescale=r.cpu(), **kw)


@pytest.mark.cuda
def test_mask_stream_bits_on_the_card_equal_the_cpu(cuda):
    from repro_torch.service import faults, participation, stream

    ids = torch.arange(100_000)
    for salt in (stream.SALT_BERNOULLI, stream.SALT_DELAY, stream.SALT_CRASH,
                 stream.SALT_PHASE):
        for seed in (0, 12345, torch.tensor(2 ** 32 - 1)):
            cpu = stream.agent_bits(seed, 17, ids, salt)
            dev_seed = seed.to(cuda) if isinstance(seed, torch.Tensor) else seed
            card = stream.agent_bits(dev_seed, 17, ids.to(cuda), salt)
            assert torch.equal(cpu, card.cpu())
    p = participation.ParticipationConfig(rate=0.5, faults=faults.FaultConfig(
        stragglers=faults.StragglerModel("pareto", 1.0, 2.5), deadline=1.0,
        crashes=faults.CrashSchedule(0.3, 5, 2)))
    for r in range(5):
        cpu = participation.round_mask(p, torch.tensor(9), r, ids, 100_000)
        card = participation.round_mask(p, torch.tensor(9, device=cuda), r,
                                        ids.to(cuda), 100_000)
        assert torch.equal(cpu, card.cpu())


@pytest.mark.cuda
def test_streamed_service_round_is_bitwise_invariant_on_the_card(cuda):
    from repro_torch.core import fedpg
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.ota import OTAConfig
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.service import ParticipationConfig, StalenessConfig

    cfg = fedpg.FedPGConfig(n_agents=7, batch_m=4, horizon=9, n_rounds=4,
                            alpha=1e-2)
    ota_cfg = OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True)
    runs = [fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 3, ota=ota_cfg,
                      participation=ParticipationConfig(rate=0.5),
                      staleness=StalenessConfig(3, 0.8), agent_blocks=b,
                      device=cuda) for b in (None, 1, 2, 4)]
    torch.cuda.synchronize()
    _, stacked = runs[0]
    _, first = runs[1]
    for theta, hist in runs[2:]:
        assert all(torch.equal(x, y) for x, y in zip(first, hist))
        assert all(torch.equal(runs[1][0][k], theta[k]) for k in theta)
    assert torch.equal(first.gain_mean, stacked.gain_mean)


# ---------------------------------------------------------------------------
# K1's tall body (large fleets at a small d) and its lane axis
# ---------------------------------------------------------------------------

def _body(name):
    """Within the block every CUDA call of K1 takes body ``name``."""
    from unittest import mock

    return mock.patch.object(ota_fused, "k1_body", lambda *a, **k: name)


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [True, False])
@pytest.mark.parametrize("wire", [None, torch.bfloat16])
@pytest.mark.parametrize("n_params", [1, 3, 165, 1000])
@pytest.mark.parametrize("n_agents", [4, 63, 64, 65, 10_000])
def test_k1_tall_body_matches_plain_version(cuda, n_agents, n_params, wire,
                                            noise):
    """The tall body: agg bitwise its plain version (also with the device
    rescale factor), sgd and adam within rtol 1e-6, all three bitwise the
    wide body, and one tall launch per call."""
    g, h, p, mu, nu = (torch.from_numpy(x).to(cuda)
                       for x in _inputs(n_agents + n_params, n_agents,
                                        n_params))
    gw = g if wire is None else g.to(wire)
    nz = ref.counter_noise(5, n_params, cuda) if noise else None
    r = torch.tensor([0.75], device=cuda)
    kw = dict(sigma=0.5, scale=0.2, seed=5, with_noise=noise,
              wire_dtype=wire)
    pkw = dict(sigma=0.5, scale=0.2)
    akw = dict(alpha=1e-3, step=3)
    outs = {}
    for body in ("tall", "wide"):
        before = ota_fused.LAUNCHES_TALL
        with _body(body):
            outs[body] = [ota_fused.fused_aggregate(g, h, **kw),
                          ota_fused.fused_aggregate(g, h, rescale=r, **kw),
                          ota_fused.fused_aggregate_sgd(g, h, p, alpha=0.05,
                                                        **kw),
                          *ota_fused.fused_aggregate_adam(g, h, p, mu, nu,
                                                          **akw, **kw)]
        assert ota_fused.LAUNCHES_TALL - before == (4 if body == "tall"
                                                    else 0)
    torch.cuda.synchronize()
    tall = outs["tall"]
    assert torch.equal(tall[0], ref.ota_fused_ref(gw, h, nz, **pkw))
    assert torch.equal(tall[1], ref.ota_fused_ref(gw, h, nz, rescale=r,
                                                  **pkw))
    torch.testing.assert_close(tall[2], ref.ota_fused_sgd_ref(
        gw, h, p, nz, alpha=0.05, **pkw), rtol=1e-6, atol=1e-7)
    for x, y in zip(tall[3:], ref.ota_fused_adam_ref(gw, h, p, mu, nu, nz,
                                                     **akw, **pkw)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    assert all(torch.equal(x, y) for x, y in zip(tall, outs["wide"]))


@pytest.mark.cuda
def test_k1_tall_body_refuses_what_it_cannot_take(cuda):
    """A forced tall body refuses a view off the 16-byte grid and a P past
    its widest; the rule gives such a view to the wide body before launch
    (bitwise the plain version), and a fresh copy to the tall body."""
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (10_001, 165)).astype(np.float32)).to(cuda)
    h = torch.ones(10_000, device=cuda)
    view = g[1:]                                   # 660 bytes off the grid
    assert ota_fused.k1_body(10_000, 165) == "tall"
    before = ota_fused.LAUNCHES
    with _body("tall"), pytest.raises(ValueError, match="aligned"):
        ota_fused.fused_aggregate(view, h)
    with _body("tall"), pytest.raises(ValueError, match="takes P"):
        ota_fused.fused_aggregate(torch.ones(64, 2000, device=cuda),
                                  torch.ones(64, device=cuda))
    assert ota_fused.LAUNCHES == before
    wide, tall = ota_fused.LAUNCHES_WIDE, ota_fused.LAUNCHES_TALL
    got = ota_fused.fused_aggregate(view, h, sigma=0.5, seed=3)
    assert (ota_fused.LAUNCHES_WIDE - wide, ota_fused.LAUNCHES_TALL - tall) \
        == (1, 0)
    assert torch.equal(got, ref.ota_fused_ref(
        view, h, ref.counter_noise(3, 165, cuda), sigma=0.5, scale=1.0))
    fresh = ota_fused.fused_aggregate(view.clone(), h, sigma=0.5, seed=3)
    assert ota_fused.LAUNCHES_TALL - tall == 1
    assert torch.equal(fresh, got)
    # one lane of a (1, A, P) stack whose A * P * 4 bytes is off the grid:
    # the lane stride is never stepped, so the tall body takes it
    h1 = torch.ones(10_001, device=cuda)
    one = ota_fused.fused_aggregate_lanes(g[None], h1[None], sigma=0.5,
                                          seed=3)
    assert ota_fused.LAUNCHES_TALL - tall == 2
    assert torch.equal(one[0], ota_fused.fused_aggregate(g, h1, sigma=0.5,
                                                         seed=3))
    assert ota_fused.LAUNCHES == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["tall", "wide"])
@pytest.mark.parametrize("shape", [(3, 4, 800), (20, 10, 165),
                                   (4, 10_000, 165)], ids=str)
@pytest.mark.parametrize("shared", [True, False])
def test_k1_lanes_are_single_lane_launches_bitwise(cuda, body, shape,
                                                   shared):
    """Each lane of one launch is bitwise a one-lane launch of the same body
    (JAX's vmap-folds-lanes-into-the-grid contract), agg and sgd, with
    per-lane sigma, scale, alpha, seed and rescale on the card."""
    lanes, a, p = shape
    rng = np.random.default_rng(lanes * a)
    g = torch.from_numpy(rng.standard_normal(
        (a, p) if shared else (lanes, a, p)).astype(np.float32)).to(cuda)
    h = torch.from_numpy(rng.random((lanes, a)).astype(np.float32)).to(cuda)
    params = torch.from_numpy(rng.standard_normal((lanes, p))
                              .astype(np.float32)).to(cuda)
    sig, sc, al, r = (torch.from_numpy(rng.random(lanes).astype(np.float32))
                      .to(cuda) for _ in range(4))
    seeds = torch.arange(lanes, device=cuda, dtype=torch.int64) * 7 + 3
    with _body(body):
        if body == "tall" and not shared and (a * p * 4) % 16:
            # per-lane stacks off the 16-byte grid (the rule keeps them
            # wide): the tall body refuses them
            with pytest.raises(ValueError, match="aligned"):
                ota_fused.fused_aggregate_lanes(g, h, sigma=sig, seed=seeds)
            return
        before = ota_fused.LAUNCHES
        agg = ota_fused.fused_aggregate_lanes(g, h, sigma=sig, scale=sc,
                                              seed=seeds, rescale=r)
        sgd = ota_fused.fused_aggregate_sgd_lanes(g, h, params, alpha=al,
                                                  sigma=sig, scale=sc,
                                                  seed=seeds)
        assert ota_fused.LAUNCHES == before + 2
        for lane in range(lanes):
            gl = g if shared else g[lane].clone()
            one = dict(sigma=sig[lane].item(), scale=sc[lane].item(),
                       seed=int(seeds[lane]))
            assert torch.equal(agg[lane], ota_fused.fused_aggregate(
                gl, h[lane].clone(), rescale=r[lane:lane + 1].clone(),
                **one))
            assert torch.equal(sgd[lane], ota_fused.fused_aggregate_sgd(
                gl, h[lane].clone(), params[lane].clone(),
                alpha=al[lane].item(), **one))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_k1_stream_fold_of_ten_thousand_agents_in_one_block(cuda):
    """``stream_fold_block`` at N = 10^4 in one block: one tall launch over
    the [acc; G] stack, bitwise the torch fold (the streamed round's
    invariance to ``agent_blocks`` rests on it)."""
    from repro_torch.core import ota

    rng = np.random.default_rng(12)
    n = 10_000
    g = {"w": torch.from_numpy(rng.standard_normal((n, 16, 5))
                               .astype(np.float32)).to(cuda),
         "b": torch.from_numpy(rng.standard_normal((n, 85))
                               .astype(np.float32)).to(cuda)}
    h = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda) + 0.1
    acc = {k: v[0] * 0.5 for k, v in g.items()}
    valid = torch.arange(n, device=cuda) < n - 3
    before, tall = ota_fused.LAUNCHES, ota_fused.LAUNCHES_TALL
    a = ota.stream_fold_block(acc, g, h, valid, backend="cuda")
    assert (ota_fused.LAUNCHES - before, ota_fused.LAUNCHES_TALL - tall) \
        == (1, 1)
    b = ota.stream_fold_block(acc, g, h, valid, backend="torch")
    torch.cuda.synchronize()
    for k in g:
        assert torch.equal(a[k], b[k])


def _lane_cases():
    from repro_torch.core import lanes
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.ota import OTAConfig
    from repro_torch.core.power_control import TruncatedInversion
    from repro_torch.rl.envs import WindyLandmarkNav
    from repro_torch.service import participation, staleness
    from repro_torch.service.participation import ParticipationConfig
    from repro_torch.service.staleness import StalenessConfig

    def o(scale=1.0, sigma=1e-3, pc=None):
        return OTAConfig(RayleighChannel(scale), noise_sigma=sigma,
                         debias=True, power_control=pc)

    def svc(rate):
        p = participation.normalize(ParticipationConfig(rate=rate), 10)
        return dict(participation=p, staleness=staleness.normalize(
            StalenessConfig(4, 0.8), p))

    w = [WindyLandmarkNav(wind=x) for x in (0.05, 0.1)]
    return {
        "plain20": [lanes.LaneSpec(s, 1e-3, o()) for s in range(20)],
        "channel_noise_alpha": [lanes.LaneSpec(1, 1e-3, o(1.0, 1e-3)),
                                lanes.LaneSpec(2, 2e-3, o(2.0, 1e-2))],
        "power_control": [
            lanes.LaneSpec(s, 1e-3, o(pc=TruncatedInversion(p_max=p)))
            for s, p in ((1, 5.0), (2, 10.0))],
        "env": [lanes.LaneSpec(s, 1e-3, o(), env=e)
                for s, e in zip((1, 2), w)],
        "service_stale": [lanes.LaneSpec(s, 1e-3, o(), **svc(r))
                          for s, r in ((1, 0.5), (2, 0.8))],
        "exact": [lanes.LaneSpec(s, a) for s, a in ((1, 1e-3), (2, 2e-3))],
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain20", "channel_noise_alpha",
                                  "power_control", "env", "service_stale",
                                  "exact"])
@pytest.mark.parametrize("telemetry", [False, True])
def test_lanes_are_bitwise_their_runs_on_the_card(cuda, case, telemetry):
    from repro_torch.core import fedpg, lanes
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.envs import default_policy
    from repro_torch.telemetry import TelemetryConfig

    specs = _lane_cases()[case]
    env = specs[0].env or LandmarkNav()
    pol = default_policy(env)
    tel = TelemetryConfig() if telemetry else None
    cfg = fedpg.FedPGConfig(n_agents=10, batch_m=10, horizon=20, n_rounds=5)
    before = ota_fused.LAUNCHES
    theta, hist = lanes.run_lanes(LandmarkNav(), pol, cfg, specs,
                                  telemetry=tel)
    per_round = 0 if specs[0].ota is None else 1
    assert ota_fused.LAUNCHES - before == per_round * cfg.n_rounds
    for i, spec in enumerate(specs):
        c = fedpg.FedPGConfig(**{**cfg.__dict__, "alpha": spec.alpha})
        t1, h1 = fedpg.run(spec.env or LandmarkNav(), pol, c, spec.seed,
                           ota=spec.ota, participation=spec.participation,
                           staleness=spec.staleness, telemetry=tel)
        for x, y in zip(h1, hist):
            assert torch.equal(x, y[i]), (case, i)
        for k in t1:
            assert torch.equal(t1[k], theta[k][i]), (case, i, k)
        if telemetry:
            for x, y in zip(h1.telemetry, hist.telemetry):
                if x is not None:
                    assert torch.equal(torch.nan_to_num(x, 7.0),
                                       torch.nan_to_num(y[i], 7.0))


@pytest.mark.cuda
def test_sweep_vmap_is_bitwise_map_on_the_card(cuda):
    from repro_torch.core import sweep
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    sc = sweep.grid(channel=[RayleighChannel(1.0), RayleighChannel(2.0)],
                    noise_sigma=[1e-3, 1e-2], alpha=[1e-3, 2e-3],
                    n_agents=10, batch_m=10, horizon=20, n_rounds=5,
                    debias=True)
    before = ota_fused.LAUNCHES
    vmap = sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 3)
    assert vmap.n_partitions == 1 and ota_fused.LAUNCHES - before == 5
    mapped = sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 3, mode="map")
    for x, y in zip(vmap.history, mapped.history):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the round-service driver, the trainer's uplink, the trainer
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_k1_unit_row_windows_bitwise(cuda, wire):
    """K1 over one unit-gain row (the trainer's ``(1, d)``), held to its
    plain version on windows keyed on the absolute index (``start=``)."""
    n = 3 * 2 ** 20 + 5
    row = torch.randn(1, n, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(1))
    if wire is not None:
        row = row.to(wire)
    ones = torch.ones(1, device=cuda)
    kw = dict(sigma=2.5e-4, scale=0.8)
    out = ota_fused.fused_aggregate(row, ones, wire_dtype=wire, seed=77,
                                    **kw)
    for lo in (0, 2 ** 20 + 3, n - 4096):
        hi = min(lo + 4096, n)
        want = ref.ota_fused_ref(
            row[:, lo:hi], ones,
            ref.counter_noise(77, hi - lo, cuda, start=lo), **kw)
        assert torch.equal(out[lo:hi], want), lo


@pytest.mark.cuda
def test_add_awgn_is_one_k1_launch(cuda):
    from repro_torch.core import ota
    from repro_torch.core.channel import RayleighChannel

    cfg = ota.OTAConfig(RayleighChannel(), noise_sigma=1e-2, debias=True,
                        wire_dtype="bfloat16")
    g = torch.Generator(cuda).manual_seed(2)
    tree = {"b": {"w": torch.randn(33, 7, device=cuda, generator=g)},
            "a": torch.randn(100, device=cuda, generator=g).bfloat16()}
    before = ota_fused.LAUNCHES
    got = ota.add_awgn(cfg, 5, tree, 4)
    assert ota_fused.LAUNCHES - before == 1
    want = ota.add_awgn(cfg, 5, tree, 4, backend="torch")
    assert ota_fused.LAUNCHES - before == 1
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], want["a"])
    assert torch.equal(got["b"]["w"], want["b"]["w"])


def _driver(seed, rpc, ckpt=""):
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.fedpg import FedPGConfig
    from repro_torch.core.ota import OTAConfig
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.service import (
        ParticipationConfig, RoundService, ServiceConfig, StalenessConfig,
    )

    cfg = FedPGConfig(n_agents=10, batch_m=4, horizon=8, n_rounds=1)
    return RoundService(
        LandmarkNav(), MLPPolicy(), cfg, seed,
        participation=ParticipationConfig(rate=0.5),
        staleness=StalenessConfig(4, 0.8),
        ota=OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True),
        service=ServiceConfig(rounds_per_commit=rpc, max_rounds=8,
                              checkpoint_dir=str(ckpt)))


def _svc_bits(svc):
    st = svc.state
    trees = list(st.theta.values()) + list(st.stale.grads.values())
    return st.round_idx, [t.cpu().numpy().tobytes()
                          for t in trees + [st.stale.age, st.seed]]


@pytest.mark.cuda
def test_driver_resume_and_commit_size_bitwise_on_the_card(cuda, tmp_path):
    before = ota_fused.LAUNCHES
    ref_svc = _driver(3, 2)
    ref_svc.run()
    assert ota_fused.LAUNCHES - before == 8          # one a stacked round
    a = _driver(3, 2, tmp_path)
    a.commit(), a.commit()
    b = _driver(3, 2, tmp_path)
    assert b.resume() and b.state.round_idx == 4
    b.run()
    assert _svc_bits(b) == _svc_bits(ref_svc)
    one = _driver(3, 1)
    one.run()
    assert _svc_bits(one) == _svc_bits(ref_svc)


def _train_setup():
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.train import trainer

    cfg = get_smoke_config("llama3.2-3b")
    tcfg = trainer.TrainConfig(aggregator="ota", n_agents=4, microbatch=2,
                               total_steps=6, lr=1e-3, warmup=2,
                               wire_dtype="bfloat16")
    return cfg, tcfg, InputShape("t", 32, 8, "train")


@pytest.mark.cuda
def test_train_step_one_k1_launch_and_donation(cuda):
    from repro_torch.data import make_batch
    from repro_torch.models import model as model_lib
    from repro_torch.train import trainer
    from repro_torch.utils.tree import flatten_paths

    cfg, tcfg, shape = _train_setup()
    m = model_lib.build(cfg)
    batch = make_batch(cfg, shape, 0)
    state = trainer.init_state(m, tcfg)
    old = flatten_paths(state.params)
    before = ota_fused.LAUNCHES
    new, metrics = trainer.make_train_step(m, tcfg)(state, batch)
    assert ota_fused.LAUNCHES - before == 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    # the step wrote into the state it took
    got = flatten_paths(new.params)
    assert all(got[k] is v for k, v in old.items())
    assert all(new.opt_state.mu[k] is v
               for k, v in state.opt_state.mu.items())


@pytest.mark.cuda
def test_train_resume_bitwise_on_the_card(cuda, tmp_path):
    from repro_torch.launch import train as launch
    from repro_torch.utils.tree import flatten_paths

    cfg, tcfg, shape = _train_setup()
    torch.use_deterministic_algorithms(True)
    try:
        straight, _ = launch.train(cfg, tcfg, shape, steps=4, verbose=False)
        launch.train(cfg, tcfg, shape, steps=2, ckpt_dir=str(tmp_path),
                     verbose=False)
        resumed, _ = launch.train(cfg, tcfg, shape, steps=4,
                                  ckpt_dir=str(tmp_path), verbose=False)
    finally:
        torch.use_deterministic_algorithms(False)
    for ta, tb in ((straight.params, resumed.params),
                   (straight.opt_state.mu, resumed.opt_state.mu),
                   (straight.opt_state.nu, resumed.opt_state.nu)):
        a, b = flatten_paths(ta), flatten_paths(tb)
        assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# streamed lanes, per-agent budgets as lanes, sweep(mode="sharded")
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("service", [False, True])
def test_streamed_lanes_are_bitwise_their_runs_on_the_card(cuda, service):
    """Four lanes streamed in blocks of 3 (a short tail block): 2 K1 lane
    launches a block + 1 (3 a block under staleness), every lane bitwise
    ``fedpg.run(agent_blocks=3)``."""
    from repro_torch.core import fedpg, lanes
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.ota import OTAConfig
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy
    from repro_torch.service import ParticipationConfig, StalenessConfig

    cfg = fedpg.FedPGConfig(n_agents=7, batch_m=4, horizon=9, n_rounds=3,
                            alpha=1e-2)
    kw = dict(participation=ParticipationConfig(rate=0.5),
              staleness=StalenessConfig(3, 0.8)) if service else {}
    specs = [lanes.LaneSpec(s, cfg.alpha, OTAConfig(
        RayleighChannel(), noise_sigma=sig, debias=True), **kw)
        for s in (1, 2) for sig in (1e-3, 1e-2)]
    before = ota_fused.LAUNCHES
    theta, hist = lanes.run_lanes(LandmarkNav(), MLPPolicy(), cfg, specs,
                                  agent_blocks=3)
    folds = 3 if service else 2
    assert ota_fused.LAUNCHES - before == (folds * 3 + 1) * cfg.n_rounds
    for i, spec in enumerate(specs):
        t1, h1 = fedpg.run(LandmarkNav(), MLPPolicy(), cfg, spec.seed,
                           ota=spec.ota, agent_blocks=3, **kw)
        for x, y in zip(h1, hist):
            assert torch.equal(x, y[i]), i
        for k in t1:
            assert torch.equal(t1[k], theta[k][i]), (i, k)


@pytest.mark.cuda
def test_sweep_sharded_is_vmap_on_the_card(cuda):
    """A streamed partition of three scenarios and a per-agent budget
    partition: ``"sharded"`` on ``[cuda] x 2`` (one pad lane) and on the
    default mesh bitwise ``"vmap"``."""
    from repro_torch.core import sweep
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.power_control import HeterogeneousBudget
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    size = dict(channel=RayleighChannel(), noise_sigma=1e-3, debias=True,
                n_agents=7, batch_m=4, horizon=9, n_rounds=3)
    sc = (sweep.grid(alpha=[1e-3, 2e-3, 3e-3], agent_blocks=3, **size)
          + sweep.grid(power_control=[HeterogeneousBudget(p_max=1.5),
                                      HeterogeneousBudget(p_max=3.0)],
                       **size))
    vmap = sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 2)
    for mesh in (None, make_sweep_mesh(devices=[torch.device(cuda)] * 2)):
        sharded = sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 2,
                              mode="sharded", mesh=mesh)
        for x, y in zip(vmap.history, sharded.history):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_sharded_cells_launch_k1_on_their_own_card(cuda, monkeypatch):
    """A sharded sweep over every visible card (one card listed twice where
    there is only one), the caller's current card being cuda:0: every K1
    launch runs with its operands' card current, every card of the mesh
    launches, and the result is bitwise ``"vmap"``.  Without the device
    guard a cell on another card would launch on cuda:0."""
    from repro_torch.core import sweep
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    n = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(n)] if n > 1
               else [torch.device("cuda", 0)] * 2)
    real_launch, real_lib = ota_fused._launch, ota_fused._lib
    want, seen = [], []

    def launch(mode, grads, *args, **kw):
        want.append(grads.device.index)
        return real_launch(mode, grads, *args, **kw)

    class Lib:
        def __getattr__(self, name):
            fn = getattr(real_lib(), name)
            if name != "ota_fused_launch":
                return fn

            def call(*args):
                seen.append(torch.cuda.current_device())
                return fn(*args)
            return call

    monkeypatch.setattr(ota_fused, "_launch", launch)
    monkeypatch.setattr(ota_fused, "_lib", Lib)
    size = dict(channel=RayleighChannel(), noise_sigma=1e-3, debias=True,
                n_agents=7, batch_m=4, horizon=9, n_rounds=3)
    alphas = [1e-3 * (i + 1) for i in range(len(devices) + 1)]  # a pad lane
    sc = (sweep.grid(alpha=alphas, agent_blocks=3, **size)
          + sweep.grid(alpha=alphas, **size))
    torch.cuda.set_device(0)
    vmap = sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 2)
    sharded = sweep.sweep(LandmarkNav(), MLPPolicy(), sc, 0, 2,
                          mode="sharded", mesh=make_sweep_mesh(devices=devices))
    assert sharded.n_devices == len(devices)
    for x, y in zip(vmap.history, sharded.history):
        np.testing.assert_array_equal(x, y)
    assert seen == want
    assert set(want) == {d.index for d in devices}


# ---------------------------------------------------------------------------
# the agent mesh: ranks of a torch.distributed group (nccl), one card each
# ---------------------------------------------------------------------------

MESH_CFG = dict(batch_m=4, horizon=9, n_rounds=3, alpha=1e-2)


def _mesh_forms():
    from repro_torch.core.channel import RayleighChannel
    from repro_torch.core.ota import OTAConfig
    from repro_torch.service import ParticipationConfig

    ota = OTAConfig(RayleighChannel(), noise_sigma=1e-3, debias=True)
    return {"stacked": (8, dict(ota=ota)),
            "exact": (8, dict()),
            "streamed": (10, dict(ota=ota, agent_blocks=2)),
            "service": (10, dict(ota=ota, agent_blocks=2,
                                 participation=ParticipationConfig(rate=0.5)))}


def _mesh_runs(mesh):
    """Every form on this rank (run by ``launch.mesh.run_local``), with its
    K1 launches and collectives."""
    from repro_torch.core import fedpg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    out = {}
    for name, (n, kw) in _mesh_forms().items():
        cfg = fedpg.FedPGConfig(n_agents=n, **MESH_CFG)
        before = (ota_fused.LAUNCHES, mesh_lib.ALL_REDUCES,
                  mesh_lib.ALL_GATHERS)
        res = fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 5, agent_mesh=mesh,
                        **kw)
        after = (ota_fused.LAUNCHES, mesh_lib.ALL_REDUCES,
                 mesh_lib.ALL_GATHERS)
        out[name] = (res, tuple(a - b for a, b in zip(after, before)))
    return out


def _mesh_k1(name, n, blocks, rank, size):
    from repro_torch.core import lanes
    from repro_torch.launch.mesh import AgentMesh

    if name == "exact":
        return 0
    mesh = AgentMesh(None, rank, size, torch.device("cuda", rank))
    layout = lanes.rank_layout(n, blocks, mesh)[2]
    return 2 if layout is None else 2 * len(layout) + 1


@pytest.mark.cuda
def test_agent_mesh_one_rank_is_bitwise_the_run_on_the_card(cuda):
    """A one-rank nccl mesh on ``cuda:0``: each form bitwise ``fedpg.run``
    off the mesh on the card; K1 launches a round (the fold and the tail;
    2 a block + 1 streamed; none for the exact stacked round), one
    all_reduce and one all_gather a round."""
    from repro_torch.core import fedpg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    ranks = mesh_lib.run_local(_mesh_runs, 1, device="cuda", timeout=600)
    k = MESH_CFG["n_rounds"]
    for name, (n, kw) in _mesh_forms().items():
        (theta, hist), counts = ranks[0][name]
        cfg = fedpg.FedPGConfig(n_agents=n, **MESH_CFG)
        t1, h1 = fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 5, **kw)
        for x, y in zip(hist, h1):
            assert torch.equal(x, y.cpu()), name
        for key in t1:
            assert torch.equal(theta[key], t1[key].cpu()), (name, key)
        assert counts == (_mesh_k1(name, n, kw.get("agent_blocks"), 0, 1) * k,
                          k, k), (name, counts)


@pytest.mark.cuda
def test_agent_mesh_over_every_card(cuda):
    """The mesh over every visible card (a rank each): every rank ends
    bitwise the same, within rtol 1e-5 of the run off the mesh, with its
    own K1 launches a round.  Skips below two cards."""
    from repro_torch.core import fedpg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.rl.env import LandmarkNav
    from repro_torch.rl.policy import MLPPolicy

    w = torch.cuda.device_count()
    if w < 2:
        pytest.skip("needs two or more cards")
    ranks = mesh_lib.run_local(_mesh_runs, w, device="cuda", timeout=600)
    k = MESH_CFG["n_rounds"]
    for name, (n, kw) in _mesh_forms().items():
        (theta0, hist0), _ = ranks[0][name]
        cfg = fedpg.FedPGConfig(n_agents=n, **MESH_CFG)
        t1, h1 = fedpg.run(LandmarkNav(), MLPPolicy(), cfg, 5, **kw)
        assert torch.equal(hist0.gain_mean, h1.gain_mean.cpu()), name
        for x, y in zip(hist0, h1):
            np.testing.assert_allclose(x.numpy(), y.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        for r, res in enumerate(ranks):
            (theta, hist), counts = res[name]
            for x, y in zip(hist, hist0):
                assert torch.equal(x, y), (name, r)
            for key in theta0:
                assert torch.equal(theta[key], theta0[key]), (name, r, key)
            assert counts == (_mesh_k1(name, n, kw.get("agent_blocks"), r, w)
                              * k, k, k), (name, r, counts)


# ---------------------------------------------------------------------------
# the moe family, and K3/K4 under autograd
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_k3_k4_refuse_inputs_that_require_grad(cuda):
    """K3 and K4 have no backward: a CUDA call under grad mode with an
    operand that requires grad raises, naming the kernel; under no_grad,
    or with no operand that requires grad, it launches; a CPU call runs the
    plain version either way."""
    x, dt, A, B, C = _ssd_inputs(3, 1, 64, 2, 32, 1, 16, torch.float32, cuda)
    q, k, v = _qkv(4, 1, 4, 2, 64, 64, 64, torch.bfloat16, cuda)
    pos = torch.arange(64, dtype=torch.int32, device=cuda)
    calls = {
        "ssd_scan": lambda g: ssd_scan.ssd_scan(
            g(x), dt, A, B, C, chunk=32),
        "flash_attention": lambda g: flash_attention.flash_attention(
            g(q), k, v),
        "attend_bshd": lambda g: flash_attention.attend_bshd(
            g(q.transpose(1, 2)), k.transpose(1, 2), v.transpose(1, 2),
            q_pos=pos, k_pos=pos)}
    grad = lambda t: t.detach().requires_grad_()
    plain = lambda t: t
    for name, call in calls.items():
        kernel = "K4" if name == "ssd_scan" else "K3"
        before = (ssd_scan.LAUNCHES + ssd_scan.LAUNCHES_TC
                  + flash_attention.LAUNCHES + flash_attention.LAUNCHES_TC)
        with pytest.raises(RuntimeError, match=f"{kernel} .*no backward"):
            call(grad)
        with torch.no_grad():
            call(grad)
        call(plain)
        torch.cuda.synchronize()
        after = (ssd_scan.LAUNCHES + ssd_scan.LAUNCHES_TC
                 + flash_attention.LAUNCHES + flash_attention.LAUNCHES_TC)
        assert after == before + 2, name
    y = ssd_scan.ssd_scan(x.cpu().requires_grad_(), dt.cpu(), A.cpu(),
                          B.cpu(), C.cpu(), chunk=32)
    assert y.requires_grad


def _moe_smoke(capacity_factor, dtype=torch.float32):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("granite-moe-1b-a400m").with_(
        dtype=str(dtype)[6:])
    return cfg.with_(moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [1.0, 4.0],
                         ids=["drops", "no-drops"])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, capacity_factor):
    """``moe_ffn`` of granite's smoke layer on the card against the CPU on
    the same float32 inputs: routing and dispatch (idx, keep, dest) equal,
    the output and aux within rtol 1e-5."""
    from repro_torch.models import moe
    from repro_torch.models.param import init_params

    cfg = _moe_smoke(capacity_factor)
    params = init_params(moe.moe_plan(cfg), "float32",
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 64, cfg.d_model)).astype(np.float32))
    outs = {}
    for dev in ("cpu", cuda):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        xd = x.to(dev)
        h = moe.rmsnorm(p["norm"], xd, cfg.norm_eps).reshape(-1, cfg.d_model)
        idx, gates, _ = moe.route(p, h, cfg)
        _, keep, dest = moe.dispatch(idx, cfg.moe.num_experts,
                                     moe._capacity(h.shape[0], cfg))
        out, aux = moe.moe_ffn(p, xd, cfg)
        outs[str(dev)] = [t.cpu() for t in (idx, keep, dest, out, aux)]
    (i0, k0, d0, o0, a0), (i1, k1, d1, o1, a1) = outs.values()
    assert torch.equal(i0, i1) and torch.equal(k0, k1)
    assert torch.equal(d0, d1)
    assert bool(k0.all()) == (capacity_factor == 4.0)
    torch.testing.assert_close(o1, o0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a1, a0, rtol=1e-5, atol=0)


def _smoke_train_step(cfg, seed):
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_batch
    from repro_torch.models import model as model_lib
    from repro_torch.train import trainer

    m = model_lib.build(cfg)
    tcfg = trainer.TrainConfig(aggregator="ota", n_agents=4, total_steps=4,
                               lr=1e-3, warmup=1, seed=seed,
                               wire_dtype="bfloat16")
    state = trainer.init_state(m, tcfg)
    batch = make_batch(cfg, InputShape("t", 32, 8, "train"), 0)
    return trainer.make_train_step(m, tcfg)(state, batch)


@pytest.mark.cuda
def test_moe_train_step_deterministic_twice_the_same_bits(cuda):
    """A granite-moe smoke OTA train step (bf16, drops at capacity 1.25)
    runs under ``torch.use_deterministic_algorithms(True)`` (every dispatch
    op has a deterministic kernel) and gives the same bits twice; one K1
    launch a step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.utils.tree import flatten_paths

    cfg = get_smoke_config("granite-moe-1b-a400m")
    torch.use_deterministic_algorithms(True)
    try:
        before = ota_fused.LAUNCHES
        runs = [_smoke_train_step(cfg, 3) for _ in range(2)]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert ota_fused.LAUNCHES - before == 2
    (s0, m0), (s1, m1) = runs
    a, b = flatten_paths(s0.params), flatten_paths(s1.params)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
        assert bool(torch.isfinite(m0[k])), k


@pytest.mark.cuda
def test_ssm_train_step_launches_k1_and_no_k4(cuda):
    """A mamba2-130m smoke OTA train step on the card: the mixer trains
    through the plain scan (no K4 launch), one K1 launch, finite
    metrics."""
    from repro_torch.configs import get_smoke_config

    before = (ssd_scan.LAUNCHES, ssd_scan.LAUNCHES_TC, ota_fused.LAUNCHES)
    _, metrics = _smoke_train_step(get_smoke_config("mamba2-130m"), 0)
    torch.cuda.synchronize()
    assert (ssd_scan.LAUNCHES, ssd_scan.LAUNCHES_TC) == before[:2]
    assert ota_fused.LAUNCHES == before[2] + 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


FAMILY_PREFILLS = [  # (arch, K3 wgmma launches, K4 tensor-core launches)
    ("zamba2-7b", 0, 2),                # two mamba layers; shared: attend
    ("llama-3.2-vision-11b", 2, 0),     # a dense and a cross layer's self
    ("seamless-m4t-large-v2", 4, 0),    # two encoder (bidirectional) + two
]
FAMILY_BIDIR = {"seamless-m4t-large-v2": 2}   # the encoder's K3 launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch,k3,k4", FAMILY_PREFILLS)
def test_family_smoke_prefill_launches_its_kernels(cuda, arch, k3, k4):
    """A bf16 smoke prefill (B=2, S=64) of the hybrid, vlm and encdec
    families on the card launches the tensor-core K3 and K4 as many times
    as the layers that run them (K3 bidirectionally as many times as the
    encoder's layers), and none of PR 12's kernels; its
    last-position logits are within 2e-2 of the max abs logit of the same
    prefill on the CPU (the kernels' plain versions)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import memory_stub
    from repro_torch.models import model as model_lib
    from repro_torch.utils.tree import tree_map

    cfg = get_smoke_config(arch)
    m = model_lib.build(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 64)))
    mem = (memory_stub(cfg, tokens, 64) if model_lib.needs_memory(cfg)
           else None)
    want, _ = m.prefill(params, tokens, mem)
    def counts():
        return (flash_attention.LAUNCHES, flash_attention.LAUNCHES_TC,
                ssd_scan.LAUNCHES, ssd_scan.LAUNCHES_TC,
                flash_attention.LAUNCHES_BIDIR,
                flash_attention.LAUNCHES_TC_BIDIR)

    before = counts()
    with torch.no_grad():
        got, _ = m.prefill(tree_map(lambda x: x.cuda(), params),
                           tokens.cuda(), None if mem is None else mem.cuda())
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (
        0, k3, 0, k4, 0, FAMILY_BIDIR.get(arch, 0))
    got, want = got.float().cpu(), want.float()
    assert float((got - want).abs().max() / want.abs().max()) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [a for a, _, _ in FAMILY_PREFILLS])
def test_family_smoke_train_step_launches_k1_and_no_k3_k4(cuda, arch):
    """A smoke OTA train step of the hybrid, vlm and encdec families on the
    card (the vlm and encdec batches with the memory stub): one K1 launch,
    no K3 or K4 launch (the encoder and the shared block through
    ``attend``, the mamba layers through the plain scan), finite
    metrics."""
    from repro_torch.configs import get_smoke_config

    before = (flash_attention.LAUNCHES, flash_attention.LAUNCHES_TC,
              ssd_scan.LAUNCHES, ssd_scan.LAUNCHES_TC, ota_fused.LAUNCHES)
    _, metrics = _smoke_train_step(get_smoke_config(arch), 0)
    torch.cuda.synchronize()
    after = (flash_attention.LAUNCHES, flash_attention.LAUNCHES_TC,
             ssd_scan.LAUNCHES, ssd_scan.LAUNCHES_TC, ota_fused.LAUNCHES)
    assert after[:4] == before[:4]
    assert after[4] == before[4] + 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


# ---------------------------------------------------------------------------
# the tensor-parallel serve path: a ("data", "model") mesh of nccl ranks
# ---------------------------------------------------------------------------

SHARDED_ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "mamba2-130m")


def _k34():
    return (flash_attention.LAUNCHES, flash_attention.LAUNCHES_TC,
            ssd_scan.LAUNCHES, ssd_scan.LAUNCHES_TC)


def _sharded_smoke(am, data, model_, dtype):
    """Smoke prefill (B=4, S=64) and 2 decode steps (into the prefill's
    cache, a ring of 64 slots) of each arch on this rank's ``(data,
    model_)`` mesh, on the same weights (seed 0) as the unsharded path run
    here on the card; gathered results, K3/K4 launches of each path, and
    the unsharded results."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    from repro_torch.train import server
    from repro_torch.utils.tree import tree_map

    mesh = mesh_lib.make_tiny_mesh(data, model_)
    out = {}
    for arch in SHARDED_ARCHS:
        cfg = get_smoke_config(arch).with_(dtype=dtype)
        m = model_lib.build(cfg)
        params = tree_map(lambda x: x.cuda(), m.init(
            torch.Generator().manual_seed(0), "cpu"))
        tokens = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab, (4, 64))).cuda()
        srv = server.shard_for_serving(m, params, mesh)
        step = srv.make_serve_step(InputShape("s", 64, 4, "decode"))
        plain_step = server.make_serve_step(m, InputShape("s", 64, 4,
                                                          "decode"))
        c0 = _k34()
        logits, cache = srv.prefill(tokens)
        c1 = _k34()
        with torch.no_grad():
            plain, pcache = m.prefill(params, tokens)
        c2 = _k34()
        tok = torch.argmax(plain[:, -1:], -1)
        steps, plain_steps = [], []
        for _ in range(2):
            _, lg, cache = step(cache, tok)
            _, plg, pcache = plain_step(params, pcache, tok)
            steps.append(lg.full_tensor().float().cpu())
            plain_steps.append(plg.float().cpu())
            tok = torch.argmax(plg[:, -1:], -1)
        out[arch] = dict(
            logits=logits.full_tensor().float().cpu(),
            plain=plain.float().cpu(), steps=steps, plain_steps=plain_steps,
            k34=tuple(a - b for a, b in zip(c1, c0)),
            k34_plain=tuple(a - b for a, b in zip(c2, c1)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_serve_one_rank_is_bitwise_the_unsharded_path(cuda, dtype):
    """A (1, 1) mesh of one nccl rank: the smoke prefill and decode steps
    of the dense, moe and ssm families bitwise the unsharded path on the
    same weights, with the same K3/K4 launches (every collective is the
    identity at width 1)."""
    from repro_torch.launch import mesh as mesh_lib

    res = mesh_lib.run_local(_sharded_smoke, 1, 1, 1, dtype, device="cuda",
                             timeout=600)[0]
    for arch, r in res.items():
        assert torch.equal(r["logits"], r["plain"]), arch
        for a, b in zip(r["steps"], r["plain_steps"]):
            assert torch.equal(a, b), arch
        assert r["k34"] == r["k34_plain"] and sum(r["k34"]) == 2, (
            arch, r["k34"])


@pytest.mark.cuda
def test_sharded_serve_over_every_card(cuda):
    """Four cards as (2, 2) and (4, 1) meshes: the smoke prefill and decode
    steps in float32 within 1e-4 of the max abs logit of the unsharded
    path on one card, every rank bitwise the others, K3/K4 launched on
    every rank.  Skips below four cards."""
    from repro_torch.launch import mesh as mesh_lib

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    for data, model_ in ((2, 2), (4, 1)):
        ranks = mesh_lib.run_local(_sharded_smoke, 4, data, model_,
                                   "float32", device="cuda", timeout=600)
        for arch in SHARDED_ARCHS:
            r0 = ranks[0][arch]
            want = r0["plain"]
            err = float((r0["logits"] - want).abs().max()
                        / want.abs().max())
            assert err < 1e-4, (data, model_, arch, err)
            for r in ranks:
                assert torch.equal(r[arch]["logits"], r0["logits"])
                for a, b in zip(r[arch]["steps"], r0["steps"]):
                    assert torch.equal(a, b)
                assert sum(r[arch]["k34"]) == 2, (arch, r[arch]["k34"])


def _family_sharded_smoke(am, dtype):
    """Smoke zamba2-7b (5 layers: two groups and a tail) and
    llama-3.2-vision-11b on a one-rank (1, 1) mesh against the unsharded
    path on the same weights (seed 0): the prefill (B=4, S=64, vision with
    its patch memory) and 2 decode steps, their K3/K4 launches, then 2
    train steps (4 agents, OTA) of the sharded step against the plain one
    from the same state and batches, with their K1 launches."""
    from repro_torch import interop
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_batch, memory_stub
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model as model_lib
    from repro_torch.train import server, trainer
    from repro_torch.utils.tree import tree_map

    mesh = mesh_lib.make_tiny_mesh(1, 1)
    out = {}
    for arch, n_layers in (("zamba2-7b", 5), ("llama-3.2-vision-11b", None)):
        cfg = get_smoke_config(arch).with_(dtype=dtype)
        if n_layers:
            cfg = cfg.with_(n_layers=n_layers)
        m = model_lib.build(cfg)
        params = tree_map(lambda x: x.cuda(), m.init(
            torch.Generator().manual_seed(0), "cpu"))
        tokens = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab, (4, 64))).cuda()
        mem = (memory_stub(cfg, tokens, 64) if model_lib.needs_memory(cfg)
               else None)
        srv = server.shard_for_serving(m, params, mesh)
        c0 = _k34()
        logits, cache = srv.prefill(tokens, mem)
        c1 = _k34()
        with torch.no_grad():
            plain, pcache = m.prefill(params, tokens, mem)
        c2 = _k34()
        same = [torch.equal(logits.to_local(), plain)]
        if cfg.family != "hybrid":     # a cache of 64 + 2 slots
            full = srv.init_cache(4, 66, mem.shape[1], device="cuda")
            pfull = m.init_cache(4, 66, mem.shape[1], device="cuda")
            for f in ("groups_kv", "cross_self_kv"):
                for dst, pdst, src, psrc in zip(getattr(full, f),
                                                getattr(pfull, f),
                                                getattr(cache, f),
                                                getattr(pcache, f)):
                    dst.to_local()[..., :64, :, :] = src.to_local()
                    pdst[..., :64, :, :] = psrc
            cache = full._replace(pos=cache.pos, cross_kv=cache.cross_kv)
            pcache = pfull._replace(pos=pcache.pos, cross_kv=pcache.cross_kv)
        shape = InputShape("s", 66, 4, "decode")
        step, plain_step = srv.make_serve_step(shape), \
            server.make_serve_step(m, shape)
        tok = torch.argmax(plain[:, -1:], -1)
        for _ in range(2):
            _, lg, cache = step(cache, tok)
            _, plg, pcache = plain_step(params, pcache, tok)
            same.append(torch.equal(lg.to_local(), plg))
            tok = torch.argmax(plg[:, -1:], -1)
        a, b = (interop.cache_to_numpy(c) for c in (cache, pcache))
        same.append(all(a[f] == b[f] if f == "pos" or a[f] is None else
                        all(np.array_equal(a[f][k], b[f][k]) for k in a[f])
                        for f in a))
        tcfg = trainer.TrainConfig(n_agents=4, total_steps=10, warmup=2,
                                   lr=1e-3)
        pstate = trainer.init_state(m, tcfg, torch.Generator(
            device="cuda").manual_seed(1))
        sstate, sstep = trainer.shard_for_training(
            m, tcfg, trainer.init_state(m, tcfg, torch.Generator(
                device="cuda").manual_seed(1)), mesh)
        pstep = trainer.make_train_step(m, tcfg)
        k1 = []
        for i in range(2):
            batch = make_batch(cfg, InputShape("t", 32, 8, "train"), i,
                               device="cuda")
            before = (ota_fused.LAUNCHES, ota_fused.LAUNCHES_MAPPED)
            sstate, ms = sstep(sstate, batch)
            mid = (ota_fused.LAUNCHES, ota_fused.LAUNCHES_MAPPED)
            pstate, mp = pstep(pstate, batch)
            k1.append((mid[0] - before[0], mid[1] - before[1],
                       ota_fused.LAUNCHES - mid[0]))
            na, nb = (interop.train_state_to_numpy(x) for x in (pstate,
                                                                sstate))
            same.append(all(
                np.array_equal(na[g][k].view(np.uint8),
                               nb[g][k].view(np.uint8))
                for g in ("params", "mu", "nu") for k in na[g])
                and all(torch.equal(mp[k], ms[k]) for k in mp))
        out[arch] = dict(same=same, k1=k1,
                         k34=tuple(x - y for x, y in zip(c1, c0)),
                         k34_plain=tuple(x - y for x, y in zip(c2, c1)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_family_sharded_serve_and_train_one_rank_bitwise(cuda, dtype):
    """The hybrid and vlm families on a (1, 1) mesh of one nccl rank:
    prefill, decode steps, every cache field and two train steps bitwise
    the unsharded path; the prefill's K3/K4 launches the unsharded one's
    (zamba2: one K4 a mamba layer, 5; vision: one K3 a layer, 2); one
    mapped K1 launch a sharded step, one unmapped a plain step."""
    from repro_torch.launch import mesh as mesh_lib

    res = mesh_lib.run_local(_family_sharded_smoke, 1, dtype, device="cuda",
                             timeout=600)[0]
    for arch, want in (("zamba2-7b", 5), ("llama-3.2-vision-11b", 2)):
        r = res[arch]
        assert all(r["same"]), (arch, r["same"])
        assert r["k34"] == r["k34_plain"] and sum(r["k34"]) == want, (
            arch, r["k34"])
        kernel = r["k34"][2:] if arch == "zamba2-7b" else r["k34"][:2]
        assert sum(kernel) == want, (arch, r["k34"])
        assert r["k1"] == [(1, 1, 1)] * 2, (arch, r["k1"])
