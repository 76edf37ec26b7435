"""The arithmetic of the tensor-core kernels, on the CPU.

``ref.flash_attention_tc`` and ``ref.ssd_tc`` are plain models of what the
bf16 tensor-core kernels ``csrc/flash_attention_wgmma.cu`` (K3) and
``csrc/ssd_scan_tc.cu`` (K4) compute, rounding for rounding where it
matters: K3 multiplies bf16 Q and K exactly, sums in f32, scales after,
and splits P into two bf16 terms; K4 scans the P columns in slices of 16,
multiplies C.B^T exactly and takes each f32 operand of the other products
as three bf16 terms.  Here each model is held, at smoke sizes, against

* the JAX package's Pallas kernel in interpret mode (as
  ``tests/test_torch_kernels.py`` runs it) or, where that kernel refuses
  the shape, the JAX oracle;
* the port's plain version, at the kernels' unchanged contracts: K3 bf16
  atol = rtol = 2e-2 and within one bf16 ulp (rtol 2**-7, atol 1e-5); K4
  5e-5 against ``ssd_ref`` and 1e-4 against the sequential recurrence.

So the chosen rounding is shown to meet the contract before the card runs
it.  The dispatch rules of both wrappers are checked here too: they look at
dtype, shape, strides and pointers only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import flash_attention, ref, ssd_scan

BF16_ULP = 2 ** -7


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _qkv(seed, b, h, hkv, sq, sk, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh))]


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_contract(got, plain):
    """K3's bf16 contract against the plain version."""
    got, plain = got.float(), plain.float()
    torch.testing.assert_close(got, plain, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=BF16_ULP)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "b,h,hkv,s,dh,causal,window",
    [
        (1, 2, 2, 128, 64, True, None),
        (1, 4, 2, 256, 128, True, None),     # GQA g=2, two key tiles
        (1, 3, 1, 128, 112, True, None),     # Dh 112: two 64-column boxes
        (1, 2, 1, 256, 64, True, 128),       # sliding window
        (1, 2, 2, 128, 64, False, None),     # bidirectional
    ],
)
def test_k3_model_matches_jax_kernel_and_plain(b, h, hkv, s, dh, causal,
                                               window):
    q, k, v = _qkv(b * s + h + dh, b, h, hkv, s, s, dh)
    want = jax_flash(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                     causal=causal, window=window, block_q=128, block_k=128)
    tq, tk, tv = (_bf16(x) for x in (q, k, v))
    got = ref.flash_attention_tc(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, s, dh)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)
    _assert_contract(got, ref.flash_attention_plain(
        tq, tk, tv, causal=causal, window=window))


@pytest.mark.parametrize(
    "b,h,hkv,sq,sk,dh,window",
    [
        (1, 4, 2, 200, 200, 64, None),    # ragged tile: 200 = 128 + 72
        (1, 3, 1, 130, 300, 128, None),   # Sq != Sk, both ragged
        (1, 2, 2, 170, 170, 80, 50),      # Dh 80 (a box with zero columns), window
        (2, 6, 2, 48, 48, 112, None),     # one short tile
    ],
)
def test_k3_model_ragged_against_jax_oracle(b, h, hkv, sq, sk, dh, window):
    """Shapes the Pallas kernel refuses (not multiples of 128): against the
    JAX package's materialised oracle where Sq == Sk, and the port's plain
    version always."""
    q, k, v = _qkv(sq * 7 + dh, b, h, hkv, sq, sk, dh)
    tq, tk, tv = (_bf16(x) for x in (q, k, v))
    got = ref.flash_attention_tc(tq, tk, tv, window=window)
    if sq == sk:
        oracle = jax_ref.flash_attention_ref(
            *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
            causal=True, window=window)
        np.testing.assert_allclose(_np(got), _np(oracle), atol=2e-2,
                                   rtol=2e-2)
    _assert_contract(got, ref.flash_attention_plain(tq, tk, tv,
                                                    window=window))


@pytest.mark.parametrize("shift,stride,window", [(100, 1, None), (0, 2, 1)])
def test_k3_model_rows_that_see_no_key(shift, stride, window):
    """Positions where some queries see no key: those rows are the mean of
    V in the model as in the plain version."""
    q, k, v = (_bf16(x) for x in _qkv(7, 2, 4, 2, 200, 200, 64))
    q_pos = torch.arange(200)
    k_pos = torch.arange(200) * stride + shift
    got = ref.flash_attention_tc(q, k, v, window=window, q_pos=q_pos,
                                 k_pos=k_pos)
    _assert_contract(got, ref.flash_attention_plain(
        q, k, v, window=window, q_pos=q_pos, k_pos=k_pos))
    blind = ~ref.visible(q_pos, k_pos, True, window).any(dim=1)
    assert blind.any()
    mean = v.float().mean(dim=2).repeat_interleave(2, dim=1)
    torch.testing.assert_close(got[:, :, blind].float(),
                               mean[:, :, None].expand_as(got[:, :, blind]),
                               atol=1e-5, rtol=BF16_ULP)


def test_k3_single_bf16_p_leaves_the_ulp_contract():
    """Why the kernel splits P: a single bf16 P keeps 8 bits and parts from
    the plain version by more than one bf16 ulp of some outputs, where two
    terms stay within it."""
    q, k, v = (_bf16(x) for x in _qkv(3, 1, 4, 2, 256, 256, 128))
    plain = ref.flash_attention_plain(q, k, v).float()
    one = ref.flash_attention_tc(q, k, v, p_terms=1).float()
    two = ref.flash_attention_tc(q, k, v, p_terms=2).float()
    excess = lambda got: ((got - plain).abs()
                          - (1e-5 + BF16_ULP * plain.abs())).max().item()
    assert excess(two) <= 0.0 < excess(one)


def test_split_bf16_terms_recover_f32():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    for terms, rel in ((1, 2 ** -8), (2, 2 ** -16), (3, 2 ** -24)):
        parts = ref.split_bf16(x, terms)
        assert all(torch.equal(p, p.bfloat16().float()) for p in parts)
        assert ((sum(parts) - x).abs() <= rel * x.abs()).all()


def test_k3_dispatch_rule():
    """The tensor-core kernel takes bf16, Dh a multiple of 16 up to 128,
    16-byte-aligned pointers and strides that are multiples of 8."""
    def views(dh, dtype=torch.bfloat16, s=64):
        return [torch.zeros(2, 4, s, dh, dtype=dtype) for _ in range(4)]
    for dh in (16, 64, 80, 112, 128):
        assert flash_attention.takes_tensor_cores(*views(dh))
    for dh in (8, 72, 120):
        assert not flash_attention.takes_tensor_cores(*views(dh))
    assert not flash_attention.takes_tensor_cores(*views(64, torch.float32))
    # a pointer 2 bytes past a 16-byte boundary
    base = torch.zeros(2 * 4 * 64 * 64 + 8, dtype=torch.bfloat16)
    shifted = base[1:1 + 2 * 4 * 64 * 64].view(2, 4, 64, 64)
    assert not flash_attention.takes_tensor_cores(shifted, *views(64)[1:])
    # the model's (B, S, H, Dh) layout read as (B, H, S, Dh): strides fit
    bshd = torch.zeros(2, 64, 4, 112, dtype=torch.bfloat16).transpose(1, 2)
    assert flash_attention.takes_tensor_cores(bshd, *views(112)[1:])
    # a sequence stride that is not a multiple of 8 elements
    odd = torch.zeros(2, 4, 64, 68, dtype=torch.bfloat16)[..., :64]
    assert not flash_attention.takes_tensor_cores(odd, *views(64)[1:])
    # a dim of size 1 has no stride that matters
    one = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
    assert flash_attention.takes_tensor_cores(one, one, one, one)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1).astype(
        np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, h)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


def _ssd_both(seed, b, s, h, p, g, n):
    """bf16 x, B, C and f32 dt, A: the JAX arrays and the port's tensors."""
    x, dt, A, B, C = _ssd_inputs(seed, b, s, h, p, g, n)
    J = [jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B).astype(jnp.bfloat16), jnp.asarray(C).astype(jnp.bfloat16)]
    T = [_bf16(x), torch.from_numpy(dt), torch.from_numpy(A), _bf16(B),
         _bf16(C)]
    return J, T


@pytest.mark.parametrize(
    "b,s,h,p,g,n,chunk",
    [
        (1, 128, 2, 64, 1, 64, 64),
        (1, 256, 4, 64, 1, 128, 128),        # mamba2-130m-like
        (1, 256, 4, 32, 2, 16, 64),          # grouped B/C
        (2, 128, 8, 64, 2, 64, 32),
    ],
)
def test_k4_model_matches_jax_kernel_and_plain(b, s, h, p, g, n, chunk):
    J, T = _ssd_both(s + h * p, b, s, h, p, g, n)
    got = ref.ssd_tc(*T, chunk)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, p)
    # the TPU kernel writes x's dtype (bf16): its rounding
    want = jax_ssd_scan(*J, chunk=chunk)
    np.testing.assert_allclose(_np(got.bfloat16()), _np(want), atol=5e-2,
                               rtol=5e-2)
    np.testing.assert_allclose(got.numpy(), _np(jax_ref.ssd_ref(*J, chunk)),
                               atol=5e-5, rtol=5e-5)
    torch.testing.assert_close(got, ref.ssd_ref(*T, chunk), atol=5e-5,
                               rtol=5e-5)


@pytest.mark.parametrize(
    "b,s,h,p,g,n,chunk",
    [
        (1, 200, 2, 40, 1, 16, 64),    # P not a multiple of the slice; S of the chunk
        (1, 300, 3, 24, 1, 32, 40),    # a chunk that is not a multiple of 16
        (2, 48, 4, 32, 1, 16, 128),    # S < chunk: chunk = S
        (1, 130, 2, 8, 1, 8, 128),     # one slice narrower than 16
    ],
)
def test_k4_model_edges_against_plain_and_sequential(b, s, h, p, g, n, chunk):
    J, T = _ssd_both(11 + s + p, b, s, h, p, g, n)
    got = ref.ssd_tc(*T, chunk)
    torch.testing.assert_close(got, ref.ssd_ref(*T, chunk), atol=5e-5,
                               rtol=5e-5)
    torch.testing.assert_close(got, ref.ssd_sequential_ref(*T), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), _np(jax_ref.ssd_sequential_ref(*J)),
                               atol=1e-4)


def test_k4_slices_are_exact():
    """The P-slice split changes no bit: each column's scan is its own."""
    _, T = _ssd_both(5, 1, 256, 2, 48, 1, 32)
    whole = ref.ssd_tc(*T, 64, p_slice=48)
    assert torch.equal(ref.ssd_tc(*T, 64, p_slice=16), whole)
    assert torch.equal(ref.ssd_tc(*T, 64, p_slice=8), whole)


def test_k4_dispatch_rule():
    def ops(p=64, n=128, dtype=torch.bfloat16):
        return (torch.zeros(1, 32, 2, p, dtype=dtype),
                torch.zeros(1, 32, 1, n, dtype=dtype),
                torch.zeros(1, 32, 1, n, dtype=dtype))
    assert ssd_scan.takes_tensor_cores(*ops())
    assert ssd_scan.takes_tensor_cores(*ops(p=40, n=16))
    assert not ssd_scan.takes_tensor_cores(*ops(dtype=torch.float32))
    assert not ssd_scan.takes_tensor_cores(*ops(p=36))
    assert not ssd_scan.takes_tensor_cores(*ops(n=20))
    x, B, C = ops()
    base = torch.zeros(x.numel() + 8, dtype=torch.bfloat16)
    assert not ssd_scan.takes_tensor_cores(
        base[4:4 + x.numel()].view(x.shape), B, C)
