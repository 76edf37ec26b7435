"""K1's two bodies and its lane axis, on the CPU.

The dispatch rule (``ota_fused.k1_body``) decides from shapes, the wire dtype
and the lane count alone, and ``check_body`` refuses a CUDA stack the chosen
body cannot take before anything reaches the card; both are pure Python, so
they are tested here.  The lane form (``fused_aggregate_lanes``,
``fused_aggregate_sgd_lanes``) runs its plain version on CPU tensors: lane l
must be bitwise the one-lane call, and the whole must match JAX's
``jax.vmap`` of the Pallas kernel (interpret mode, as ``tests/test_kernels.py``
runs it) over per-lane (sigma, scale, seed), with the stack shared or per
lane, at K1's tolerance (rtol 1e-6, atol 1e-7).  For that comparison the
stacks hold multiples of 2^-6 and the gains multiples of 2^-4, so every
product and partial sum is exact and XLA's dot and the port's sequential
agent fold give the same sum: with random floats they part by an ulp of the
partial sums (up to 4.8e-7 at lane 0's scale 1.0), which
``tests/test_torch_kernels.py`` bounds for one lane at its own scale.  What
remains is what the lanes add: each lane's sigma, scale and seed, and the
noise's log/cos, a few ulps apart between XLA and PyTorch.  The kernels
themselves are held to the same plain versions on the card
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ota_fused as jax_fused
from repro_torch.kernels import ota_fused, ref

LANES = 3
SIGMAS = np.array([0.1, 0.5, 1.5], np.float32)
SCALES = np.array([1.0, 0.25, 0.05], np.float32)
SEEDS = np.array([0, 1, 2 ** 32 - 1], np.uint32)


def _stack(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _dyadic(seed, shape, lo, hi, step):
    """Integers in [lo, hi] times ``step``: exact products and sums."""
    return (np.random.default_rng(seed).integers(lo, hi + 1, shape)
            * step).astype(np.float32)


@pytest.mark.parametrize("case,want", [
    ((10, 165), "wide"),                # the paper's width
    ((33, 165), "wide"),                # a streamed block of 32 + acc
    ((47, 165), "wide"),
    ((48, 165), "tall"),                # the crossover at P = 165
    ((65, 165), "tall"),                # a streamed block of 64 + acc
    ((10_000, 165), "tall"),            # the stacked round at N = 10^4
    ((100_000, 165), "tall"),
    ((8, 2 ** 21), "wide"),             # wide P
    ((10_000, ota_fused.TALL_MAX_PARAMS + 1), "wide"),
    ((124, 500), "wide"),               # A < P / 4
    ((125, 500), "tall"),
    ((10_000, 512), "tall"),
    ((10_000, 513), "wide"),            # past the rule's widest P
    ((10_000, 1000), "wide"),
])
def test_k1_body_picks_by_shape(case, want):
    assert ota_fused.k1_body(*case) == want
    assert ota_fused.k1_body(*case, torch.bfloat16) == want


def test_k1_body_lanes_need_an_aligned_lane_stride():
    # (10^4 + 1) * 165 * 4 bytes is no multiple of 16: per-lane stacks would
    # start off the 16-byte grid, so the rule keeps them wide
    assert ota_fused.k1_body(10_001, 165, torch.float32, 1) == "tall"
    assert ota_fused.k1_body(10_001, 165, torch.float32, 3) == "wide"
    assert ota_fused.k1_body(10_000, 165, torch.float32, 3) == "tall"
    # in bf16 the stride halves: 10_004 * 165 * 2 is no multiple of 16
    assert ota_fused.k1_body(10_004, 165, torch.float32, 20) == "tall"
    assert ota_fused.k1_body(10_004, 165, torch.bfloat16, 20) == "wide"


@pytest.mark.parametrize("offset", [4, 8, 660, 1320])
def test_k1_body_gives_an_unaligned_stack_to_the_wide_body(offset):
    # a view off the 16-byte grid (e.g. rows 1.. of a P = 165 f32 stack) is
    # the wide body's, decided before launch; an aligned one stays tall
    assert ota_fused.k1_body(10_000, 165, torch.float32, 1,
                             data_ptr=256 + offset) == "wide"
    assert ota_fused.k1_body(10_000, 165, torch.float32, 1,
                             data_ptr=256 + 16 * offset) == "tall"
    assert ota_fused.k1_body(10, 165, data_ptr=256 + offset) == "wide"


@pytest.mark.parametrize("body,kw,match", [
    ("tall", dict(n_agents=10_000, n_params=2_000), "takes P <="),
    ("tall", dict(n_agents=10_000, n_params=165, data_ptr=4), "aligned"),
    ("tall", dict(n_agents=10_001, n_params=165, lane_stride=10_001 * 165,
                  lanes=3), "aligned"),
    ("wide", dict(n_agents=10, n_params=165, lanes=70_000), "lanes"),
    ("narrow", dict(n_agents=10, n_params=165), "no body"),
])
def test_a_stack_the_chosen_body_cannot_take_raises(body, kw, match):
    kw.setdefault("data_ptr", 0)
    with pytest.raises(ValueError, match=match):
        ota_fused.check_body(body, wire_dtype=torch.float32, **kw)


def test_check_body_takes_what_the_rule_gives():
    for a, p in ((10, 165), (10_000, 165), (256, 500), (8, 2 ** 21)):
        for dtype in (torch.float32, torch.bfloat16):
            for ptr in (256, 256 + 660, 256 + 330):
                body = ota_fused.k1_body(a, p, dtype, data_ptr=ptr)
                ota_fused.check_body(body, a, p, dtype, data_ptr=ptr)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("noise", [True, False])
def test_plain_lanes_are_the_per_lane_loop_bitwise(shared, noise):
    a, p = 5, 300
    g = torch.from_numpy(_stack(1, (a, p) if shared else (LANES, a, p)))
    h = torch.from_numpy(np.abs(_stack(2, (LANES, a))) + 0.1)
    params = torch.from_numpy(_stack(3, (LANES, p)))
    r = torch.tensor([2.0, 0.5, 0.0])
    kw = dict(sigma=SIGMAS.tolist(), scale=SCALES.tolist(),
              seed=SEEDS.tolist(), with_noise=noise, rescale=r)
    agg = ota_fused.fused_aggregate_lanes(g, h, **kw)
    sgd = ota_fused.fused_aggregate_sgd_lanes(g, h, params, alpha=[0.1, 0.2,
                                                                   0.3], **kw)
    assert agg.shape == sgd.shape == (LANES, p)
    for lane in range(LANES):
        gl = g if shared else g[lane]
        one = dict(sigma=float(SIGMAS[lane]), scale=float(SCALES[lane]),
                   seed=int(SEEDS[lane]), with_noise=noise,
                   rescale=r[lane:lane + 1])
        assert torch.equal(agg[lane], ota_fused.fused_aggregate(
            gl, h[lane], **one))
        assert torch.equal(sgd[lane], ota_fused.fused_aggregate_sgd(
            gl, h[lane], params[lane], alpha=[0.1, 0.2, 0.3][lane], **one))
    assert not bool(torch.any(agg[2] != 0))     # a zero rescale: no update
    # the ref loop itself, given the same noise
    noise_t = torch.stack([ref.counter_noise(int(s), p) for s in SEEDS])
    want = ref.ota_fused_lanes_ref(
        g.expand(LANES, a, p), h, noise_t if noise else None,
        sigma=SIGMAS.tolist(), scale=SCALES.tolist(), rescale=r)
    assert torch.equal(agg, want)


def test_lanes_broadcast_scalars_and_tensors():
    g = torch.from_numpy(_stack(4, (4, 64)))
    h = torch.ones(4)
    by_list = ota_fused.fused_aggregate_lanes(g, h, sigma=[0.3, 0.3],
                                              scale=0.5, seed=[7, 8])
    by_tensor = ota_fused.fused_aggregate_lanes(
        g, h, sigma=torch.tensor(0.3), scale=torch.tensor([0.5, 0.5]),
        seed=torch.tensor([7, 8]))
    assert torch.equal(by_list, by_tensor)
    with pytest.raises(ValueError, match="disagree"):
        ota_fused.fused_aggregate_lanes(g, h, sigma=[0.1, 0.2],
                                        seed=[1, 2, 3])


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_lanes_match_jax_vmap_of_the_pallas_kernel(shared, wire):
    """tests/test_kernels.py::test_fused_vmap_folds_lanes_into_grid's
    shapes and per-lane (sigma, scale, seed)."""
    a, p = 4, 800
    g = _dyadic(16, (a, p) if shared else (LANES, a, p), -64, 64, 2 ** -6)
    h = _dyadic(17, (LANES, a), 1, 16, 2 ** -4)
    jw, tw = (jnp.bfloat16, torch.bfloat16) if wire == "bf16" else (None,
                                                                    None)

    def one(gl, hl, sigma, scale, seed):
        return jax_fused.fused_aggregate(
            gl, hl, sigma=sigma, scale=scale, seed=seed, with_noise=True,
            block_rows=8, wire_dtype=jw)

    in_axes = (None if shared else 0, 0, 0, 0, 0)
    want = jax.vmap(one, in_axes=in_axes)(
        jnp.asarray(g), jnp.asarray(h), jnp.asarray(SIGMAS),
        jnp.asarray(SCALES), jnp.asarray(SEEDS))
    got = ota_fused.fused_aggregate_lanes(
        torch.from_numpy(g), torch.from_numpy(h),
        sigma=torch.from_numpy(SIGMAS), scale=torch.from_numpy(SCALES),
        seed=torch.from_numpy(SEEDS.astype(np.int64)), wire_dtype=tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_sgd_lanes_match_jax_vmap_of_the_pallas_kernel():
    a, p = 4, 800
    g = _dyadic(18, (LANES, a, p), -64, 64, 2 ** -6)
    h = _dyadic(19, (LANES, a), 1, 16, 2 ** -4)
    params = _stack(20, (LANES, p))
    alphas = np.array([0.05, 0.1, 0.2], np.float32)

    def one(gl, hl, pl, alpha, sigma, scale, seed):
        return jax_fused.fused_aggregate_sgd(
            gl, hl, pl, alpha=alpha, sigma=sigma, scale=scale, seed=seed,
            with_noise=True, block_rows=8)

    want = jax.vmap(one)(*(jnp.asarray(x) for x in (
        g, h, params, alphas, SIGMAS, SCALES, SEEDS)))
    got = ota_fused.fused_aggregate_sgd_lanes(
        *(torch.from_numpy(x) for x in (g, h, params)),
        alpha=torch.from_numpy(alphas), sigma=torch.from_numpy(SIGMAS),
        scale=torch.from_numpy(SCALES),
        seed=torch.from_numpy(SEEDS.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
