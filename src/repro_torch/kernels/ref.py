"""Plain PyTorch versions of the port's kernels (K1, K2, K3, K4).

Counterpart of ``repro/kernels/ref.py``.  Each kernel's wrapper takes its
plain version for CPU tensors, and ``chip_smoke.py`` holds the kernel to it
on the card:

* K1, the fused over-the-air uplink: ``ota_fused_ref`` and its sgd/adam
  forms, plus the kernel's counter PRNG, ``counter_noise``, which the JAX
  package keeps inside ``repro/kernels/ota_fused.py`` (``_mix``,
  ``_counter_noise``);
* K2, the server-side update ``(v + sigma*n) / (N*m_h)`` over a tensor of
  any shape: ``ota_channel_ref`` (the JAX package's oracle, op for op) and
  ``ota_channel_plain`` (that oracle on the counter stream);
* K3, flash attention: ``flash_attention_plain`` (blockwise online softmax,
  the f32 kernel's arithmetic) beside ``flash_attention_ref`` (the
  materialised softmax oracle of the JAX package), and
  ``flash_attention_tc``, the plain model of the bf16 tensor-core kernel's
  arithmetic (bf16 score products, the P split into two bf16 terms);
* K4, the SSD scan: the chunked ``ssd_ref`` (``repro/models/ssm.py::ssd_ref``,
  kept here so ``models/ssm.py`` and this module do not import each other)
  and the sequential ``ssd_sequential_ref``, and ``ssd_tc``, the plain model
  of the tensor-core kernel's arithmetic (P-column slices, f32 operands as
  three bf16 terms).

The K1 functions are the definitions the CUDA kernel in ``csrc/ota_fused.cu``
is held to, op for op:

* the gain matvec is a strict sequential fold over agents from zero,
  ``v = (((0 + h0*g0) + h1*g1) + ...)``, each product and sum rounded on its
  own (the kernel uses ``__fmul_rn``/``__fadd_rn``, which are never
  contracted into an FMA);
* then ``v + sigma*n``, then ``* scale``, then the mode's epilogue; with a
  device ``rescale`` factor the scale is ``float32(scale) * rescale``,
  rounded to float32 first.

Given the kernel's own noise realisation, ``ota_fused_ref`` is bitwise equal
to the kernel's ``agg`` mode in fp32 and through the bf16 wire.

The counter PRNG works on uint32 values held in int64 tensors (PyTorch has
no wrap-around uint32 multiply on every device); ``_mul32`` multiplies
modulo 2^32 in 16-bit halves so no intermediate leaves the int64 range.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9          # seed multiplier
SALT_U1 = 0xA511E9B3         # first uniform stream
SALT_U2 = 0x63D83595         # second uniform stream
TWO_PI_F32 = 6.283185307179586   # rounded to float32(2*pi) by the f32 multiply

Seed = Union[int, torch.Tensor]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a Python constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _mix(x: torch.Tensor, salt) -> torch.Tensor:
    """One murmur3-finalizer round over uint32 counters."""
    x = x ^ salt
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def _seed_salt(seed: Seed, device):
    """``seed * GOLDEN mod 2^32``: a Python int for an int seed (no
    host-to-device copy, which would wait for the card), else a tensor."""
    if isinstance(seed, torch.Tensor):
        return _mul32(seed.to(device=device, dtype=torch.int64) & MASK32,
                      GOLDEN)
    return (int(seed) & MASK32) * GOLDEN & MASK32


def counter_bits(seed: Seed, n: int, device=None, *,
                 start: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two 24-bit uniform streams ``(u1 >> 8, u2 >> 8)`` for the absolute
    flat indices ``start..start+n-1`` (int64 tensors).  ``start`` is a
    64-bit Python int, so a window past 2^31 of a long row is keyed on its
    absolute index, as ``_counter_noise(seed, start, shape)`` is in the JAX
    package; the counter itself is a uint32, so the window must end at or
    below 2^32."""
    start = int(start)
    if start < 0 or start + n > 2 ** 32:
        raise ValueError(f"counter PRNG indexes < 2^32 elements, got the "
                         f"window [{start}, {start + n})")
    if device is None and isinstance(seed, torch.Tensor):
        device = seed.device
    counter = torch.arange(start, start + n, dtype=torch.int64,
                           device=device)
    return counter_bits_at(seed, counter)


def counter_bits_at(seed: Seed, counter: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`counter_bits` at the given uint32 counters (an int64 tensor
    of values in ``[0, 2^32)``), in their order."""
    base = _mix(counter, _seed_salt(seed, counter.device))
    return _mix(base, SALT_U1) >> 8, _mix(base, SALT_U2) >> 8


def uniforms(b1: torch.Tensor,
             b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """24-bit streams -> (f1 in (0, 1], f2 in [0, 1)), float32, exact."""
    f1 = b1.float() * (1.0 / (1 << 24)) + (1.0 / (1 << 25))
    f2 = b2.float() * (1.0 / (1 << 24))
    return f1, f2


def counter_noise(seed: Seed, n: int, device=None, *,
                  start: int = 0) -> torch.Tensor:
    """(n,) standard normals: counter PRNG on the absolute index ``start +
    i``, then Box-Muller, ``sqrt(-2 log f1) * cos(float32(2 pi) * f2)``."""
    return _box_muller(*counter_bits(seed, n, device, start=start))


def _box_muller(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    f1, f2 = uniforms(b1, b2)
    return torch.sqrt(-2.0 * torch.log(f1)) * torch.cos(TWO_PI_F32 * f2)


MAP_DIMS = 4       # a counter-map segment's dimensions (csrc/ota_fused.cu)
MAP_COLS = 2 + 2 * MAP_DIMS


def counter_map_index(table: torch.Tensor, n: int, lo: int = 0,
                      hi: Optional[int] = None) -> torch.Tensor:
    """The counter of each element of a row of ``n`` under a counter map
    (the plain version of K1's mapped noise addressing): ``table`` is
    ``(segments, MAP_COLS)`` int64, a row a segment ``[offset in the row,
    base counter, sizes (MAP_DIMS, the last fastest), strides
    (MAP_DIMS)]``; the element at ``offset + r`` with ``r`` the row-major
    index ``(i_0, .., i_3)`` of the sizes takes ``base + sum_d i_d *
    stride_d`` modulo 2^32 (the uint32 counter wraps, as the JAX
    package's).  Returns the ``(hi - lo,)`` int64 counters of the row's
    elements ``[lo, hi)`` (default the whole row)."""
    hi = n if hi is None else hi
    out = torch.empty(hi - lo, dtype=torch.int64, device=table.device)
    # the segments are laid out on the host (K1 reads the table on the card)
    for seg in table.tolist():  # repro: noqa[host-sync] a few rows a call
        off, base = seg[0], seg[1]
        sizes, strides = seg[2:2 + MAP_DIMS], seg[2 + MAP_DIMS:]
        a, b = max(lo, off), min(hi, off + math.prod(sizes))
        if a >= b:
            continue
        r = torch.arange(a - off, b - off, dtype=torch.int64,
                         device=table.device)
        j = torch.full_like(r, base)
        for size, stride in zip(reversed(sizes), reversed(strides)):
            j = j + (r % size) * stride
            r = r // size
        out[a - lo:b - lo] = j & MASK32
    return out


def counter_noise_at(seed: Seed, counter: torch.Tensor) -> torch.Tensor:
    """Standard normals at the given counters (:func:`counter_noise`'s
    stream, element for element)."""
    return _box_muller(*counter_bits_at(seed, counter))


def f32(x) -> torch.Tensor:
    """A runtime scalar as a 0-dim float32 CPU tensor, rounded from double
    once, as ``jnp.asarray(x, float32)`` does.  PyTorch passes a 0-dim CPU
    tensor to a CUDA op as a float32 scalar argument, so no host-to-device
    copy is made."""
    return torch.tensor(float(x), dtype=torch.float32)


def ota_fused_ref(grads: torch.Tensor, gains: torch.Tensor,
                  noise: Optional[torch.Tensor] = None, *, sigma=0.0,
                  scale=1.0,
                  rescale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """u = (sum_i h_i g_i + sigma*n) * scale over an (A, P) stack; a
    ``rescale`` tensor multiplies ``scale`` (in float32) first."""
    dev = grads.device
    g = grads.float()
    h = gains.float()
    v = torch.zeros(g.shape[1], dtype=torch.float32, device=dev)
    for a in range(g.shape[0]):
        v = v + h[a] * g[a]
    if noise is not None:
        v = v + f32(sigma) * noise.float()
    s = f32(scale)
    if rescale is not None:
        s = s * rescale.float().reshape(())
    return v * s


def ota_fused_sgd_ref(grads, gains, params, noise=None, *, alpha, sigma=0.0,
                      scale=1.0, rescale=None) -> torch.Tensor:
    """p' = p - alpha * u over :func:`ota_fused_ref`."""
    u = ota_fused_ref(grads, gains, noise, sigma=sigma, scale=scale,
                      rescale=rescale)
    return params.float() - f32(alpha) * u


def ota_fused_lanes_ref(grads: torch.Tensor, gains: torch.Tensor,
                        noise: Optional[torch.Tensor] = None, *,
                        sigma: Sequence[float], scale: Sequence[float],
                        rescale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(L, P): lane l is :func:`ota_fused_ref` over ``grads[l]`` (A, P),
    ``gains[l]``, ``noise[l]``, ``sigma[l]``, ``scale[l]`` and
    ``rescale[l]``, a loop over lanes (K1's lane form, ``jax.vmap`` of the
    JAX kernel)."""
    return torch.stack([
        ota_fused_ref(grads[l], gains[l], None if noise is None else noise[l],
                      sigma=sigma[l], scale=scale[l],
                      rescale=None if rescale is None else rescale[l])
        for l in range(grads.shape[0])])


def ota_fused_sgd_lanes_ref(grads, gains, params, noise=None, *,
                            alpha: Sequence[float], sigma: Sequence[float],
                            scale: Sequence[float],
                            rescale=None) -> torch.Tensor:
    """(L, P): lane l is :func:`ota_fused_sgd_ref` over lane l's operands."""
    return torch.stack([
        ota_fused_sgd_ref(grads[l], gains[l], params[l],
                          None if noise is None else noise[l],
                          alpha=alpha[l], sigma=sigma[l], scale=scale[l],
                          rescale=None if rescale is None else rescale[l])
        for l in range(grads.shape[0])])


def adam_bias_corrections(b1, b2, step) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(1 - b1^t, 1 - b2^t)`` in float32, as the JAX wrapper computes them."""
    t = f32(step)
    return 1.0 - f32(b1) ** t, 1.0 - f32(b2) ** t


def ota_fused_adam_ref(grads, gains, params, mu, nu, noise=None, *, alpha,
                       step, b1=0.9, b2=0.999, eps=1e-8, sigma=0.0,
                       scale=1.0):
    """Aggregation + bias-corrected Adam on the fused update, op for op as
    the kernel's adam mode.  Returns (p', mu', nu')."""
    u = ota_fused_ref(grads, gains, noise, sigma=sigma, scale=scale)
    c1, c2 = adam_bias_corrections(b1, b2, step)
    a, b1, b2, eps = (f32(x) for x in (alpha, b1, b2, eps))
    mu_n = b1 * mu.float() + (1.0 - b1) * u
    nu_n = b2 * nu.float() + (1.0 - b2) * torch.square(u)
    delta = -(a * (mu_n / c1) / (torch.sqrt(nu_n / c2) + eps))
    return params.float() + delta, mu_n, nu_n


# ---------------------------------------------------------------------------
# K2: the server-side OTA update over a tensor of any shape
# ---------------------------------------------------------------------------

K2_DTYPES = (torch.float32, torch.bfloat16)


def ota_channel_scale(n_agents: int, m_h: float, debias: bool) -> float:
    """``1 / (N * m_h)`` (``1 / N`` without debias) in Python double, as
    the TPU wrapper computes it; kernels round it to float32 once."""
    return 1.0 / (n_agents * (m_h if debias else 1.0))


def ota_channel_ref(v: torch.Tensor, noise: Optional[torch.Tensor], *,
                    sigma: float, n_agents: int, m_h: float,
                    debias: bool = True) -> torch.Tensor:
    """``(v + sigma * noise) / (N * m_h)`` in float32, written in v's dtype
    (the JAX package's ``ota_channel_ref``).  ``noise=None`` skips the noise
    term, as K2 does for sigma = 0."""
    x = v.float()
    if noise is not None:
        x = x + f32(sigma) * noise.float().reshape(v.shape)
    return (x * f32(ota_channel_scale(n_agents, m_h, debias))).to(v.dtype)


def ota_channel_plain(v: torch.Tensor, *, sigma: float, n_agents: int,
                      m_h: float = 1.0, debias: bool = True,
                      seed: int = 0) -> torch.Tensor:
    """The plain K2: :func:`ota_channel_ref` on the counter stream keyed on
    the absolute flat index (no noise when ``sigma <= 0``)."""
    noise = (counter_noise(seed, v.numel(), v.device) if sigma > 0.0
             else None)
    return ota_channel_ref(v, noise, sigma=sigma, n_agents=n_agents,
                           m_h=m_h, debias=debias)


# ---------------------------------------------------------------------------
# K3: flash attention, layout (B, H, S, Dh); GQA reads kv head h // (H/Hkv)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def visible(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) bool: key visible from query."""
    ok = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


def _positions(pos: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    return pos


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Materialised-softmax oracle (``repro/kernels/ref.py:16``): f32 scores
    of ``q / sqrt(dh)``, NEG_INF where masked, softmax, f32 PV."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    kf = torch.repeat_interleave(k, g, dim=1).float()
    vf = torch.repeat_interleave(v, g, dim=1).float()
    qf = q.float() / torch.sqrt(torch.tensor(float(dh)))
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    ok = visible(torch.arange(sq, device=q.device),
                  torch.arange(sk, device=q.device), causal, window)
    scores = torch.where(ok, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: Optional[int] = None,
                          q_pos: Optional[torch.Tensor] = None,
                          k_pos: Optional[torch.Tensor] = None,
                          block_k: int = 128) -> torch.Tensor:
    """K3's plain version: the flash forward's arithmetic, KV block by KV
    block.  Scores ``(q * scale) . k`` in f32 with ``scale = 1/sqrt(dh)``
    rounded once to f32; NEG_INF where masked; online softmax with f32
    ``(m, l, acc)``; output ``acc / max(l, 1e-30)`` in q's dtype.  GQA views
    q as (B, Hkv, g, Sq, Dh), so the KV heads are never repeated.
    ``q_pos``/``k_pos`` default to ``arange``."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    dev = q.device
    q_pos = _positions(q_pos, sq, dev)
    k_pos = _positions(k_pos, sk, dev)
    qf = q.float().reshape(b, hkv, g, sq, dh) * (1.0 / dh ** 0.5)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hkv, g, sq, dh, dtype=torch.float32, device=dev)
    for k0 in range(0, sk, block_k):
        kb = k[:, :, k0:k0 + block_k].float()
        vb = v[:, :, k0:k0 + block_k].float()
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kb)
        ok = visible(q_pos, k_pos[k0:k0 + block_k], causal, window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, sq, dh).to(q.dtype)


def split_bf16(x: torch.Tensor, terms: int) -> List[torch.Tensor]:
    """f32 ``x`` as ``terms`` bf16 parts (returned in f32) whose sum is x to
    about 8 * terms significant bits: each part is the bf16 rounding (RNE)
    of what the earlier parts leave."""
    parts = []
    rest = x.float()
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        parts.append(part)
        rest = rest - part
    return parts


def flash_attention_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, window: Optional[int] = None,
                       q_pos: Optional[torch.Tensor] = None,
                       k_pos: Optional[torch.Tensor] = None,
                       p_terms: int = 2) -> torch.Tensor:
    """Plain model of the arithmetic of the bf16 tensor-core K3
    (``csrc/flash_attention_wgmma.cu``): scores ``(q . k) * scale`` with the
    bf16 products summed in f32 and the f32 scale applied after; 128-key
    tiles; online softmax with f32 ``(m, l)``; ``P . V`` as
    ``p_hi . V + p_lo . V`` with ``p_hi = bf16(p)``, ``p_lo = bf16(p -
    p_hi)`` (``p_terms=1`` models a single bf16 P, which the kernel does not
    use); ``l`` sums the f32 ``p``; output ``acc / max(l, 1e-30)`` in q's
    dtype.  Tiles the kernel skips add nothing here either: their
    probabilities are 0 or are wiped by the correction of a later tile."""
    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = h // hkv
    dev = q.device
    q_pos = _positions(q_pos, sq, dev)
    k_pos = _positions(k_pos, sk, dev)
    scale = torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32)
    qf = q.float().reshape(b, hkv, g, sq, dh)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hkv, g, sq, dh, dtype=torch.float32, device=dev)
    for k0 in range(0, sk, 128):
        kb = k[:, :, k0:k0 + 128].float()
        vb = v[:, :, k0:k0 + 128].float()
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kb) * scale.to(dev)
        ok = visible(q_pos, k_pos[k0:k0 + 128], causal, window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None]
        for part in split_bf16(p, p_terms):
            acc = acc + torch.einsum("bkgqc,bkcd->bkgqd", part, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, sq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# K4: the Mamba2 SSD scan, x (B, S, H, P), dt (B, S, H), A (H,),
# B/C (B, S, G, N); f32 math
# ---------------------------------------------------------------------------

def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked SSD scan, f32 math; returns y (B, S, H, P) in float32.

    Sequences shorter than / not divisible by ``chunk`` are zero-padded on
    the right: dt=0 padding steps have decay exp(0)=1 and zero input, so
    they are exact no-ops on both the outputs and the carried state.
    """
    b, s_orig, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    chunk = min(chunk, s_orig)
    pad = -s_orig % chunk
    if pad:
        def zp(a):
            return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])],
                             dim=1)
        x, dt, B, C = zp(x), zp(dt), zp(B), zp(C)
    s = s_orig + pad
    nc = s // chunk

    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    da = dt * A.float()[None, None, :]                          # (b,s,h) <= 0
    dax = x * dt[..., None]                                     # dt-weighted input

    xc = dax.reshape(b, nc, chunk, g, hg, p)
    dac = da.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)

    cum = torch.cumsum(dac, dim=2)                              # (b,nc,Q,h)
    cum_g = cum.reshape(b, nc, chunk, g, hg)

    # intra-chunk (quadratic, attention-like)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)         # (b,nc,g,Q,Q)
    # seg[q, k] = cum[q] - cum[k] = sum_{tau in (k, q]} da_tau   (<= 0)
    seg = cum_g[:, :, :, None] - cum_g[:, :, None, :]            # (b,nc,Q,K,g,hg)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    # masked before the exp: above the diagonal seg is a positive sum that
    # overflows exp at a real model's dt and A, and autograd would then
    # carry inf * 0 = nan back from the masked entries.  exp(-inf) = 0 is
    # the same forward value bit for bit
    decay = torch.exp(torch.where(mask[None, None, :, :, None, None], seg,
                                  float("-inf")))
    y_intra = torch.einsum("bcgqk,bcqkgh,bckghp->bcqghp", scores, decay, xc)

    # chunk states
    last = cum[:, :, -1:, :]                                    # (b,nc,1,h)
    decay_to_end = torch.exp(last - cum).reshape(b, nc, chunk, g, hg)
    states = torch.einsum("bcqgn,bcqgh,bcqghp->bcghpn", Bc, decay_to_end, xc)

    # inter-chunk carry
    chunk_decay = torch.exp(last[:, :, 0, :]).reshape(b, nc, g, hg)
    s_prev = torch.zeros(b, g, hg, p, n, dtype=torch.float32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, ..., None, None] + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                       # (b,nc,g,hg,p,n)

    y_inter = torch.einsum("bcqgn,bcghpn,bcqgh->bcqghp", Cc, s_prevs,
                           torch.exp(cum_g))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y[:, :s_orig]


def ssd_tc(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, chunk: int,
           p_slice: int = 16) -> torch.Tensor:
    """Plain model of the arithmetic of the tensor-core K4
    (``csrc/ssd_scan_tc.cu``); returns y (B, S, H, P) in float32.

    The P columns are scanned in slices of ``p_slice``, each on its own (the
    kernel's blocks; the split is exact).  ``C . B^T`` multiplies the bf16
    values exactly and sums in f32.  Each other product has one exact
    operand (x or C) and one f32 operand, taken as three bf16 terms
    (:func:`split_bf16`): ``(C.B^T o decay o dt) . x``, ``C . S`` and
    ``(B o exp(last - cum) o dt)^T . x``.  The state carries in f32:
    ``S <- exp(last) S + ...``."""
    b, s_orig, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    chunk = min(chunk, s_orig)
    pad = -s_orig % chunk
    if pad:
        def zp(a):
            return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])],
                             dim=1)
        x, dt, B, C = zp(x), zp(dt), zp(B), zp(C)
    s = s_orig + pad
    nc = s // chunk
    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    dtc = dt.reshape(b, nc, chunk, g, hg)
    cum = torch.cumsum((dt * A.float()[None, None, :]).reshape(
        b, nc, chunk, g, hg), dim=2)                              # (b,nc,Q,g,hg)
    last = cum[:, :, -1:]
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)           # exact products
    seg = cum[:, :, :, None] - cum[:, :, None, :]                 # (b,nc,Q,K,g,hg)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None, None]
    lw = torch.where(mask, scores.permute(0, 1, 3, 4, 2)[..., None]
                     * torch.exp(torch.where(mask, seg, 0.0))
                     * dtc[:, :, None], 0.0)                      # (b,nc,Q,K,g,hg)
    bw = Bc[..., None] * (torch.exp(last - cum) * dtc)[:, :, :, :, None]
    bw = bw.permute(0, 1, 2, 3, 5, 4)                             # (b,nc,K,g,hg,n)
    decay = torch.exp(last[:, :, 0])                              # (b,nc,g,hg)
    ys = []
    for p0 in range(0, p, p_slice):
        xs = x[..., p0:p0 + p_slice].reshape(b, nc, chunk, g, hg, -1)
        y_intra = sum(torch.einsum("bcqkgh,bckghp->bcqghp", part, xs)
                      for part in split_bf16(lw, 3))
        states = sum(torch.einsum("bckghn,bckghp->bcghpn", part, xs)
                     for part in split_bf16(bw, 3))
        s_prev = torch.zeros_like(states[:, 0])
        y_inter = []
        for c in range(nc):
            y_inter.append(sum(torch.einsum("bqgn,bghpn->bqghp", Cc[:, c], part)
                               for part in split_bf16(s_prev, 3)))
            s_prev = s_prev * decay[:, c, ..., None, None] + states[:, c]
        y_inter = torch.stack(y_inter, dim=1) * torch.exp(cum)[..., None]
        ys.append((y_intra + y_inter).reshape(b, s, h, -1))
    return torch.cat(ys, dim=-1)[:, :s_orig]


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Fully sequential SSD recurrence — the definition (slow, exact)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    x, dt, B, C, A = x.float(), dt.float(), B.float(), C.float(), A.float()
    state = torch.zeros(b, g, hg, p, n, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A[None, :]).reshape(b, g, hg)
        dax = (x[:, t] * dt[:, t, :, None]).reshape(b, g, hg, p)
        state = (state * decay[..., None, None]
                 + torch.einsum("bgn,bghp->bghpn", B[:, t], dax))
        ys.append(torch.einsum("bgn,bghpn->bghp", C[:, t], state)
                  .reshape(b, h, p))
    return torch.stack(ys, dim=1)
