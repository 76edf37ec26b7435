"""Roofline terms on the NVIDIA H100's published peaks, from a dry run.

Counterpart of ``repro/utils/roofline.py``: the same :class:`RooflineReport`
fields and formulas, :func:`ota_fused_cost` and :func:`model_flops_per_step`,
on the H100's constants.  Three terms, all per-rank seconds (the dry run
traces rank 0 of the mesh, so its FLOPs and bytes are already one rank's):

    compute term    = FLOPs            / peak FLOP/s
    memory term     = bytes            / HBM bandwidth
    collective term = collective bytes / link bandwidth

The constants are NVIDIA's data-sheet peaks for the H100 SXM5 80 GB at its
full 700 W board power: 989 TFLOP/s bf16 dense tensor-core throughput
(``PEAK_FLOPS_BF16``) and 3.35 TB/s of HBM3 (``HBM_BW``).  A card run below
700 W does not reach them.  Collectives are charged against one link's
bandwidth, the conservative end: the cross-node figure, one 400 Gb/s
InfiniBand NDR port a GPU, 50e9 B/s (``LINK_BW``).  Inside one node the
GPUs meet over NVLink 4 at 450 GB/s each way (``NVLINK_BW``, named here,
not charged): a mesh of 256 or 512 ranks spans 32 or 64 eight-GPU nodes,
and its ring collectives run at the slowest hop.

The formulas for the hand-written kernels (:func:`k1_cost` ..
:func:`k4_cost`) are what an abstract launch (``kernels/abstract.py``)
records in a dry run, and what ``chip_smoke.py`` multiplies by a real
launch count: FlopCounterMode cannot see a ctypes launch, so both sides
count a kernel by its formula.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from functools import lru_cache

PEAK_FLOPS_BF16 = 989e12   # FLOP/s per GPU, bf16 dense (H100 SXM5 data sheet)
HBM_BW = 3.35e12           # bytes/s per GPU, HBM3 (data sheet)
LINK_BW = 50e9             # bytes/s per GPU: one 400 Gb/s NDR port
NVLINK_BW = 450e9          # bytes/s each way per GPU inside a node (NVLink 4)
HBM_BYTES = 80e9           # device memory per GPU (H100 80 GB)


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float          # per rank: aten FLOPs + the kernels' formulas
    hlo_bytes: float          # per rank: the step's bytes (dry run's count)
    collective_bytes: float   # per rank: wire bytes of the counted collectives
    model_flops: float        # 6*N*D (dense) / 6*N_active*D (MoE), per rank
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_flop_ratio: float = 0.0   # MODEL_FLOPS / traced FLOPs
    step_time_s: float = 0.0         # max of the three terms (no overlap)
    mfu: float = 0.0                 # model_flops / (step_time * peak)
    note: str = ""

    def finalize(self) -> "RooflineReport":
        self.compute_s = self.hlo_flops / PEAK_FLOPS_BF16
        self.memory_s = self.hlo_bytes / HBM_BW
        self.collective_s = self.collective_bytes / LINK_BW
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        self.dominant = max(terms, key=terms.get)
        self.useful_flop_ratio = (
            self.model_flops / self.hlo_flops if self.hlo_flops else 0.0
        )
        self.step_time_s = max(terms.values())
        self.mfu = (
            self.model_flops / (self.step_time_s * PEAK_FLOPS_BF16)
            if self.step_time_s
            else 0.0
        )
        return self

    def row(self) -> dict:
        return asdict(self)


def ota_fused_cost(
    n_params: int,
    n_agents: int,
    *,
    wire_bytes: int = 4,
    with_noise: bool = True,
    mode: str = "sgd",
) -> dict:
    """Analytic flop/byte estimate for the fused OTA aggregation kernel (K1,
    ``kernels/ota_fused.py``) against the unfused op chain.

    The fused kernel streams the (N, P) gradient stack once and writes one
    P-vector (plus the optimizer state it updates in the same pass); the
    unfused chain also materialises the weighted sum, the sampled noise
    tensor and the scaled update as separate HBM round trips.  Per
    element: 2N flops for the gain matvec, ~25 for the counter-PRNG
    Box-Muller draw, and a handful for scale/update.

    Returns ``flops``, ``fused_bytes``, ``xla_bytes`` (the unfused chain's),
    ``fused_s`` / ``xla_s`` (HBM-bound times at the H100's 3.35 TB/s),
    ``compute_s`` and ``speedup_est``.
    """
    p = float(n_params)
    n = float(n_agents)
    state = {"agg": 0, "sgd": 1, "adam": 3}[mode]  # extra P-vectors touched
    flops = p * (2.0 * n + (25.0 if with_noise else 0.0)
                 + {"agg": 1, "sgd": 3, "adam": 12}[mode])
    # fused: read the wire-format stack once, read+write each state vector
    fused_bytes = p * n * wire_bytes + p * 4.0 * (1.0 + 2.0 * state)
    # unfused chain: gain-weighted reduce (read stack, write sum), noise
    # materialise (write + read), add (read sum, write), scale (read,
    # write), then the update's read-modify-write per state vector
    xla_bytes = (
        p * n * 4.0                     # read fp32 stack for the reduce
        + p * 4.0 * 2.0                 # write sum + re-read for noise add
        + (p * 4.0 * 2.0 if with_noise else 0.0)   # noise write + read
        + p * 4.0 * 2.0                 # scale pass
        + p * 4.0 * 2.0 * max(state, 1)  # update read-modify-write
    )
    fused_s = fused_bytes / HBM_BW
    xla_s = xla_bytes / HBM_BW
    return {
        "n_params": int(n_params),
        "n_agents": int(n_agents),
        "mode": mode,
        "wire_bytes": int(wire_bytes),
        "flops": flops,
        "fused_bytes": fused_bytes,
        "xla_bytes": xla_bytes,
        "fused_s": fused_s,
        "xla_s": xla_s,
        "compute_s": flops / PEAK_FLOPS_BF16,
        "speedup_est": xla_s / fused_s if fused_s else 0.0,
    }


def model_flops_per_step(
    *,
    n_params_active: int,
    tokens: int,
    training: bool,
) -> float:
    """The classic 6ND (train) / 2ND (inference fwd) useful-FLOPs estimate.

    ``n_params_active``: for MoE, embedding+attn+router plus top_k experts'
    FFN params; for dense, all params. ``tokens``: tokens processed this step
    (decode = batch * 1).
    """
    mult = 6.0 if training else 2.0
    return mult * float(n_params_active) * float(tokens)


# ---------------------------------------------------------------------------
# The hand-written kernels' formulas (one launch each): (flops, bytes)
# ---------------------------------------------------------------------------

def k1_cost(n_params: int, n_agents: int, *, wire_bytes: int,
            with_noise: bool, mode: str, lanes: int = 1,
            shared_stack: bool = False, map_bytes: int = 0):
    """K1 (``csrc/ota_fused.cu``): ``lanes`` times :func:`ota_fused_cost`'s
    ``flops`` and ``fused_bytes``; a stack shared by every lane is read
    once, and a counter map's table (``map_bytes``) is read once.  Returns
    ``(flops, bytes)``."""
    one = ota_fused_cost(n_params, n_agents, wire_bytes=wire_bytes,
                         with_noise=with_noise, mode=mode)
    nbytes = lanes * one["fused_bytes"] + map_bytes
    if shared_stack:
        nbytes -= (lanes - 1) * float(n_params) * n_agents * wire_bytes
    return lanes * one["flops"], nbytes


def k2_cost(numel: int, itemsize: int, *, with_noise: bool):
    """K2 (``csrc/ota_channel.cu``), elementwise ``(v + sigma n) / (N m_h)``:
    per element ~25 flops for the counter-PRNG Box-Muller draw (as in
    :func:`ota_fused_cost`), one multiply-add and one scale with noise,
    one scale without; ``v`` read once and the output written once.
    Returns ``(flops, bytes)``."""
    per = 27.0 if with_noise else 1.0
    return float(numel) * per, 2.0 * numel * itemsize


@lru_cache(maxsize=None)
def visible_pairs(sq: int, sk: int, *, causal: bool, window=None) -> int:
    """The (query, key) pairs a mask leaves visible when the ``sq`` queries
    sit at positions ``sk - sq .. sk - 1`` of ``sk`` keys at ``0 .. sk -
    1`` (a prefill's ``arange``; ``sq == sk`` there): a key at ``k`` is
    visible from ``q`` when ``k <= q`` (causal) and ``k > q - window``
    (``ref.visible``)."""
    total = 0
    for q in range(sk - sq, sk):
        lo = 0 if window is None else max(0, q - window + 1)
        hi = q + 1 if causal else sk
        total += max(0, min(hi, sk) - lo)
    return total


def k3_cost(b: int, h: int, hkv: int, sq: int, sk: int, dh: int,
            itemsize: int, *, causal: bool, window=None):
    """K3 (``csrc/flash_attention{,_wgmma}.cu``): ``4 B H Dh`` flops per
    visible (q, k) pair (``q.k`` and ``p.v``, a multiply-add each per head
    dim; :func:`visible_pairs`); q, k, v read once and the output written
    once.  Returns ``(flops, bytes)``."""
    flops = 4.0 * b * h * dh * visible_pairs(sq, sk, causal=causal,
                                             window=window)
    nbytes = float(itemsize) * dh * (2 * b * h * sq + 2 * b * hkv * sk)
    return flops, nbytes


def k4_cost(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
            itemsize: int, *, tensor_cores: bool):
    """K4 (``csrc/ssd_scan_tc.cu``, ``csrc/ssd_scan.cu``): the chunked
    scan's products as the kernels' loops run them.  Over ``nc =
    ceil(S / Q)`` chunks of ``Q = min(chunk, S)`` steps (the padded tail
    included), for each (batch, head, chunk), with ``T = t (t + 1) / 2``
    the 16 x 16 tiles at or below the diagonal of a ``Q x Q`` block (``t =
    ceil(Q / 16)``):

        C.B^T          2 * 256 N T        (once per block of P columns)
        (C.B^T o decay o dt) . x   2 * 256 P T
        C . S          2 Q N P
        B^T (w o x)    2 Q N P            (the state update)

    The tensor-core kernel runs a block per 16 state columns, so ``C.B^T``
    is formed ``P / 16`` times, and the three products with an f32 operand
    are three bf16 passes each (the hi/mid/lo split); the f32 kernel forms
    ``C.B^T`` once and makes one pass.  Elementwise work (the decays, the
    prefix sums) is not counted.  Bytes: x, B and C in their dtype, dt and
    A in float32 read once, y in float32 written once.  Returns ``(flops,
    bytes)``."""
    q = min(chunk, s)
    nc = -(-s // q)
    t = -(-q // 16)
    tiles = t * (t + 1) // 2
    cb_times = -(-p // 16) if tensor_cores else 1
    passes = 3 if tensor_cores else 1
    per = (cb_times * 2.0 * 256 * n * tiles
           + passes * (2.0 * 256 * p * tiles + 4.0 * q * n * p))
    flops = float(b) * h * nc * per
    nbytes = (float(itemsize) * (b * s * h * p + 2 * b * s * g * n)
              + 4.0 * (b * s * h + h) + 4.0 * b * s * h * p)
    return flops, nbytes
