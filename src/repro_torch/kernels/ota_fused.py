"""Wrapper of K1, the hand-written CUDA kernel for the fused OTA uplink.

Counterpart of ``repro/kernels/ota_fused.py``: the same four entry points
with the same signatures, minus ``interpret`` and ``block_rows`` (the TPU's
VMEM blocking has no counterpart), plus ``threads`` (the CUDA block size of
the wide body, which the result does not depend on).  The kernel itself is
``csrc/ota_fused.cu``; its plain PyTorch version is ``kernels/ref.py``.

Dispatch is by the device of the gradient stack:

* a CPU tensor takes the plain version (the counter PRNG then the op-for-op
  fold of ``ref.ota_fused_ref``), which is how the CPU tests reach it;
* a CUDA tensor is checked (device, dtype, shape, contiguity, and what the
  chosen body needs) and launched on PyTorch's current stream, or the call
  raises.  There is no fallback.

K1 has two bodies, both the same strict sequential fold over agents, so
both are bitwise the plain version (agg) and bitwise each other in every
mode; :func:`k1_body` picks one from the shapes and the wire dtype alone:

* ``"wide"`` (the port's first body): one thread per parameter element;
  it takes every shape and wins where A is small or P wide (the paper's
  width, the streamed fold blocks of up to 32 agents, (8, 2^21));
* ``"tall"``: one block per lane folds the whole parameter row, fed by a
  ring of bulk asynchronous copies into shared memory; for large fleets at
  a small d (:func:`k1_body`).  It needs a 16-byte-aligned stack (pointer
  and lane stride) and P <= ``TALL_MAX_PARAMS``; the rule sees the pointer
  and the lane stride, so it gives an unaligned stack (a sliced view) to the
  wide body before launch.  A body that was forced on a stack it cannot
  take raises (:func:`check_body`); nothing goes to the other body after
  the choice.

To time one body against the other on the same inputs, patch
``k1_body`` (``unittest.mock.patch.object(ota_fused, "k1_body", lambda
*a, **k: "tall")``), as ``chip_smoke.py`` does.

``rescale`` (``fused_aggregate``, ``fused_aggregate_sgd``,
``fused_server_pass``) is an optional one-element float32 tensor on the
gradients' device that multiplies ``scale``: the kernel forms
``float32(scale) * rescale`` in float32 and scales by that, so a normaliser
computed on the card (the round service's ``N / W``) reaches the kernel
without a host synchronisation.  ``None`` leaves the bits unchanged.

Lanes: ``fused_aggregate_lanes`` and ``fused_aggregate_sgd_lanes`` run L
independent uplinks in one launch (lane = ``blockIdx.y`` of either body),
the counterpart of ``jax.vmap`` over the JAX kernel, whose batching rule
folds the lane axis into the Pallas grid.  They are twins rather than a
leading axis on the one-lane functions, because a lane takes its sigma,
scale, alpha and seed as per-lane device arrays where the one-lane round
passes host scalars by value (no host-to-device copy a round), and because
the JAX one-lane function refuses a 3-D stack.  Each lane is bitwise a
one-lane launch of the same body.  The lane-batched run
(``core/lanes.py``, behind ``fedpg.monte_carlo`` and ``sweep(mode=
"vmap")``) launches it once a round, with the lanes' sigma, scale, step
size and seed as device arrays made once per run.

Counter maps: ``fused_aggregate(..., counter_map=)`` draws the noise of
element ``j`` of the row at a counter given by a :class:`CounterMap`, a
table of segments (one a leaf shard of a sharded gradient: its offset in
the row, its base counter and up to four local sizes with their global
strides) in place of ``j`` itself, so a rank's row of shards takes the
noise the unsharded gradient's row takes at the same elements.  It runs
the wide body's mapped instance (agg mode, one lane); the map is checked
on the host when it is made (its segments tile the row, each segment's
sizes and strides fit 32 bits), and a launch with no map is the unmapped
one, bit for bit.  A counter is taken modulo 2^32, as the JAX package's
uint32 counter wraps (``start.astype(uint32) + pos`` in its
``_counter_noise``): element ``j >= 2^32`` of a gradient of more than
2^32 elements (zamba2-7b at full depth, 6.75e9) draws the noise of
``j mod 2^32`` there, and so it does here on the rank holding it.

``LAUNCHES_WIDE`` and ``LAUNCHES_TALL`` count each body's kernel launches
(one per call that reaches the card), so a run can show that its rounds
went through the kernel, and which body.  ``LAUNCHES`` is always their sum:
it counts K1 as one kernel for the callers that do not ask which body.
``LAUNCHES_MAPPED`` counts the wide launches that took a counter map.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import build, ref

LAUNCHES = 0
LAUNCHES_WIDE = 0
LAUNCHES_TALL = 0
LAUNCHES_MAPPED = 0

BODIES = ("wide", "tall")
TALL_MAX_PARAMS = 1984        # csrc/ota_fused.cu kTallMaxParams
TALL_MIN_AGENTS = 48          # the rule: the crossover in A at P = 165
TALL_RULE_MAX_PARAMS = 512    # the rule: the widest P it gives the tall body
MAX_LANES = 65535             # grid y
TALL_INDEX_LIMIT = 2 ** 31    # the tall body narrows P to int (ota_fused.cu)

_MODES = {"agg": 0, "sgd": 1, "adam": 2}
_WIRE_DTYPES = (torch.float32, torch.bfloat16)
_MAX_PARAMS = 2 ** 32 - 1     # the noise counter is a uint32 flat index
_BOUND = False

Seed = Union[int, torch.Tensor]
Lanes = Union[float, Sequence[float], torch.Tensor]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/ota_fused.cu``."""
    vp, f, i, ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, \
        ctypes.c_longlong
    lib.ota_fused_launch.argtypes = (
        [i, i, i, i, vp, vp, i, i, ctypes.c_ulonglong, ll, ll, ll]
        + [vp] * 6 + [f] * 8 + [vp] * 4 + [ctypes.c_uint, vp, i, vp])
    lib.ota_fused_launch.restype = i
    lib.ota_counter_bits_launch.argtypes = [
        ctypes.c_ulonglong, vp, ctypes.c_uint, vp, vp, i, vp]
    lib.ota_counter_bits_launch.restype = i
    lib.ota_fused_mapped_launch.argtypes = (
        [i, i, vp, vp, i, ctypes.c_ulonglong, vp, f, f, vp, ctypes.c_uint,
         vp, vp, i, i, vp])
    lib.ota_fused_mapped_launch.restype = i
    return lib


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = build.load("ota_fused")
    if not _BOUND:
        bind(lib)
        _BOUND = True
    return lib


def _elem(wire_dtype) -> int:
    return 2 if wire_dtype == torch.bfloat16 else 4


def k1_body(n_agents: int, n_params: int, wire_dtype=torch.float32,
            lanes: int = 1, data_ptr: int = 0) -> str:
    """The body of K1 that takes a CUDA (A, P) stack at address
    ``data_ptr``, from shapes, the wire dtype and the pointer alone:
    ``"tall"`` for a large fleet at a small d (P <= ``TALL_RULE_MAX_PARAMS``
    and A >= max(``TALL_MIN_AGENTS``, P / 4)), ``"wide"`` otherwise.  The
    bounds are the H100 sweep's (``PERF.md``): the tall body wins from A =
    48 at P = 165 and from A = 128 at P = 500; at P = 1000 only at A = 10^4
    of the sizes swept, which no path reaches, so the rule leaves wider P
    to the wide body.  The tall body copies 16-byte tiles, so a stack whose
    pointer is not 16-byte aligned (a sliced view) goes wide, and with
    several lanes so does one whose lanes do not each start a multiple of
    16 bytes after the last (A * P * wire bytes), as the rule cannot see
    whether the lanes share one stack.  A row of 2^31 elements or more
    (an LLM's flat gradient) is wide as every P past
    ``TALL_RULE_MAX_PARAMS`` is: the wide body's index is 64-bit, and
    :func:`check_body` refuses such a row to the tall body, whose index is
    an ``int``."""
    if n_params > TALL_RULE_MAX_PARAMS \
            or n_agents < max(TALL_MIN_AGENTS, n_params / 4):
        return "wide"
    if data_ptr % 16:
        return "wide"
    if lanes > 1 and (n_agents * n_params * _elem(wire_dtype)) % 16:
        return "wide"
    return "tall"


def check_body(body: str, n_agents: int, n_params: int, wire_dtype, *,
               data_ptr: int = 0, lane_stride: int = 0,
               lanes: int = 1) -> None:
    """Raise ``ValueError`` if ``body`` cannot take this CUDA stack: the
    tall body needs P <= ``TALL_MAX_PARAMS`` and a 16-byte-aligned pointer
    and lane stride (elements); both need 1 <= lanes <= ``MAX_LANES``."""
    if body not in BODIES:
        raise ValueError(f"K1 has no body {body!r}; bodies: {BODIES}")
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"{lanes} lanes out of range (1 .. {MAX_LANES})")
    if body == "wide":
        return
    elem = _elem(wire_dtype)
    if n_params >= TALL_INDEX_LIMIT:
        raise ValueError(f"K1's tall body indexes the row with an int: P = "
                         f"{n_params} >= 2^31 is refused, not narrowed")
    if n_params > TALL_MAX_PARAMS:
        raise ValueError(f"K1's tall body takes P <= {TALL_MAX_PARAMS}, got "
                         f"(A, P) = ({n_agents}, {n_params})")
    if data_ptr % 16 or (lane_stride * elem) % 16:
        raise ValueError(
            f"K1's tall body copies 16-byte tiles: the stack's pointer "
            f"(offset {data_ptr % 16} bytes from 16) and lane stride "
            f"({lane_stride} elements) must be 16-byte aligned; pass a "
            f"fresh copy (clone())")


def _check_threads(threads: int) -> None:
    if not (32 <= threads <= 1024 and threads % 32 == 0):
        raise ValueError(f"threads must be a multiple of 32 in [32, 1024], "
                         f"got {threads}")


def _seed_args(seed: Seed, device: torch.device):
    """(pointer, value) kernel arguments: a device int64 seed is read by the
    kernel itself (no host sync); anything else is passed by value."""
    if isinstance(seed, torch.Tensor) and seed.device == device:
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError("a device seed must be one int64 element, got "
                             f"{seed.dtype} {tuple(seed.shape)}")
        return seed.data_ptr(), 0
    return None, int(seed) & ref.MASK32


def _check_vector(name: str, x: torch.Tensor, shape: Tuple[int, ...],
                  device: torch.device) -> None:
    if x.device != device or x.dtype != torch.float32 \
            or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 {shape} tensor "
                         f"on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def _check_rescale(rescale: Optional[torch.Tensor], device: torch.device,
                   n: int = 1) -> None:
    if rescale is not None and (rescale.device != device
                                or rescale.dtype != torch.float32
                                or rescale.numel() != n
                                or not rescale.is_contiguous()):
        raise ValueError(f"rescale must be {n} contiguous float32 element(s) "
                         f"on {device}, got {rescale.dtype} "
                         f"{tuple(rescale.shape)} on {rescale.device}")


def _launch(mode: str, grads: torch.Tensor, gains: torch.Tensor,
            states: Sequence[torch.Tensor], *, with_noise: bool, seed: Seed,
            sigma=0.0, scale=1.0, alpha=0.0, b1=0.0, b2=0.0, c1=1.0, c2=1.0,
            eps=0.0, rescale: Optional[torch.Tensor] = None,
            threads: int = 256, lanes: int = 0,
            per_lane: Optional[dict] = None) -> Tuple[torch.Tensor, ...]:
    """Validate the CUDA operands, allocate the outputs, launch K1.

    ``lanes=0`` is a one-lane call on an (A, P) stack with (P,) outputs.
    With ``lanes=L`` the stack is (A, P) shared or (L, A, P), the gains (A,)
    or (L, A), each state (P,) or (L, P), the outputs (L, P), and
    ``per_lane`` may hold contiguous device arrays of L values under
    ``sigma``, ``scale``, ``alpha`` (float32) and ``seed`` (int64);
    ``rescale`` then has L elements."""
    global LAUNCHES, LAUNCHES_WIDE, LAUNCHES_TALL
    dev = grads.device
    if grads.dtype not in _WIRE_DTYPES or not grads.is_contiguous():
        raise ValueError(f"grads must be contiguous float32 or bfloat16, got "
                         f"{grads.dtype} (contiguous={grads.is_contiguous()})")
    n_agents, n_params = grads.shape[-2:]
    if n_agents < 1 or not 0 < n_params <= _MAX_PARAMS:
        raise ValueError(f"grads shape {tuple(grads.shape)} out of range "
                         f"(1 <= A, 0 < P < 2^32)")
    _check_threads(threads)
    n_lanes = max(lanes, 1)
    if not lanes and grads.ndim != 2:
        raise ValueError(f"grads must be (n_agents, n_params), got "
                         f"{tuple(grads.shape)}")
    # one lane reads only lane 0: its stride is never stepped
    g_lane = n_agents * n_params if grads.ndim == 3 and n_lanes > 1 else 0
    h_lane = n_agents if lanes and gains.ndim == 2 else 0
    _check_vector("gains", gains,
                  (n_lanes, n_agents) if h_lane else (n_agents,), dev)
    state_lane = 0
    for name, x in zip(("params", "mu", "nu"), states):
        state_lane = n_params if lanes and x.ndim == 2 else 0
        _check_vector(name, x, (n_lanes, n_params) if state_lane
                      else (n_params,), dev)
    if len({x.ndim for x in states}) > 1:
        raise ValueError("params, mu and nu must all be shared or all per "
                         "lane")
    _check_rescale(rescale, dev, n_lanes)
    body = k1_body(n_agents, n_params, grads.dtype, n_lanes,
                   data_ptr=grads.data_ptr())
    check_body(body, n_agents, n_params, grads.dtype,
               data_ptr=grads.data_ptr(), lane_stride=g_lane, lanes=n_lanes)
    per_lane = per_lane or {}
    ptrs = {}
    for name, dtype in (("sigma", torch.float32), ("scale", torch.float32),
                        ("alpha", torch.float32), ("seed", torch.int64)):
        x = per_lane.get(name)
        if x is not None:
            if x.device != dev or x.dtype != dtype or x.shape != (n_lanes,) \
                    or not x.is_contiguous():
                raise ValueError(f"per-lane {name} must be a contiguous "
                                 f"{dtype} ({n_lanes},) tensor on {dev}")
            ptrs[name] = x.data_ptr()
    out_shape = (n_lanes, n_params) if lanes else (n_params,)
    n_out = 3 if mode == "adam" else 1
    outs = [torch.empty(out_shape, dtype=torch.float32, device=dev)
            for _ in range(n_out)]
    state_ptrs = [x.data_ptr() for x in states] + [None] * (3 - len(states))
    out_ptrs = [x.data_ptr() for x in outs] + [None] * (3 - n_out)
    if "seed" in ptrs:
        seed_ptr, seed_val = ptrs["seed"], 0
    else:
        seed_ptr, seed_val = _seed_args(seed, dev)
    with torch.cuda.device(dev):   # the launch goes to the current device
        rc = _lib().ota_fused_launch(
            BODIES.index(body), _MODES[mode],
            int(grads.dtype == torch.bfloat16), int(with_noise),
            grads.data_ptr(), gains.data_ptr(), n_lanes, n_agents, n_params,
            g_lane, h_lane, state_lane, *state_ptrs, *out_ptrs,
            *(float(x) for x in (sigma, scale, alpha, b1, b2, c1, c2, eps)),
            ptrs.get("sigma"), ptrs.get("scale"), ptrs.get("alpha"),
            seed_ptr, seed_val,
            None if rescale is None else rescale.data_ptr(), threads,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ota_fused kernel launch failed ({body} body): "
                           f"cudaError {rc}")
    if body == "tall":
        LAUNCHES_TALL += 1
    else:
        LAUNCHES_WIDE += 1
    LAUNCHES += 1
    return tuple(outs)


class CounterMap:
    """K1's noise addressing for a row made of pieces of a larger one
    (module docstring).  ``segments``: ``(offset in the row, base counter,
    sizes, strides)`` per piece, ``sizes``/``strides`` up to
    ``ref.MAP_DIMS`` each (row-major, the last fastest); the element at
    ``offset + r``, ``r`` the row-major index ``(i_0, ..)`` of ``sizes``,
    draws the noise of counter ``base + sum_d i_d * strides[d]`` modulo
    2^32 (module docstring).  Raises ``ValueError`` unless the segments, in
    order, tile ``[0, n)`` with no gap or overlap, and each segment's
    sizes, strides and element count are below 2^32 (the kernel's 32-bit
    arithmetic).  The table goes to a device once per device
    (``table``)."""

    def __init__(self, segments: Sequence[Tuple[int, int, Sequence[int],
                                                Sequence[int]]]):
        rows, end = [], 0
        for off, base, sizes, strides in segments:
            if len(sizes) != len(strides) or not 0 < len(sizes) \
                    <= ref.MAP_DIMS:
                raise ValueError(f"a segment takes 1..{ref.MAP_DIMS} sizes "
                                 f"with as many strides, got {sizes} and "
                                 f"{strides}")
            if off != end:
                raise ValueError(f"counter map: a segment starts at {off}, "
                                 f"the row is covered up to {end} (the "
                                 f"segments overlap or leave a gap)")
            if min(sizes) < 1 or min(strides) < 0 or base < 0:
                raise ValueError(f"counter map: bad segment "
                                 f"{(off, base, sizes, strides)}")
            wide = max(list(strides) + [math.prod(sizes)])
            if wide > ref.MASK32:
                raise ValueError(f"counter map: a segment of {sizes} with "
                                 f"strides {strides}: {wide} >= 2^32")
            pad = ref.MAP_DIMS - len(sizes)
            rows.append([off, base] + [1] * pad + list(sizes)
                        + [0] * pad + list(strides))
            end = off + math.prod(sizes)
        if not rows:
            raise ValueError("counter map: no segments")
        self.n = end
        self.host = torch.tensor(rows, dtype=torch.int64)
        self._on: dict = {}

    def __len__(self) -> int:
        return self.host.shape[0]

    def table(self, device) -> torch.Tensor:
        """The ``(segments, ref.MAP_COLS)`` int64 table on ``device``."""
        dev = torch.device(device)
        if dev not in self._on:
            self._on[dev] = self.host.to(dev)
        return self._on[dev]

    def counters(self, device) -> torch.Tensor:
        """Each row element's counter (``ref.counter_map_index``)."""
        return ref.counter_map_index(self.table(device), self.n)


def _prep(grads: torch.Tensor, gains: torch.Tensor, wire_dtype):
    if grads.ndim != 2:
        raise ValueError(f"grads must be (n_agents, n_params), got "
                         f"{tuple(grads.shape)}")
    if gains.device != grads.device:
        raise ValueError(f"gains on {gains.device}, grads on {grads.device}")
    if wire_dtype is not None:
        grads = grads.to(wire_dtype)
    return grads


def _noise(with_noise: Optional[bool], seed: Seed, grads: torch.Tensor,
           counter_map: Optional[CounterMap] = None):
    """The plain version's noise realisation, or None."""
    if with_noise is False:
        return None
    if counter_map is not None:
        return ref.counter_noise_at(seed, counter_map.counters(grads.device))
    return ref.counter_noise(seed, grads.shape[-1], grads.device)


def fused_aggregate(grads: torch.Tensor, gains: torch.Tensor, *, sigma=0.0,
                    scale=1.0, seed: Seed = 0,
                    with_noise: Optional[bool] = None, wire_dtype=None,
                    rescale: Optional[torch.Tensor] = None,
                    counter_map: Optional[CounterMap] = None,
                    threads: int = 256) -> torch.Tensor:
    """u = (sum_i h_i g_i + sigma*n) * scale, fused; returns (P,) float32.
    ``rescale`` multiplies ``scale`` on the device; ``counter_map`` (a
    :class:`CounterMap` of P elements) addresses the noise (module
    docstring)."""
    grads = _prep(grads, gains, wire_dtype)
    if counter_map is not None and counter_map.n != grads.shape[1]:
        raise ValueError(f"the counter map covers {counter_map.n} elements, "
                         f"the row has {grads.shape[1]}")
    if not grads.is_cuda:
        return ref.ota_fused_ref(grads, gains,
                                 _noise(with_noise, seed, grads, counter_map),
                                 sigma=sigma, scale=scale, rescale=rescale)
    if counter_map is not None:
        return _launch_mapped(grads, gains, counter_map,
                              with_noise=with_noise is not False, seed=seed,
                              sigma=sigma, scale=scale, rescale=rescale,
                              threads=threads)
    (out,) = _launch("agg", grads, gains, (), with_noise=with_noise is not False,
                     seed=seed, sigma=sigma, scale=scale, rescale=rescale,
                     threads=threads)
    return out


def _launch_mapped(grads: torch.Tensor, gains: torch.Tensor,
                   counter_map: CounterMap, *, with_noise: bool, seed: Seed,
                   sigma, scale, rescale: Optional[torch.Tensor],
                   threads: int) -> torch.Tensor:
    """K1's wide body in agg mode, one lane, its noise at the map's
    counters: validate, allocate, launch."""
    global LAUNCHES, LAUNCHES_WIDE, LAUNCHES_MAPPED
    dev = grads.device
    if grads.dtype not in _WIRE_DTYPES or not grads.is_contiguous():
        raise ValueError(f"grads must be contiguous float32 or bfloat16, got "
                         f"{grads.dtype} (contiguous={grads.is_contiguous()})")
    n_agents, n_params = grads.shape
    if n_agents < 1 or not 0 < n_params <= _MAX_PARAMS:
        raise ValueError(f"grads shape {tuple(grads.shape)} out of range "
                         f"(1 <= A, 0 < P < 2^32)")
    _check_threads(threads)
    _check_vector("gains", gains, (n_agents,), dev)
    _check_rescale(rescale, dev)
    table = counter_map.table(dev)
    out = torch.empty(n_params, dtype=torch.float32, device=dev)
    seed_ptr, seed_val = _seed_args(seed, dev)
    with torch.cuda.device(dev):
        rc = _lib().ota_fused_mapped_launch(
            int(grads.dtype == torch.bfloat16), int(with_noise),
            grads.data_ptr(), gains.data_ptr(), n_agents, n_params,
            out.data_ptr(), float(sigma), float(scale), seed_ptr, seed_val,
            None if rescale is None else rescale.data_ptr(),
            table.data_ptr(), len(counter_map), threads,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ota_fused mapped launch failed: cudaError {rc}")
    LAUNCHES_WIDE += 1
    LAUNCHES_MAPPED += 1
    LAUNCHES += 1
    return out


def fused_aggregate_sgd(grads: torch.Tensor, gains: torch.Tensor,
                        params: torch.Tensor, *, alpha, sigma=0.0, scale=1.0,
                        seed: Seed = 0, with_noise: Optional[bool] = None,
                        wire_dtype=None, rescale: Optional[torch.Tensor] = None,
                        threads: int = 256) -> torch.Tensor:
    """p' = p - alpha * u with u the fused OTA update; (P,) float32."""
    grads = _prep(grads, gains, wire_dtype)
    if not grads.is_cuda:
        return ref.ota_fused_sgd_ref(grads, gains, params,
                                     _noise(with_noise, seed, grads),
                                     alpha=alpha, sigma=sigma, scale=scale,
                                     rescale=rescale)
    (out,) = _launch("sgd", grads, gains, (params,),
                     with_noise=with_noise is not False, seed=seed,
                     sigma=sigma, scale=scale, alpha=alpha, rescale=rescale,
                     threads=threads)
    return out


def fused_server_pass(v: torch.Tensor, *, sigma=0.0, scale=1.0,
                      seed: Seed = 0, with_noise: Optional[bool] = None,
                      alpha=None, params: Optional[torch.Tensor] = None,
                      rescale: Optional[torch.Tensor] = None,
                      threads: int = 256) -> torch.Tensor:
    """The server tail over an already-accumulated superposition ``v``:
    AWGN + debias, and the SGD step when ``params`` (and ``alpha``) are
    given.  ``v`` is one unit-gain agent row with no wire-dtype hop, and the
    noise is keyed on the absolute index, so it equals the one-shot draw."""
    flat = v.float().reshape(1, -1).contiguous()
    ones = torch.ones(1, dtype=torch.float32, device=flat.device)
    if params is None:
        return fused_aggregate(flat, ones, sigma=sigma, scale=scale,
                               seed=seed, with_noise=with_noise,
                               rescale=rescale, threads=threads)
    if alpha is None:
        raise ValueError("fused_server_pass with params needs alpha")
    return fused_aggregate_sgd(flat, ones, params, alpha=alpha, sigma=sigma,
                               scale=scale, seed=seed, with_noise=with_noise,
                               rescale=rescale, threads=threads)


def fused_aggregate_adam(grads: torch.Tensor, gains: torch.Tensor,
                         params: torch.Tensor, mu: torch.Tensor,
                         nu: torch.Tensor, *, alpha, step, b1: float = 0.9,
                         b2: float = 0.999, eps: float = 1e-8, sigma=0.0,
                         scale=1.0, seed: Seed = 0,
                         with_noise: Optional[bool] = None, wire_dtype=None,
                         threads: int = 256):
    """Aggregation + bias-corrected Adam in one pass: (p', mu', nu').  The
    corrections ``1 - b^t`` are computed in float32, as the JAX wrapper
    does."""
    grads = _prep(grads, gains, wire_dtype)
    if not grads.is_cuda:
        return ref.ota_fused_adam_ref(
            grads, gains, params, mu, nu, _noise(with_noise, seed, grads),
            alpha=alpha, step=step, b1=b1, b2=b2, eps=eps, sigma=sigma,
            scale=scale)
    c1, c2 = ref.adam_bias_corrections(b1, b2, step)
    return _launch("adam", grads, gains, (params, mu, nu),
                   with_noise=with_noise is not False, seed=seed, sigma=sigma,
                   scale=scale, alpha=alpha, b1=b1, b2=b2, c1=c1, c2=c2,
                   eps=eps, threads=threads)


# ---------------------------------------------------------------------------
# Lanes: L independent uplinks in one launch (jax.vmap of the JAX kernel)
# ---------------------------------------------------------------------------

def _is_lanes(x) -> bool:
    """Whether a per-lane argument holds one value per lane."""
    if isinstance(x, torch.Tensor):
        return x.ndim == 1
    return isinstance(x, (list, tuple))


def _n_lanes(grads, gains, params, scalars, rescale) -> int:
    counts = set()
    if grads.ndim == 3:
        counts.add(grads.shape[0])
    if gains.ndim == 2:
        counts.add(gains.shape[0])
    if params is not None and params.ndim == 2:
        counts.add(params.shape[0])
    for x in scalars:
        if _is_lanes(x):
            counts.add(len(x))
    if rescale is not None and rescale.numel() != 1:
        counts.add(rescale.numel())
    if len(counts) > 1:
        raise ValueError(f"the lane-batched operands disagree on the lane "
                         f"count: {sorted(counts)}")
    return counts.pop() if counts else 1


def _lane_values(x, n: int) -> list:
    """A per-lane argument as a list of n Python numbers or seeds."""
    if isinstance(x, torch.Tensor):
        return (list(x.reshape(-1)) if x.ndim == 1
                else [x.reshape(())] * n)
    return list(x) if _is_lanes(x) else [x] * n


def _lane_array(x, n: int, dtype, device) -> Optional[torch.Tensor]:
    """A contiguous (n,) device array of a per-lane argument, or None when
    every lane shares one host number (passed by value)."""
    if isinstance(x, torch.Tensor):
        if x.ndim > 1 or (x.ndim == 1 and x.numel() != n):
            raise ValueError(f"a per-lane argument must be a scalar or {n} "
                             f"values, got {tuple(x.shape)}")
        return x.to(device=device, dtype=dtype).reshape(-1).expand(n) \
            .contiguous()
    if _is_lanes(x):
        vals = [int(v) & ref.MASK32 for v in x] if dtype == torch.int64 \
            else [float(v) for v in x]
        return torch.tensor(vals, dtype=dtype, device=device)
    return None


def _prep_lanes(grads, gains, wire_dtype):
    if grads.ndim not in (2, 3) or gains.ndim not in (1, 2):
        raise ValueError(f"lanes take grads (A, P) or (L, A, P) and gains "
                         f"(A,) or (L, A), got {tuple(grads.shape)} and "
                         f"{tuple(gains.shape)}")
    if gains.device != grads.device:
        raise ValueError(f"gains on {gains.device}, grads on {grads.device}")
    if wire_dtype is not None:
        grads = grads.to(wire_dtype)
    return grads


def _plain_lanes(mode, grads, gains, params, n, *, sigma, scale, seed,
                 with_noise, alpha, rescale):
    """The plain version on the CPU: ``ref``'s per-lane loop."""
    p_dim = grads.shape[-1]
    seeds = _lane_values(seed, n)
    noise = None if with_noise is False else torch.stack(
        [ref.counter_noise(s, p_dim, grads.device) for s in seeds])
    kw = dict(sigma=[float(v) for v in _lane_values(sigma, n)],
              scale=[float(v) for v in _lane_values(scale, n)],
              rescale=None if rescale is None
              else rescale.reshape(-1).expand(n))
    g = grads.expand((n,) + tuple(grads.shape[-2:]))
    h = gains.expand((n, gains.shape[-1]))
    if mode == "agg":
        return ref.ota_fused_lanes_ref(g, h, noise, **kw)
    return ref.ota_fused_sgd_lanes_ref(
        g, h, params.expand((n, p_dim)), noise,
        alpha=[float(v) for v in _lane_values(alpha, n)], **kw)


def _cuda_lanes(mode, grads, gains, params, n, *, sigma, scale, seed,
                with_noise, alpha, rescale, threads):
    dev = grads.device
    per_lane = {
        "sigma": _lane_array(sigma, n, torch.float32, dev),
        "scale": _lane_array(scale, n, torch.float32, dev),
        "alpha": _lane_array(alpha, n, torch.float32, dev),
        "seed": (_lane_array(seed, n, torch.int64, dev)
                 if _is_lanes(seed) or (isinstance(seed, torch.Tensor)
                                        and seed.device == dev and n > 1)
                 else None)}
    if rescale is not None:
        rescale = rescale.reshape(-1).expand(n).contiguous()

    def host(x):   # the by-value fallback of a shared host number
        return 0.0 if isinstance(x, torch.Tensor) or _is_lanes(x) \
            else float(x)

    states = () if params is None else (params,)
    (out,) = _launch(mode, grads, gains, states,
                     with_noise=with_noise is not False,
                     seed=0 if per_lane["seed"] is not None else seed,
                     sigma=host(sigma), scale=host(scale), alpha=host(alpha),
                     rescale=rescale, threads=threads, lanes=n,
                     per_lane=per_lane)
    return out


def fused_aggregate_lanes(grads: torch.Tensor, gains: torch.Tensor, *,
                          sigma: Lanes = 0.0, scale: Lanes = 1.0,
                          seed=0, with_noise: Optional[bool] = None,
                          wire_dtype=None,
                          rescale: Optional[torch.Tensor] = None,
                          threads: int = 256) -> torch.Tensor:
    """``fused_aggregate`` over L lanes in one launch; returns (L, P).

    ``grads`` is (A, P) (shared by every lane) or (L, A, P); ``gains`` (A,)
    or (L, A); ``sigma``, ``scale`` and ``seed`` a scalar (shared) or L
    values (a sequence or a 1-D tensor); ``rescale`` None, or a float32
    device tensor of 1 or L elements.  Lane l is bitwise
    ``fused_aggregate`` on lane l's operands through the same body."""
    grads = _prep_lanes(grads, gains, wire_dtype)
    n = _n_lanes(grads, gains, None, (sigma, scale, seed), rescale)
    kw = dict(sigma=sigma, scale=scale, seed=seed, with_noise=with_noise,
              alpha=0.0, rescale=rescale)
    if not grads.is_cuda:
        return _plain_lanes("agg", grads, gains, None, n, **kw)
    return _cuda_lanes("agg", grads, gains, None, n, threads=threads, **kw)


def fused_aggregate_sgd_lanes(grads: torch.Tensor, gains: torch.Tensor,
                              params: torch.Tensor, *, alpha: Lanes,
                              sigma: Lanes = 0.0, scale: Lanes = 1.0,
                              seed=0, with_noise: Optional[bool] = None,
                              wire_dtype=None,
                              rescale: Optional[torch.Tensor] = None,
                              threads: int = 256) -> torch.Tensor:
    """``fused_aggregate_sgd`` over L lanes in one launch; returns (L, P).
    ``params`` is (P,) (shared) or (L, P), ``alpha`` a scalar or L values;
    the rest as :func:`fused_aggregate_lanes`."""
    grads = _prep_lanes(grads, gains, wire_dtype)
    if params.ndim not in (1, 2):
        raise ValueError(f"params must be (P,) or (L, P), got "
                         f"{tuple(params.shape)}")
    n = _n_lanes(grads, gains, params, (sigma, scale, seed, alpha), rescale)
    kw = dict(sigma=sigma, scale=scale, seed=seed, with_noise=with_noise,
              alpha=alpha, rescale=rescale)
    if not grads.is_cuda:
        return _plain_lanes("sgd", grads, gains, params, n, **kw)
    return _cuda_lanes("sgd", grads, gains, params, n, threads=threads, **kw)


def counter_bits(seed: Seed, n: int, device,
                 threads: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two 24-bit uniform streams for indices ``0..n-1`` (int64
    tensors), through the same device function K1 draws its noise with.
    A check of the counter stream, not a step of the uplink: it does not
    count in ``LAUNCHES``."""
    device = torch.device(device)
    if device.type != "cuda":
        return ref.counter_bits(seed, n, device)
    if not 0 < n <= _MAX_PARAMS:
        raise ValueError(f"n={n} out of range (0 < n < 2^32)")
    _check_threads(threads)
    b1, b2 = (torch.empty(n, dtype=torch.int32, device=device)
              for _ in range(2))
    seed_ptr, seed_val = _seed_args(seed, device)
    with torch.cuda.device(device):
        rc = _lib().ota_counter_bits_launch(
            n, seed_ptr, seed_val, b1.data_ptr(), b2.data_ptr(), threads,
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ota_counter_bits launch failed: cudaError {rc}")
    return b1.long(), b2.long()
