"""Mamba2 / SSD (state-space duality) mixer [arXiv:2405.21060].

Counterpart of ``repro/models/ssm.py``.  The SSD recurrence
s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t,  y_t = C_t s_t  is evaluated
chunk-wise by ``ops.ssd``: K4 (``kernels/ssd_scan.py``) on a CUDA tensor, the
plain chunked SSD (``kernels/ref.py::ssd_ref``, the JAX model's oracle) on a
CPU tensor.  K4 has no backward: ``ssm_mixer(..., plain_scan=True)`` runs
``ref.ssd_ref`` on any device, which autograd differentiates (the trainer's
forward; the JAX model always takes it).  ``ssm_step`` is the O(1) recurrent
decode form, plain torch.

Projections are split per segment (z/x/B/C/dt) with the JAX package's
layouts (``w_x`` is ``(d_model, d_inner)``).

On a mesh (``utils/shard_hints.py``) the mixer runs on this rank's
``d_inner`` channels and SSD heads: ``w_z``, ``w_x``, ``conv_x``,
``gate_norm`` and ``w_out`` hold its channels, ``w_dt``, ``dt_bias``,
``A_log`` and ``D`` its heads, and ``w_B``/``w_C`` (one group) are
replicated, so K4 scans the rank's heads against the shared B and C.
``gate_norm`` normalises over all of ``d_inner``: each rank's mean of
squares over its equal share is all-reduced and divided by the ranks (the
identity on one rank), and the ``w_out`` product is row-parallel
(``shard_hints.row_parallel``).  Under autograd the column-parallel
products take their input through ``shard_hints.copy_to``, and so do the
shared B and C before the scan (each rank's gradient of ``w_B``, ``w_C``,
``conv_B`` and ``conv_C`` then covers every head, summed over ``model``);
the mean of squares' all-reduce sums in backward too.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import decl
from repro_torch.utils import shard_hints


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.headdim
    return d_inner, n_heads, s.n_groups, s.state


def ssm_plan(cfg: ModelConfig) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, h, g, n = dims(cfg)
    return {
        "norm": {"scale": decl((d,), ("d_model",), init="ones", dtype="float32")},
        "w_z": decl((d, d_in), ("d_model", "d_inner")),
        "w_x": decl((d, d_in), ("d_model", "d_inner")),
        "w_B": decl((d, g * n), ("d_model", None)),
        "w_C": decl((d, g * n), ("d_model", None)),
        "w_dt": decl((d, h), ("d_model", "ssm_heads")),
        "conv_x": decl((s.conv_width, d_in), (None, "d_inner"), scale=0.5),
        "conv_B": decl((s.conv_width, g * n), (None, None), scale=0.5),
        "conv_C": decl((s.conv_width, g * n), (None, None), scale=0.5),
        "dt_bias": decl((h,), ("ssm_heads",), init="dt_bias", dtype="float32"),
        "A_log": decl((h,), ("ssm_heads",), init="a_log", dtype="float32"),
        "D": decl((h,), ("ssm_heads",), init="ones", dtype="float32"),
        "gate_norm": {
            "scale": decl((d_in,), ("d_inner",), init="ones", dtype="float32")
        },
        "w_out": decl((d_in, d), ("d_inner", "d_model")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along time. x: (B,S,C); w: (W,C).

    Returns (y, new_state) where state keeps the last W-1 inputs for decode.
    """
    width = w.shape[0]
    pad = (x.new_zeros((x.shape[0], width - 1, x.shape[2])) if state is None
           else state)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(width))
    new_state = xp[:, -(width - 1):, :] if width > 1 else pad
    return y, new_state


class SSMState(NamedTuple):
    """Decode-time recurrent state for one SSM layer."""

    ssm: torch.Tensor      # (B, G, H/G, P, N) f32
    conv_x: torch.Tensor   # (B, W-1, d_inner)
    conv_B: torch.Tensor   # (B, W-1, G*N)
    conv_C: torch.Tensor   # (B, W-1, G*N)


def init_state(cfg: ModelConfig, batch: int, dtype, device=None) -> SSMState:
    """Zeros; on a mesh this rank's channels and heads (``batch`` is its
    own)."""
    s = cfg.ssm
    d_in, h, g, n = dims(cfg)
    lay = shard_hints.layout(cfg)
    if lay and lay.ssm_heads:
        d_in, h = d_in // lay.model, h // lay.model
    w = s.conv_width
    return SSMState(
        ssm=torch.zeros(batch, g, h // g, s.headdim, n, dtype=torch.float32,
                        device=device),
        conv_x=torch.zeros(batch, w - 1, d_in, dtype=dtype, device=device),
        conv_B=torch.zeros(batch, w - 1, g * n, dtype=dtype, device=device),
        conv_C=torch.zeros(batch, w - 1, g * n, dtype=dtype, device=device),
    )


def _project(params, h: torch.Tensor, h_bc: Optional[torch.Tensor] = None):
    """The five input projections; ``h_bc`` (default ``h``) feeds ``w_B``
    and ``w_C`` (on a mesh ``h`` is the column-parallel products' input,
    ``h_bc`` the replicated one)."""
    dt_ = h.dtype
    h_bc = h if h_bc is None else h_bc
    z = h @ params["w_z"].to(dt_)
    xs = h @ params["w_x"].to(dt_)
    Bp = h_bc @ params["w_B"].to(dt_)
    Cp = h_bc @ params["w_C"].to(dt_)
    dt = h @ params["w_dt"].to(dt_)
    return z, xs, Bp, Cp, dt


def _gate_norm(params, y: torch.Tensor, cfg: ModelConfig,
               lay: Optional[shard_hints.Layout]) -> torch.Tensor:
    """RMSNorm over all of ``d_inner``: ``layers.rmsnorm``, or across the
    ranks' equal shares where ``lay`` shards it (the mean of the ranks'
    means of squares, all-reduced)."""
    if lay is None or not lay.d_inner:
        return rmsnorm(params["gate_norm"], y, cfg.norm_eps)
    y32 = y.float()
    var = shard_hints.all_reduce(
        torch.mean(torch.square(y32), dim=-1, keepdim=True),
        backward="sum") / lay.model
    out = y32 * torch.rsqrt(var + cfg.norm_eps)
    return (out * params["gate_norm"]["scale"]).to(y.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """silu in float32, cast back."""
    return F.silu(x.float()).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` without a threshold, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssm_mixer(params, x: torch.Tensor, cfg: ModelConfig, *,
              plain_scan: bool = False) -> torch.Tensor:
    """Full-sequence Mamba2 block body (pre-norm residual branch); the scan
    through ``ops.ssd`` (K4 on the card), or ``ref.ssd_ref`` where
    ``plain_scan``."""
    b, s, _ = x.shape
    scfg = cfg.ssm
    _, _, g, n = dims(cfg)
    d_in, h_heads = params["w_x"].shape[-1], params["w_dt"].shape[-1]
    lay = shard_hints.layout(cfg)
    hid = rmsnorm(params["norm"], x, cfg.norm_eps)
    sharded = lay is not None and lay.d_inner
    z, xs, Bp, Cp, dt = _project(
        params, shard_hints.copy_to(hid) if sharded else hid, hid)

    xs, _ = _causal_conv(xs, params["conv_x"].to(x.dtype))
    Bp, _ = _causal_conv(Bp, params["conv_B"].to(x.dtype))
    Cp, _ = _causal_conv(Cp, params["conv_C"].to(x.dtype))
    xs, Bp, Cp = _silu(xs), _silu(Bp), _silu(Cp)
    if sharded:
        # the shared B and C meet this rank's heads only: their gradient
        # is summed over the model axis
        Bp, Cp = shard_hints.copy_to(Bp), shard_hints.copy_to(Cp)

    dt = _softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    xh = xs.reshape(b, s, h_heads, scfg.headdim)
    Bh = Bp.reshape(b, s, g, n)
    Ch = Cp.reshape(b, s, g, n)

    if plain_scan:
        y = ref.ssd_ref(xh, dt, A, Bh, Ch, scfg.chunk)        # float32
    else:
        y = ops.ssd(xh, dt, A, Bh, Ch, chunk=scfg.chunk)      # float32
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(b, s, d_in).to(x.dtype)

    y = y * _silu(z)
    y = _gate_norm(params, y, cfg, lay)
    return _out(params, y, lay)


def _out(params, y: torch.Tensor,
         lay: Optional[shard_hints.Layout]) -> torch.Tensor:
    """``y @ w_out``, row-parallel over ``model`` where ``lay`` shards
    ``d_inner``."""
    w = params["w_out"].to(y.dtype)
    if lay and lay.d_inner:
        return shard_hints.row_parallel(y, w, lay)
    return y @ w


def ssm_step(params, x: torch.Tensor, state: SSMState,
             cfg: ModelConfig) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrent step: x (B, 1, D) -> (y (B, 1, D), state')."""
    b = x.shape[0]
    scfg = cfg.ssm
    _, _, g, n = dims(cfg)
    d_in, h_heads = params["w_x"].shape[-1], params["w_dt"].shape[-1]
    lay = shard_hints.layout(cfg)
    hid = rmsnorm(params["norm"], x, cfg.norm_eps)
    z, xs, Bp, Cp, dt = _project(params, hid)

    xs, cx = _causal_conv(xs, params["conv_x"].to(x.dtype), state.conv_x)
    Bp, cb = _causal_conv(Bp, params["conv_B"].to(x.dtype), state.conv_B)
    Cp, cc = _causal_conv(Cp, params["conv_C"].to(x.dtype), state.conv_C)
    xs, Bp, Cp = _silu(xs), _silu(Bp), _silu(Cp)

    dt = _softplus(dt.float() + params["dt_bias"])[:, 0]            # (b,h)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A[None, :])                              # (b,h)

    xh = xs.reshape(b, h_heads, scfg.headdim).float()
    Bh = Bp.reshape(b, g, n).float()
    Ch = Cp.reshape(b, g, n).float()
    hg = h_heads // g

    dax_g = (xh * dt[..., None]).reshape(b, g, hg, scfg.headdim)
    decay_g = decay.reshape(b, g, hg)

    new_ssm = state.ssm * decay_g[..., None, None] + torch.einsum(
        "bgn,bghp->bghpn", Bh, dax_g)
    y = torch.einsum("bgn,bghpn->bghp", Ch, new_ssm)                # (b,g,hg,p)
    y = y + params["D"].reshape(1, g, hg)[..., None] * xh.reshape(
        b, g, hg, scfg.headdim)
    y = y.reshape(b, 1, d_in).to(x.dtype)

    y = y * _silu(z)
    y = _gate_norm(params, y, cfg, lay)
    return _out(params, y, lay), SSMState(ssm=new_ssm, conv_x=cx,
                                          conv_B=cb, conv_C=cc)
