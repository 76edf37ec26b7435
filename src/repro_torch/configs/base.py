"""Model configuration dataclasses shared by every architecture family.

Counterpart of ``repro/configs/base.py``, field for field: one
``ModelConfig`` describes every family (dense / moe / ssm / hybrid / encdec /
vlm); family-specific blocks are optional sub-configs.  Configs are frozen
and hashable.  The port runs the ``dense``, ``ssm`` and ``moe`` families so far;
the other families' fields are kept so a config reads the same in both
packages.

``remat`` is the JAX package's per-layer activation checkpoint.  The port's
trainer does not checkpoint activations: at B=8 S=256 the full-width train
steps of llama3.2-3b, granite-moe-1b-a400m and mamba2-130m fit one H100
80GB without it (``PERF.md`` §5), so the field is kept for parity only.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0          # optional routing noise (train)
    load_balance_coef: float = 0.01     # aux loss weight


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""

    state: int                 # N — SSM state size per head
    headdim: int = 64          # P
    expand: int = 2            # d_inner = expand * d_model
    n_groups: int = 1          # B/C groups (G)
    conv_width: int = 4        # causal depthwise conv
    chunk: int = 128           # SSD chunk length
    dt_min: float = 1e-3
    dt_max: float = 1e-1


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free layers
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> derived d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    window: Optional[int] = None          # sliding-window attention width
    serve_window: Optional[int] = None    # SWA applied only for long-context serving
    cross_attn_every: int = 0             # vlm/audio: cross-attn each k-th layer
    n_cross_tokens: int = 0               # stub frontend: patches / audio frames
    encoder_layers: int = 0               # encdec: encoder depth
    shared_attn_every: int = 0            # hybrid: shared attn block period
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True                    # read by nothing: the trainer keeps every activation
    source: str = ""                      # citation for the config

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def q_per_kv(self) -> int:
        return max(self.n_heads, 1) // max(self.n_kv_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def has_ssm(self) -> bool:
        return self.ssm is not None

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def param_counts(self) -> Tuple[int, int]:
        """(total_params, active_params) — active = per-token touched params
        (MoE counts only top_k experts; shared/tied embeddings once)."""
        d, dh = self.d_model, self.head_dim
        nh, nkv = max(self.n_heads, 1), max(self.n_kv_heads, 1)

        def attn_block() -> int:
            qkv = d * (nh * dh) + 2 * d * (nkv * dh) + (nh * dh) * d
            return qkv + 2 * d  # + norms

        def mlp_block(ff: int) -> int:
            return 3 * d * ff + d  # SwiGLU (gate, up, down) + norm

        def ssm_block() -> int:
            s = self.ssm
            d_in = s.expand * d
            h = d_in // s.headdim
            in_proj = d * (2 * d_in + 2 * s.n_groups * s.state + h)
            conv = (d_in + 2 * s.n_groups * s.state) * s.conv_width
            out = d_in * d
            return in_proj + conv + out + 2 * h + d  # + A_log, D, norm

        total = 0
        active = 0
        n_layers = self.n_layers
        if self.family in ("dense", "vlm", "audio"):
            layer = attn_block() + mlp_block(self.d_ff)
            total += n_layers * layer
            active += n_layers * layer
            if self.cross_attn_every:
                n_cross = n_layers // self.cross_attn_every
                cross = attn_block() + mlp_block(self.d_ff)
                total += n_cross * cross
                active += n_cross * cross
        elif self.family == "encdec":
            enc = self.encoder_layers * (attn_block() + mlp_block(self.d_ff))
            dec = n_layers * (2 * attn_block() + mlp_block(self.d_ff))
            total += enc + dec
            active += enc + dec
        elif self.family == "moe":
            m = self.moe
            router = d * m.num_experts
            experts_total = m.num_experts * 3 * d * self.d_ff
            experts_active = m.top_k * 3 * d * self.d_ff
            layer_shared = attn_block() + router + d
            total += n_layers * (layer_shared + experts_total)
            active += n_layers * (layer_shared + experts_active)
        elif self.family == "ssm":
            total += n_layers * ssm_block()
            active += n_layers * ssm_block()
        elif self.family == "hybrid":
            total += n_layers * ssm_block()
            active += n_layers * ssm_block()
            if self.shared_attn_every:
                shared = attn_block() + mlp_block(self.d_ff)
                total += shared  # shared weights stored once
                active += (n_layers // self.shared_attn_every) * shared
        else:
            raise ValueError(self.family)

        emb = self.vocab * d
        total += emb + d  # embedding + final norm
        active += emb + d
        if not self.tie_embeddings:
            total += emb      # lm head
            active += emb
        return int(total), int(active)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch            # one new token per sequence
        return self.global_batch * self.seq_len
