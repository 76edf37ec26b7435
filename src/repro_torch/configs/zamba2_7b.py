"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32 => MHA in the shared block) d_ff=14336
vocab=32000, ssm_state=64 [arXiv:2411.15242].  The shared attention+MLP
block's weights are stored once and applied every 6th layer.
Same values as ``repro/configs/zamba2_7b.py``.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm=SSMConfig(state=64, headdim=64, expand=2, n_groups=1, chunk=128),
    shared_attn_every=6,
    serve_window=8192,      # shared-attn KV ring for long_500k
    source="arXiv:2411.15242",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    ssm=SSMConfig(state=16, headdim=32, expand=2, n_groups=1, chunk=32),
    shared_attn_every=2, remat=False,
)
