"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768 [arXiv:2401.04088].
Same values as ``repro/configs/mixtral_8x22b.py``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    moe=MoEConfig(num_experts=8, top_k=2),
    window=4096,            # native SWA — sub-quadratic by construction
    serve_window=4096,
    rope_theta=1000000.0,
    source="arXiv:2401.04088",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    moe=MoEConfig(num_experts=4, top_k=2), window=64, serve_window=64,
    remat=False,
)
