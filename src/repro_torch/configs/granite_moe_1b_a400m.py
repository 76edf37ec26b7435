"""granite-moe-1b-a400m [moe] — 32 experts, top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per expert) vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
Same values as ``repro/configs/granite_moe_1b_a400m.py``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(num_experts=32, top_k=8),
    serve_window=8192,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=64, vocab=512,
    moe=MoEConfig(num_experts=4, top_k=2), remat=False,
)
