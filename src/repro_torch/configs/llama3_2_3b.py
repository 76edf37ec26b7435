"""llama3.2-3b [dense] — small llama3.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B].  Same values as ``repro/configs/llama3_2_3b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    serve_window=8192,
    source="hf:meta-llama/Llama-3.2-1B",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    remat=False,
)
