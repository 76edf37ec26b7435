"""deepseek-67b [dense] — llama-arch, GQA.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400 [arXiv:2401.02954].
Same values as ``repro/configs/deepseek_67b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    rope_theta=10000.0,
    serve_window=8192,
    source="arXiv:2401.02954",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    remat=False,
)
