"""internlm2-20b [dense] — GQA.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544 [arXiv:2403.17297].
Same values as ``repro/configs/internlm2_20b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    rope_theta=1000000.0,
    serve_window=8192,
    source="arXiv:2403.17297",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    remat=False,
)
