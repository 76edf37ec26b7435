"""starcoder2-15b [dense] — GQA, RoPE.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152 [arXiv:2402.19173].
StarCoder2-15B natively uses a 4096 sliding window for part of its context
handling; we keep full attention for train/prefill/decode_32k per the
assignment and use the ring-cache SWA only for long_500k serving.
Same values as ``repro/configs/starcoder2_15b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    rope_theta=100000.0,
    serve_window=4096,      # the model's own SWA width
    source="arXiv:2402.19173",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    remat=False,
)
