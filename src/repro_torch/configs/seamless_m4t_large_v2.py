"""seamless-m4t-large-v2 [audio] — encoder-decoder multimodal backbone.

24L d_model=1024 16H (GQA kv=16 => MHA) d_ff=8192 vocab=256206
[arXiv:2308.11596].  Backbone only: the speech frontend (mel-spectrogram +
conformer feature extractor) is a stub — ``data.pipeline.memory_stub`` supplies
precomputed frame embeddings (B, seq//4, d_model); the text decoder
cross-attends to the 24-layer encoder's output.
Same values as ``repro/configs/seamless_m4t_large_v2.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,            # decoder depth (assigned backbone depth)
    encoder_layers=24,      # speech encoder transformer depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    n_cross_tokens=0,       # encdec: cross length = frame count (seq//4)
    serve_window=8192,      # beyond-paper SWA ring cache for long_500k decode
    source="arXiv:2308.11596",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, encoder_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, remat=False,
)
