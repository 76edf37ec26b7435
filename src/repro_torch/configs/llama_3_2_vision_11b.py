"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5 blocks.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision].  Backbone only: the ViT vision encoder
+ projector are stubs — ``data.pipeline.memory_stub`` supplies patch embeddings
(B, n_patches, d_model); every 5th decoder layer gains a gated cross-attn
sub-block over them.
Same values as ``repro/configs/llama_3_2_vision_11b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    cross_attn_every=5,
    n_cross_tokens=1601,    # 1 tile x (40x40 patches + cls), ViT-H/14 @ 560px
    rope_theta=500000.0,
    serve_window=8192,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    cross_attn_every=2, n_cross_tokens=16, remat=False,
)
