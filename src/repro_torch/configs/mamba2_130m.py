"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060].
d_inner = 2*768 = 1536, headdim 64 => 24 SSD heads.  Same values as
``repro/configs/mamba2_130m.py``.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state=128, headdim=64, expand=2, n_groups=1, chunk=128),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

SMOKE_CONFIG = CONFIG.with_(
    n_layers=2, d_model=128, vocab=512,
    ssm=SSMConfig(state=16, headdim=32, expand=2, n_groups=1, chunk=32),
    remat=False,
)
