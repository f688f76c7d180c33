"""mamba2-780m [ssm]: 48L d_model=1536, attention-free SSD (state-space
duality), ssm_state=128, vocab=50280, no FFN (mixer-only blocks).
[arXiv:2405.21060; unverified]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=12, n_kv_heads=12,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    attn_free=True, sub_quadratic=True, tie_embeddings=True,
)
