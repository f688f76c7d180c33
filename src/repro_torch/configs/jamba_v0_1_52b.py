"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; Mamba:attention 7:1 interleave (attention at position 4 of
each 8-layer period); MoE 16 experts top-2 on every other layer.
[arXiv:2403.19887; hf]

Sub-quadratic: runs the long_500k shape (its 4 attention layers hold the
KV cache; SSM layers carry O(1) state).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536,
    n_experts=16, n_shared_experts=0, top_k=2, moe_d_ff=14336,
    moe_every=2, moe_offset=1,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64,
    attn_every=8, attn_offset=4,
    sub_quadratic=True,
)
