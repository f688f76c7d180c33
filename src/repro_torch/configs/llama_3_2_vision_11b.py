"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a STUB: input_specs() provides precomputed patch
embeddings (B, 1601, d_model) per the assignment.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    frontend="vision", num_frontend_tokens=1601, cross_attn_every=5,
)
