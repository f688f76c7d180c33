"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + shared expert, MoE on
alternating layers (Maverick interleaves dense/MoE 1:1).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Early-fusion multimodality: text backbone only here; the modality
frontend is a stub per the assignment.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=128, n_shared_experts=1, top_k=1, moe_d_ff=8192,
    moe_every=2, moe_offset=1,
    rope_theta=5e5,
)
