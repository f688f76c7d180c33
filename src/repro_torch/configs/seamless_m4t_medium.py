"""seamless-m4t-medium [audio]: 12L encoder + 12L decoder, d_model=1024,
16H, d_ff=4096, vocab=256206.  [arXiv:2308.11596; hf]

The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S_frames, d_model) per the assignment.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, encoder_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, act="gelu", norm="layernorm",
    frontend="audio", num_frontend_tokens=960,
)
