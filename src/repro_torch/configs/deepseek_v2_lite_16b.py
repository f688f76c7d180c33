"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(dense)=10944,
vocab=102400; MLA kv_lora=512; 2 shared + 64 routed experts top-6 with
per-expert d_ff=1408; first layer dense.  [arXiv:2405.04434; hf]

Assignment-line note ("160 routed") follows DeepSeek-V2-236B; the lite
config has 64 routed experts (DESIGN.md §4).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    moe_every=1, first_k_dense=1,
    mla=True, kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
    v_head_dim=128,
)
