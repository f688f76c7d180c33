"""Model configuration schema for the assigned architectures (a copy of
``repro/models/config.py``, which the port does not import).

A config describes a decoder-only LM, an encoder-decoder, a pure-SSM
stack, or any hybrid, through a repeating layer *pattern*.  ``pattern()``
returns one period of (mixer, ffn) kinds, repeated ``n_repeats`` times
(the JAX model scans over the repeats; the port unrolls them into one
list of layers).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

__all__ = ["ModelConfig", "LayerSpec"]

# mixer kinds: "attn" | "mamba" | "cross_attn"; ffn kinds: "dense" | "moe" | "none"
LayerSpec = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu (gated) | gelu
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden; 0 -> d_ff
    moe_every: int = 1               # MoE ffn on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    first_k_dense: int = 0           # deepseek: first K layers use dense FFN
    # --- MLA (deepseek) ------------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # --- SSM / hybrid ---------------------------------------------------------
    ssm_state: int = 0               # >0 enables Mamba2 mixers
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    attn_every: int = 0              # hybrid: attention mixer on i % attn_every == attn_offset
    attn_offset: int = 0
    attn_free: bool = False          # pure SSM (mamba2)
    # --- encoder-decoder --------------------------------------------------------
    encoder_layers: int = 0          # >0 -> enc-dec; n_layers = decoder layers
    # --- multimodal stubs ---------------------------------------------------------
    frontend: str = "none"           # none | audio | vision
    num_frontend_tokens: int = 0     # stub tokens prepended / cross-attended
    cross_attn_every: int = 0        # vlm: cross-attn mixer on i % cae == cae-1
    # --- shapes ------------------------------------------------------------------
    max_seq_len: int = 524288
    sub_quadratic: bool = False      # eligible for long_500k

    # ------------------------------------------------------------------ derived
    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a TP-shardable multiple (logit columns
        beyond ``vocab`` are masked to -inf by the model)."""
        return -(-self.vocab // 512) * 512

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_k_dense:
            return False
        return (i - self.first_k_dense) % self.moe_every == self.moe_offset

    def mixer_kind(self, i: int) -> str:
        if self.cross_attn_every and i % self.cross_attn_every == self.cross_attn_every - 1:
            return "cross_attn"
        if self.ssm_state > 0:
            if self.attn_free:
                return "mamba"
            if self.attn_every and i % self.attn_every == self.attn_offset:
                return "attn"
            return "mamba"
        return "attn"

    def _ffn_kind(self, i: int) -> str:
        if self.is_moe_layer(i):
            return "moe"
        return "dense" if self.d_ff > 0 else "none"  # mamba2: mixer-only

    def prefix_pattern(self) -> List[LayerSpec]:
        """The first_k_dense layers (deepseek) — unrolled, not scanned."""
        return [(self.mixer_kind(i), self._ffn_kind(i))
                for i in range(self.first_k_dense)]

    def pattern(self) -> List[LayerSpec]:
        """One period of the repeating layer pattern (after the prefix)."""
        n_periodic = self.n_layers - self.first_k_dense
        period = 1
        if self.n_experts > 0:
            period = max(period, self.moe_every)
        if self.attn_every:
            period = max(period, self.attn_every)
        if self.cross_attn_every:
            period = max(period, self.cross_attn_every)
        if n_periodic % period != 0:
            period = n_periodic  # fall back to the full stack
        return [(self.mixer_kind(i), self._ffn_kind(i))
                for i in range(self.first_k_dense,
                               self.first_k_dense + period)]

    @property
    def n_repeats(self) -> int:
        return (self.n_layers - self.first_k_dense) // len(self.pattern())

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (one forward/train
        step, assert shapes + finiteness)."""
        pat = len(self.pattern())
        small_layers = self.first_k_dense + pat  # prefix + one period
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=small_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 4) if self.n_kv_heads
                           else 4),
            d_ff=128,
            moe_d_ff=32 if self.n_experts else 0,
            vocab=256,
            d_head=16,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            kv_lora_rank=32 if self.mla else 0,
            qk_rope_dim=8 if self.mla else 64,
            qk_nope_dim=16 if self.mla else 128,
            v_head_dim=16 if self.mla else 128,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            encoder_layers=min(self.encoder_layers, 2),
            num_frontend_tokens=min(self.num_frontend_tokens, 8),
            max_seq_len=512,
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        n = 0
        n += v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.mixer_kind(i)
            if kind == "attn" or kind == "cross_attn":
                if self.mla:
                    n += d * (self.n_heads * (self.qk_nope_dim + self.qk_rope_dim))
                    n += d * self.kv_lora_rank + d * self.qk_rope_dim
                    n += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    n += self.n_heads * self.v_head_dim * d
                else:
                    n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    n += self.n_heads * hd * d
            else:  # mamba
                di = self.d_inner
                n += d * 2 * di + di * self.ssm_conv_width + di * d
                n += self.ssm_heads * (2 + self.ssm_state)
            if self.is_moe_layer(i):
                e_ff = self.moe_d_ff or dff
                n += (self.n_experts + self.n_shared_experts) * 3 * d * e_ff
                n += d * self.n_experts
            else:
                n += 3 * d * dff if self.act == "silu" else 2 * d * dff
        if self.encoder_layers:
            n += self.encoder_layers * (4 * d * self.n_heads * hd + 2 * d * dff)
            n += self.n_layers * 2 * d * self.n_heads * hd  # decoder cross-attn
        return n
