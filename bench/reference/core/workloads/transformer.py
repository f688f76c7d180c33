"""Transformer-family workloads: ViT-B/16, LLaMA-7B, speculative decoding,
Mixtral, LLaVA, RT-2 and LAVISH (paper Table 1).

LLM workloads are prefill-style single-batch passes (S=256) — compute-bound,
past the roofline ridge, matching their Fig. 8 placement.  Speculative
decoding is the one bandwidth-bound workload (arithmetic intensity ~2.4):
a small-draft/large-verify step over a handful of tokens.
"""
from __future__ import annotations

from typing import Optional

from ..ir import OpNode, OpType, Precision, WorkloadGraph

__all__ = ["vit_b16", "llama7b", "spec_decode", "mixtral", "llava", "rt2",
           "lavish", "attention_block", "mlp_block"]


def attention_block(g: WorkloadGraph, pre: str, x: int, s: int, d: int,
                    heads: int, kv_heads: int, prec: Precision,
                    norm: OpType = OpType.LAYERNORM, rope: bool = False,
                    kv_len: Optional[int] = None, cross_from: Optional[int] = None) -> int:
    """Standard (self- or cross-) attention block; returns output op index.

    GQA: kv projections are sized by ``kv_heads``.  ``kv_len`` > s models
    decode against a KV cache; ``cross_from`` wires cross-attention."""
    hd = d // heads
    kv_len = kv_len or s
    n1 = g.dsp(f"{pre}_norm", norm, elems=s * d, preds=[x])
    q = g.add(OpNode(f"{pre}_q_proj", OpType.MATMUL, m=s, k=d, n=d, precision=prec), [n1])
    # K/V projections cover only the NEW tokens — the KV cache supplies the
    # history; kv_len enters the scores/AV dims below, not the projections.
    kv_src = cross_from if cross_from is not None else n1
    kv_new = kv_len if cross_from is not None else s
    kproj = g.add(OpNode(f"{pre}_k_proj", OpType.MATMUL, m=kv_new,
                         k=d, n=kv_heads * hd, precision=prec), [kv_src])
    vproj = g.add(OpNode(f"{pre}_v_proj", OpType.MATMUL, m=kv_new,
                         k=d, n=kv_heads * hd, precision=prec), [kv_src])
    if rope:
        q = g.dsp(f"{pre}_rope_q", OpType.ROPE, elems=s * d, preds=[q])
        kproj = g.dsp(f"{pre}_rope_k", OpType.ROPE, elems=kv_new * kv_heads * hd,
                      preds=[kproj])
    # scores: (heads*s) x hd x kv_len — attention math stays >= FP16
    sc = g.add(OpNode(f"{pre}_scores", OpType.MATMUL, m=heads * s, k=hd,
                      n=kv_len, precision=max(prec, Precision.FP16),
                      splittable=False), [q, kproj])
    sm = g.dsp(f"{pre}_softmax", OpType.SOFTMAX, elems=heads * s * kv_len, preds=[sc])
    av = g.add(OpNode(f"{pre}_attn_v", OpType.MATMUL, m=heads * s, k=kv_len,
                      n=hd, precision=max(prec, Precision.FP16),
                      splittable=False), [sm, vproj])
    o = g.add(OpNode(f"{pre}_o_proj", OpType.MATMUL, m=s, k=d, n=d, precision=prec), [av])
    return g.dsp(f"{pre}_residual", OpType.ADD, elems=s * d, preds=[o, x])


def mlp_block(g: WorkloadGraph, pre: str, x: int, s: int, d: int, d_ff: int,
              prec: Precision, gated: bool = True,
              norm: OpType = OpType.LAYERNORM) -> int:
    n2 = g.dsp(f"{pre}_norm2", norm, elems=s * d, preds=[x])
    if gated:
        up = g.add(OpNode(f"{pre}_gate_up", OpType.MATMUL, m=s, k=d,
                          n=2 * d_ff, precision=prec), [n2])
        act = g.dsp(f"{pre}_silu", OpType.SILU, elems=s * d_ff, preds=[up])
        h = g.dsp(f"{pre}_gate_mul", OpType.MUL, elems=s * d_ff, preds=[act])
    else:
        up = g.add(OpNode(f"{pre}_fc1", OpType.MATMUL, m=s, k=d, n=d_ff,
                          precision=prec), [n2])
        h = g.dsp(f"{pre}_gelu", OpType.GELU, elems=s * d_ff, preds=[up])
    down = g.add(OpNode(f"{pre}_fc2", OpType.MATMUL, m=s, k=d_ff, n=d,
                        precision=prec), [h])
    return g.dsp(f"{pre}_residual2", OpType.ADD, elems=s * d, preds=[down, x])


def _decoder_stack(g: WorkloadGraph, x: int, layers: int, s: int, d: int,
                   heads: int, kv_heads: int, d_ff: int, prec: Precision,
                   kv_len: Optional[int] = None, gated: bool = True) -> int:
    for li in range(layers):
        x = attention_block(g, f"l{li}", x, s, d, heads, kv_heads, prec,
                            norm=OpType.RMSNORM, rope=True, kv_len=kv_len)
        x = mlp_block(g, f"l{li}", x, s, d, d_ff, prec, gated=gated,
                      norm=OpType.RMSNORM)
    return x


def vit_b16(precision: Precision = Precision.FP16) -> WorkloadGraph:
    """ViT-B/16, 224x224 single image: 197 tokens, 12 blocks, d=768."""
    g = WorkloadGraph(f"vit_b16_{precision.name.lower()}",
                      model_precision=precision, family="vit")
    s, d, h, dff = 197, 768, 12, 3072
    x = g.add(OpNode("patch_embed", OpType.CONV2D, m=196, k=3 * 16 * 16, n=d,
                     precision=precision))
    for li in range(12):
        x = attention_block(g, f"b{li}", x, s, d, h, h, precision)
        x = mlp_block(g, f"b{li}", x, s, d, dff, precision, gated=False)
    n = g.dsp("final_norm", OpType.LAYERNORM, elems=s * d, preds=[x])
    c = g.add(OpNode("classifier", OpType.FC, m=1, k=d, n=1000,
                     precision=precision), [n])
    g.dsp("softmax_out", OpType.SOFTMAX, elems=1000, preds=[c])
    return g


def llama7b(precision: Precision = Precision.FP16, s: int = 256) -> WorkloadGraph:
    """LLaMA-7B prefill: 32 layers, d=4096, MHA-32, d_ff=11008."""
    g = WorkloadGraph(f"llama7b_{precision.name.lower()}",
                      model_precision=precision, family="llm")
    x = g.dsp("embed_lookup", OpType.GATHER, elems=s * 4096,
              precision=Precision.FP16)
    x = _decoder_stack(g, x, 32, s, 4096, 32, 32, 11008, precision)
    n = g.dsp("final_norm", OpType.RMSNORM, elems=s * 4096, preds=[x])
    g.add(OpNode("lm_head", OpType.MATMUL, m=1, k=4096, n=32000,
                 precision=precision), [n])
    return g


def spec_decode() -> WorkloadGraph:
    """Speculative decoding (paper: arithmetic intensity 2.4, the single
    bandwidth-bound workload): a 16-layer draft decodes 4 tokens one at a
    time, then the 7B target verifies all 5 in one pass."""
    g = WorkloadGraph("spec_decode", model_precision=Precision.FP16,
                      family="llm")
    x = g.dsp("embed_lookup", OpType.GATHER, elems=2048, precision=Precision.FP16)
    # draft: 4 sequential single-token decodes against a 256-token KV cache
    for t in range(4):
        x = _decoder_stack(g, x, 4, 1, 2048, 16, 16, 5504, Precision.FP16,
                           kv_len=256 + t)
    # target verify: 5 tokens in parallel through the 7B stack
    v = g.dsp("verify_embed", OpType.GATHER, elems=5 * 4096,
              precision=Precision.FP16, preds=[x])
    v = _decoder_stack(g, v, 32, 5, 4096, 32, 32, 11008, Precision.FP16,
                       kv_len=261)
    n = g.dsp("final_norm", OpType.RMSNORM, elems=5 * 4096, preds=[v])
    hd = g.add(OpNode("lm_head", OpType.MATMUL, m=5, k=4096, n=32000,
                      precision=Precision.FP16), [n])
    g.dsp("accept_reject", OpType.REDUCE, elems=5 * 32000, preds=[hd])
    return g


def mixtral(precision: Precision = Precision.FP16, s: int = 256) -> WorkloadGraph:
    """Mixtral 8x7B: GQA(32q/8kv), 8 experts top-2, d=4096, d_ff=14336."""
    g = WorkloadGraph(f"mixtral_{precision.name.lower()}",
                      model_precision=precision, family="moe")
    d, dff, n_exp, topk = 4096, 14336, 8, 2
    x = g.dsp("embed_lookup", OpType.GATHER, elems=s * d, precision=Precision.FP16)
    for li in range(32):
        x = attention_block(g, f"l{li}", x, s, d, 32, 8, precision,
                            norm=OpType.RMSNORM, rope=True)
        n2 = g.dsp(f"l{li}_norm2", OpType.RMSNORM, elems=s * d, preds=[x])
        router = g.add(OpNode(f"l{li}_router", OpType.FC, m=s, k=d, n=n_exp,
                              precision=Precision.FP16), [n2])
        gate = g.dsp(f"l{li}_routing_softmax", OpType.SOFTMAX, elems=s * n_exp,
                     preds=[router])
        disp = g.dsp(f"l{li}_dispatch", OpType.GATHER, elems=s * d, preds=[gate, n2])
        outs = []
        tok_per_exp = max(s * topk // n_exp, 1)
        for e in range(n_exp):
            up = g.add(OpNode(f"l{li}_e{e}_gate_up", OpType.MATMUL,
                              m=tok_per_exp, k=d, n=2 * dff, precision=precision), [disp])
            act = g.dsp(f"l{li}_e{e}_silu", OpType.SILU, elems=tok_per_exp * dff,
                        preds=[up])
            dn = g.add(OpNode(f"l{li}_e{e}_down", OpType.MATMUL, m=tok_per_exp,
                              k=dff, n=d, precision=precision), [act])
            outs.append(dn)
        comb = g.dsp(f"l{li}_combine", OpType.SCATTER, elems=s * topk * d,
                     preds=outs[:3])
        x = g.dsp(f"l{li}_residual2", OpType.ADD, elems=s * d, preds=[comb, x])
    n = g.dsp("final_norm", OpType.RMSNORM, elems=s * d, preds=[x])
    g.add(OpNode("lm_head", OpType.MATMUL, m=1, k=d, n=32000,
                 precision=precision), [n])
    return g


def llava(s_llm: int = 608) -> WorkloadGraph:
    """LLaVA: ViT-L/14 vision tower (24 blocks, 577 tokens) + projector +
    LLaMA-7B prefill over image+text tokens."""
    g = WorkloadGraph("llava", model_precision=Precision.FP16,
                      family="multimodal")
    sv, dv = 577, 1024
    x = g.add(OpNode("vision_patch_embed", OpType.CONV2D, m=576, k=3 * 14 * 14,
                     n=dv, precision=Precision.FP16))
    for li in range(24):
        x = attention_block(g, f"vis{li}", x, sv, dv, 16, 16, Precision.FP16)
        x = mlp_block(g, f"vis{li}", x, sv, dv, 4096, Precision.FP16, gated=False)
    p = g.add(OpNode("mm_projector", OpType.MATMUL, m=sv, k=dv, n=4096,
                     precision=Precision.FP16), [x])
    t = _decoder_stack(g, p, 32, s_llm, 4096, 32, 32, 11008, Precision.FP16)
    n = g.dsp("final_norm", OpType.RMSNORM, elems=s_llm * 4096, preds=[t])
    g.add(OpNode("lm_head", OpType.MATMUL, m=1, k=4096, n=32000,
                 precision=Precision.FP16), [n])
    return g


def rt2() -> WorkloadGraph:
    """RT-2 vision-language-action: ViT backbone + LLM + action
    de-tokenization (gather/scatter + polynomial trajectory smoothing) —
    the multimodal operator mix NVDLA cannot execute (paper §5.1.4)."""
    g = WorkloadGraph("rt2", model_precision=Precision.FP16,
                      family="multimodal")
    sv, dv = 256, 1024
    x = g.add(OpNode("vision_patch_embed", OpType.CONV2D, m=sv, k=3 * 16 * 16,
                     n=dv, precision=Precision.FP16))
    for li in range(12):
        x = attention_block(g, f"vis{li}", x, sv, dv, 16, 16, Precision.FP16)
        x = mlp_block(g, f"vis{li}", x, sv, dv, 4096, Precision.FP16, gated=False)
    t = _decoder_stack(g, x, 20, 288, 2048, 16, 16, 8192, Precision.FP16)
    act = g.dsp("action_gather", OpType.GATHER, elems=8 * 256, preds=[t])
    sm = g.dsp("action_softmax", OpType.SOFTMAX, elems=8 * 256, preds=[act])
    po = g.add(OpNode("trajectory_poly", OpType.POLY, elems=8 * 64,
                      poly_degree=5, precision=Precision.FP16), [sm])
    g.dsp("action_scatter", OpType.SCATTER, elems=8 * 64, preds=[po])
    return g


def lavish(timesteps_fft: int = 1) -> WorkloadGraph:
    """LAVISH audio-visual transformer: audio spectrogram FFT frontend,
    dual ViT-B streams with cross-modal adapters."""
    g = WorkloadGraph("lavish", model_precision=Precision.FP16,
                      family="multimodal")
    # audio frontend: 1 s of 16 kHz audio -> STFT frames (n_fft=512)
    fft = g.add(OpNode("audio_stft", OpType.FFT, elems=128 * 512, fft_n=512,
                       precision=Precision.FP16))
    a = g.add(OpNode("audio_patch_embed", OpType.CONV2D, m=128, k=512, n=768,
                     precision=Precision.FP16), [fft])
    v = g.add(OpNode("visual_patch_embed", OpType.CONV2D, m=196,
                     k=3 * 16 * 16, n=768, precision=Precision.FP16))
    for li in range(12):
        a = attention_block(g, f"aud{li}", a, 128, 768, 12, 12, Precision.FP16)
        v = attention_block(g, f"vis{li}", v, 197, 768, 12, 12, Precision.FP16)
        # LAVISH adapter: cross-modal token exchange with a sigmoid gate
        xa = attention_block(g, f"xmod{li}", v, 197, 768, 12, 12,
                             Precision.FP16, cross_from=a)
        xa = g.dsp(f"xmod{li}_gate_sigmoid", OpType.SIGMOID, elems=197 * 768,
                   preds=[xa])
        a = mlp_block(g, f"aud{li}", a, 128, 768, 3072, Precision.FP16, gated=False)
        v = mlp_block(g, f"vis{li}", xa, 197, 768, 3072, Precision.FP16, gated=False)
    fuse = g.dsp("av_fuse", OpType.ADD, elems=197 * 768, preds=[a, v])
    c = g.add(OpNode("classifier", OpType.FC, m=1, k=768, n=309,
                     precision=Precision.FP16), [fuse])
    g.dsp("softmax_out", OpType.SOFTMAX, elems=309, preds=[c])
    return g
