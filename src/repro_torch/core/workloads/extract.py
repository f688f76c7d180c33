"""Extraction: the LM substrate's ten architectures -> MOSAIC workload
DAGs.

Port of ``repro/core/workloads/extract.py``, host code over the port's
own ``ir`` and ``models/config``.  The paper imports workloads from
ONNX/PyTorch (§3.1); this walks a ``ModelConfig``'s layer pattern and
emits the operator vocabulary the rest of MOSAIC consumes, so the models
that the port serves and trains are also DSE inputs for
heterogeneous-NPU search.  The graphs equal the reference's op for op
(names, types, dims, precisions, predecessors;
tests/test_torch_extract.py).
"""
from __future__ import annotations

from typing import Optional

from ...models.config import ModelConfig
from ..ir import OpNode, OpType, Precision, WorkloadGraph

__all__ = ["extract_model"]


def _attn_ops(g, pre, x, s, d, heads, kv_heads, hd, prec, kv_len=None):
    kv_len = kv_len or s
    n1 = g.dsp(f"{pre}_norm", OpType.RMSNORM, elems=s * d, preds=[x])
    q = g.add(OpNode(f"{pre}_q_proj", OpType.MATMUL, m=s, k=d, n=heads * hd,
                     precision=prec), [n1])
    kk = g.add(OpNode(f"{pre}_k_proj", OpType.MATMUL, m=s, k=d,
                      n=kv_heads * hd, precision=prec), [n1])
    v = g.add(OpNode(f"{pre}_v_proj", OpType.MATMUL, m=s, k=d,
                     n=kv_heads * hd, precision=prec), [n1])
    r = g.dsp(f"{pre}_rope", OpType.ROPE, elems=s * heads * hd, preds=[q, kk])
    sc = g.add(OpNode(f"{pre}_scores", OpType.MATMUL, m=heads * s, k=hd,
                      n=kv_len, precision=Precision.FP16, splittable=False), [r, kk])
    sm = g.dsp(f"{pre}_softmax", OpType.SOFTMAX, elems=heads * s * kv_len,
               preds=[sc])
    av = g.add(OpNode(f"{pre}_attn_v", OpType.MATMUL, m=heads * s, k=kv_len,
                      n=hd, precision=Precision.FP16, splittable=False), [sm, v])
    o = g.add(OpNode(f"{pre}_o_proj", OpType.MATMUL, m=s, k=heads * hd, n=d,
                     precision=prec), [av])
    return g.dsp(f"{pre}_residual", OpType.ADD, elems=s * d, preds=[o, x])


def _mla_ops(g, pre, x, s, cfg, prec):
    d, h = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    n1 = g.dsp(f"{pre}_norm", OpType.RMSNORM, elems=s * d, preds=[x])
    q = g.add(OpNode(f"{pre}_q_proj", OpType.MATMUL, m=s, k=d,
                     n=h * (dn + dr), precision=prec), [n1])
    ck = g.add(OpNode(f"{pre}_kv_compress", OpType.MATMUL, m=s, k=d, n=r + dr,
                      precision=prec), [n1])
    uk = g.add(OpNode(f"{pre}_kv_decompress", OpType.MATMUL, m=s, k=r,
                      n=h * (dn + dv), precision=prec), [ck])
    sc = g.add(OpNode(f"{pre}_scores", OpType.MATMUL, m=h * s, k=dn + dr, n=s,
                      precision=Precision.FP16, splittable=False), [q, uk])
    sm = g.dsp(f"{pre}_softmax", OpType.SOFTMAX, elems=h * s * s, preds=[sc])
    av = g.add(OpNode(f"{pre}_attn_v", OpType.MATMUL, m=h * s, k=s, n=dv,
                      precision=Precision.FP16, splittable=False), [sm, uk])
    o = g.add(OpNode(f"{pre}_o_proj", OpType.MATMUL, m=s, k=h * dv, n=d,
                     precision=prec), [av])
    return g.dsp(f"{pre}_residual", OpType.ADD, elems=s * d, preds=[o, x])


def _mamba_ops(g, pre, x, s, cfg, prec):
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    n1 = g.dsp(f"{pre}_norm", OpType.RMSNORM, elems=s * d, preds=[x])
    ip = g.add(OpNode(f"{pre}_in_proj", OpType.MATMUL, m=s, k=d,
                      n=2 * di + 2 * n + cfg.ssm_heads, precision=prec), [n1])
    cv = g.add(OpNode(f"{pre}_conv1d", OpType.CONV1D,
                      m=s * (di + 2 * n), k=cfg.ssm_conv_width, n=1,
                      precision=prec), [ip])
    sc = g.add(OpNode(f"{pre}_ssd_scan", OpType.SSM_SCAN,
                      elems=s * di * n, seq_len=s,
                      precision=Precision.FP16), [cv])
    gt = g.dsp(f"{pre}_gate_silu", OpType.SILU, elems=s * di, preds=[sc, ip])
    op = g.add(OpNode(f"{pre}_out_proj", OpType.MATMUL, m=s, k=di, n=d,
                      precision=prec), [gt])
    return g.dsp(f"{pre}_residual", OpType.ADD, elems=s * d, preds=[op, x])


def _ffn_ops(g, pre, x, s, cfg, kind, prec):
    d = cfg.d_model
    n2 = g.dsp(f"{pre}_norm2", OpType.RMSNORM, elems=s * d, preds=[x])
    if kind == "moe":
        e, k = cfg.n_experts, cfg.top_k
        f = cfg.moe_d_ff or cfg.d_ff
        router = g.add(OpNode(f"{pre}_router", OpType.FC, m=s, k=d, n=e,
                              precision=Precision.FP16), [n2])
        gate = g.dsp(f"{pre}_routing_softmax", OpType.SOFTMAX, elems=s * e,
                     preds=[router])
        disp = g.dsp(f"{pre}_dispatch", OpType.GATHER, elems=s * d,
                     preds=[gate, n2])
        tok = max(s * k // e, 1)
        outs = []
        for ei in range(min(e, 8)):  # representative expert slots
            up = g.add(OpNode(f"{pre}_e{ei}_gate_up", OpType.MATMUL,
                              m=tok * max(e // 8, 1), k=d, n=2 * f,
                              precision=prec), [disp])
            act = g.dsp(f"{pre}_e{ei}_silu", OpType.SILU,
                        elems=tok * max(e // 8, 1) * f, preds=[up])
            dn = g.add(OpNode(f"{pre}_e{ei}_down", OpType.MATMUL,
                              m=tok * max(e // 8, 1), k=f, n=d,
                              precision=prec), [act])
            outs.append(dn)
        comb = g.dsp(f"{pre}_combine", OpType.SCATTER, elems=s * k * d,
                     preds=outs[:3])
        last = comb
        if cfg.n_shared_experts:
            sh = g.add(OpNode(f"{pre}_shared_up", OpType.MATMUL, m=s, k=d,
                              n=2 * f * cfg.n_shared_experts, precision=prec), [n2])
            last = g.add(OpNode(f"{pre}_shared_down", OpType.MATMUL, m=s,
                                k=f * cfg.n_shared_experts, n=d,
                                precision=prec), [sh])
        return g.dsp(f"{pre}_residual2", OpType.ADD, elems=s * d,
                     preds=[last, x])
    if kind == "none":
        return x
    gated = cfg.act == "silu"
    up = g.add(OpNode(f"{pre}_ffn_up", OpType.MATMUL, m=s, k=d,
                      n=(2 if gated else 1) * cfg.d_ff, precision=prec), [n2])
    act = g.dsp(f"{pre}_act", OpType.SILU if gated else OpType.GELU,
                elems=s * cfg.d_ff, preds=[up])
    dn = g.add(OpNode(f"{pre}_ffn_down", OpType.MATMUL, m=s, k=cfg.d_ff, n=d,
                      precision=prec), [act])
    return g.dsp(f"{pre}_residual2", OpType.ADD, elems=s * d, preds=[dn, x])


def extract_model(cfg: ModelConfig, seq_len: int = 512,
                  precision: Precision = Precision.FP16) -> WorkloadGraph:
    """Emit the MOSAIC DAG of one single-batch inference pass of ``cfg``."""
    g = WorkloadGraph(f"{cfg.name}_s{seq_len}", model_precision=precision,
                      family=cfg.family)
    d, hd = cfg.d_model, cfg.head_dim
    x = g.dsp("embed_lookup", OpType.GATHER, elems=seq_len * d,
              precision=Precision.FP16)
    if cfg.encoder_layers:
        enc = g.dsp("audio_frontend_stub", OpType.GATHER,
                    elems=cfg.num_frontend_tokens * d)
        for li in range(cfg.encoder_layers):
            enc = _attn_ops(g, f"enc{li}", enc, cfg.num_frontend_tokens, d,
                            cfg.n_heads, cfg.n_kv_heads, hd, precision)
            enc = _ffn_ops(g, f"enc{li}", enc, cfg.num_frontend_tokens, cfg,
                           "dense", precision)
    layers = cfg.prefix_pattern() + cfg.pattern() * cfg.n_repeats
    for li, (mk, fk) in enumerate(layers):
        pre = f"l{li}"
        if mk == "mamba":
            x = _mamba_ops(g, pre, x, seq_len, cfg, precision)
        elif cfg.mla:
            x = _mla_ops(g, pre, x, seq_len, cfg, precision)
        elif mk == "cross_attn":
            x = _attn_ops(g, pre, x, seq_len, d, cfg.n_heads, cfg.n_kv_heads,
                          hd, precision, kv_len=cfg.num_frontend_tokens)
        else:
            x = _attn_ops(g, pre, x, seq_len, d, cfg.n_heads, cfg.n_kv_heads,
                          hd, precision)
        x = _ffn_ops(g, pre, x, seq_len, cfg, fk, precision)
    n = g.dsp("final_norm", OpType.RMSNORM, elems=seq_len * d, preds=[x])
    g.add(OpNode("lm_head", OpType.MATMUL, m=1, k=d, n=cfg.vocab,
                 precision=precision), [n])
    g.validate()
    return g
