"""SSM-family workloads: Mamba-370M, Hyena-1.3B, Nemotron-H (paper Table 1).

The SSM scan is a DSP-class op with a sequence-length sequential multiplier
(paper §3.3.1); Hyena's long convolutions run through FFT — lowered onto
the MAC array on homogeneous chips (~30 % of wall time, Fig. 3) but served
natively by a Special-Function tile.
"""
from __future__ import annotations

from ..ir import OpNode, OpType, Precision, WorkloadGraph
from .transformer import attention_block, mlp_block

__all__ = ["mamba_370m", "hyena_1_3b", "nemotron_h", "mamba_block"]


def mamba_block(g: WorkloadGraph, pre: str, x: int, s: int, d: int,
                d_state: int, prec: Precision, expand: int = 2) -> int:
    """Selective-SSM block: in_proj -> causal conv1d -> selective scan ->
    gated SiLU -> out_proj."""
    di = expand * d
    n1 = g.dsp(f"{pre}_norm", OpType.RMSNORM, elems=s * d, preds=[x])
    ip = g.add(OpNode(f"{pre}_in_proj", OpType.MATMUL, m=s, k=d, n=2 * di,
                      precision=prec), [n1])
    # causal conv over channels is depthwise (one filter per channel)
    cv = g.add(OpNode(f"{pre}_dwconv", OpType.DWCONV, m=s * di, k=4, n=1,
                      precision=prec), [ip])
    sc = g.add(OpNode(f"{pre}_ssm_scan", OpType.SSM_SCAN, elems=s * di * d_state,
                      seq_len=s, precision=Precision.FP16), [cv])
    gt = g.dsp(f"{pre}_gate_silu", OpType.SILU, elems=s * di, preds=[sc, ip])
    op = g.add(OpNode(f"{pre}_out_proj", OpType.MATMUL, m=s, k=di, n=d,
                      precision=prec), [gt])
    return g.dsp(f"{pre}_residual", OpType.ADD, elems=s * d, preds=[op, x])


def mamba_370m(s: int = 1024) -> WorkloadGraph:
    """Mamba-370M: 48 layers, d=1024, state 16."""
    g = WorkloadGraph("mamba_370m", model_precision=Precision.FP16,
                      family="ssm")
    x = g.dsp("embed_lookup", OpType.GATHER, elems=s * 1024,
              precision=Precision.FP16)
    for li in range(48):
        x = mamba_block(g, f"l{li}", x, s, 1024, 16, Precision.FP16)
    n = g.dsp("final_norm", OpType.RMSNORM, elems=s * 1024, preds=[x])
    g.add(OpNode("lm_head", OpType.MATMUL, m=1, k=1024, n=50280,
                 precision=Precision.FP16), [n])
    return g


def hyena_1_3b(s: int = 1024) -> WorkloadGraph:
    """Hyena-1.3B: long convolutions via FFT (order-2 operator): per layer
    three projections, an FFT long-conv per channel (length-2S padded), and
    multiplicative gating."""
    g = WorkloadGraph("hyena_1_3b", model_precision=Precision.FP16,
                      family="ssm")
    d, layers = 2048, 24
    fft_n = 2 * s  # zero-padded circular convolution
    x = g.dsp("embed_lookup", OpType.GATHER, elems=s * d,
              precision=Precision.FP16)
    for li in range(layers):
        pre = f"l{li}"
        n1 = g.dsp(f"{pre}_norm", OpType.LAYERNORM, elems=s * d, preds=[x])
        pr = g.add(OpNode(f"{pre}_projections", OpType.MATMUL, m=s, k=d,
                          n=3 * d, precision=Precision.FP16), [n1])
        sh = g.add(OpNode(f"{pre}_short_conv", OpType.CONV1D, m=s * 3 * d, k=3,
                          n=1, precision=Precision.FP16), [pr])
        # forward FFT over every channel, filter multiply, inverse FFT
        ff = g.add(OpNode(f"{pre}_fft_fwd", OpType.FFT, elems=d * fft_n,
                          fft_n=fft_n, precision=Precision.FP16), [sh])
        fm = g.dsp(f"{pre}_filter_mul", OpType.MUL, elems=d * fft_n, preds=[ff])
        fi = g.add(OpNode(f"{pre}_fft_inv", OpType.FFT, elems=d * fft_n,
                          fft_n=fft_n, precision=Precision.FP16), [fm])
        gt = g.dsp(f"{pre}_gate_mul", OpType.MUL, elems=s * d, preds=[fi, pr])
        op = g.add(OpNode(f"{pre}_out_proj", OpType.MATMUL, m=s, k=d, n=d,
                          precision=Precision.FP16), [gt])
        x = g.dsp(f"{pre}_residual", OpType.ADD, elems=s * d, preds=[op, x])
    n = g.dsp("final_norm", OpType.LAYERNORM, elems=s * d, preds=[x])
    g.add(OpNode("lm_head", OpType.MATMUL, m=1, k=d, n=50280,
                 precision=Precision.FP16), [n])
    return g


def nemotron_h(precision: Precision = Precision.FP16, s: int = 256) -> WorkloadGraph:
    """Nemotron-H-style hybrid attention/SSM LLM: 48 blocks, 4 attention +
    44 Mamba2 blocks interleaved (the across-layers heterogeneity scope of
    §2.3), d=4096."""
    g = WorkloadGraph(f"nemotron_h_{precision.name.lower()}",
                      model_precision=precision, family="hybrid")
    d = 4096
    x = g.dsp("embed_lookup", OpType.GATHER, elems=s * d,
              precision=Precision.FP16)
    for li in range(48):
        if li % 12 == 5:  # sparse attention interleave
            x = attention_block(g, f"l{li}", x, s, d, 32, 8, precision,
                                norm=OpType.RMSNORM, rope=True)
            x = mlp_block(g, f"l{li}", x, s, d, 14336, precision,
                          norm=OpType.RMSNORM)
        else:
            x = mamba_block(g, f"l{li}", x, s, d, 64, precision)
    n = g.dsp("final_norm", OpType.RMSNORM, elems=s * d, preds=[x])
    g.add(OpNode("lm_head", OpType.MATMUL, m=1, k=d, n=131072,
                 precision=precision), [n])
    return g
