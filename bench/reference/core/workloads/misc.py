"""KAN and GNN-GAT workloads (paper Table 1)."""
from __future__ import annotations

from ..ir import OpNode, OpType, Precision, WorkloadGraph

__all__ = ["kan", "gnn_gat"]


def kan(widths=(784, 512, 512, 10), degree: int = 8) -> WorkloadGraph:
    """Kolmogorov-Arnold network: every edge evaluates a learnable
    polynomial basis — wall time is entirely polynomial evaluation on
    commercial NPUs (paper Fig. 3).  A Special-Function tile reduces each
    edge to a d-cycle Horner pipeline (paper §2.5)."""
    g = WorkloadGraph("kan", model_precision=Precision.FP16, family="kan")
    x = None
    for li, (w_in, w_out) in enumerate(zip(widths[:-1], widths[1:])):
        preds = [x] if x is not None else ()
        # per-edge basis evaluation: w_in*w_out polynomials of degree d
        p = g.add(OpNode(f"l{li}_edge_poly", OpType.POLY, elems=w_in * w_out,
                         poly_degree=degree, precision=Precision.FP16), preds)
        # node aggregation: sum over incoming edges
        x = g.dsp(f"l{li}_aggregate", OpType.REDUCE, elems=w_in * w_out,
                  preds=[p])
    g.dsp("softmax_out", OpType.SOFTMAX, elems=widths[-1], preds=[x])
    return g


def gnn_gat(nodes: int = 10000, edges: int = 100000, d: int = 256,
            layers: int = 3, heads: int = 4) -> WorkloadGraph:
    """Graph attention network: gather/scatter dominates (paper Fig. 3;
    MAC utilization < 10 % on commercial NPUs).  Feature transforms are
    INT8-compatible, which is why GNN-GAT clusters with the INT-quantized
    group in the taxonomy (§5.3)."""
    g = WorkloadGraph("gnn_gat", model_precision=Precision.INT8,
                      family="gnn")
    x = None
    for li in range(layers):
        preds = [x] if x is not None else ()
        w = g.add(OpNode(f"l{li}_feature_transform", OpType.MATMUL, m=nodes,
                         k=d, n=d, precision=Precision.INT8), preds)
        gth = g.dsp(f"l{li}_edge_gather", OpType.GATHER, elems=edges * d,
                    preds=[w])
        att = g.dsp(f"l{li}_edge_attention", OpType.MUL,
                    elems=edges * heads * 2, preds=[gth])
        sm = g.dsp(f"l{li}_edge_softmax", OpType.SOFTMAX, elems=edges * heads,
                   preds=[att])
        agg = g.dsp(f"l{li}_scatter_aggregate", OpType.SCATTER, elems=edges * d,
                    preds=[sm, gth])
        x = g.dsp(f"l{li}_relu", OpType.RELU, elems=nodes * d, preds=[agg])
    g.dsp("readout", OpType.REDUCE, elems=nodes * d, preds=[x])
    return g
