"""Pass 2 — operator fusion (paper §3.2).

A greedy left-to-right scan matches three-op (Conv+BN+Act, Conv+Add+Act)
and two-op (Conv+Act, Conv+Add, MatMul+Act, ...) patterns.  Matched groups
fold post-processing into the tile's post-processing module (PPM),
skipping the SRAM round-trip for intermediate tensors; the refund is
E_fuse = N_fused * 2*|out| * E_SRAM/B in Eq. 6.
"""
from __future__ import annotations

from typing import Dict, List

from ..ir import OpClass, OpType, WorkloadGraph

__all__ = ["fuse"]

_NORM_OPS = {int(OpType.LAYERNORM), int(OpType.RMSNORM)}
_ACT_OPS = {int(OpType.RELU), int(OpType.GELU), int(OpType.SILU),
            int(OpType.SIGMOID)}
_ELTWISE = {int(OpType.ADD), int(OpType.MUL)}
_POST_OPS = _NORM_OPS | _ACT_OPS | _ELTWISE


def _consumers(g: WorkloadGraph) -> Dict[int, List[int]]:
    out: Dict[int, List[int]] = {i: [] for i in range(len(g.nodes))}
    for i, nd in enumerate(g.nodes):
        for p in nd.preds:
            out[p].append(i)
    return out


def fuse(g: WorkloadGraph, max_group: int = 3) -> WorkloadGraph:
    cons = _consumers(g)
    for i, head in enumerate(g.nodes):
        if head.op_cls != OpClass.MAC or head.fused_into >= 0:
            continue
        tail = i
        for _ in range(max_group - 1):
            nxt = cons.get(tail, [])
            # fusable only when the intermediate has exactly one consumer
            if len(nxt) != 1:
                break
            j = nxt[0]
            cand = g.nodes[j]
            if (int(cand.op_type) not in _POST_OPS or cand.fused_into >= 0
                    or cand.op_cls != OpClass.DSP):
                break
            cand.fused_into = i
            head.fused_count += 1
            tail = j
    return g
