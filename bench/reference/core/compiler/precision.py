"""Pass 1 — mixed-precision assignment (paper §3.2).

Default policy: Conv/MatMul/Pool -> INT8; LayerNorm/RMSNorm/Softmax/SNN/
FFT/polynomial/SSM-scan -> FP16.  A name-based override forces FP16 on
accuracy-sensitive layers (attention QKV/output projection, LM head,
classifier, embedding).  An aggressive mode demotes all convolutions to
INT4.

The policy is gated by the precision the workload *ships in* (Table 1):
post-training-quantized variants carry INT8/INT4 MAC operands; in
FP16-shipped models the compiler still demotes the "quantizable matmul
fragments" (FFN up/down projections — paper §5.3's off-loading mechanism)
to INT8 while attention and accuracy-sensitive ops stay FP16.
"""
from __future__ import annotations

import re
from typing import Optional

from ..ir import OpClass, OpType, Precision, WorkloadGraph, PRECISION_BYTES

__all__ = ["assign_precision", "ACCURACY_SENSITIVE_RE"]

# attention QKV / output projection, LM head, classifier, embedding
ACCURACY_SENSITIVE_RE = re.compile(
    r"(qkv|q_proj|k_proj|v_proj|o_proj|out_proj|attn_out|lm_head|classifier|"
    r"embed|logits)", re.IGNORECASE)

_FP16_MIN_OPS = frozenset({
    int(OpType.SOFTMAX), int(OpType.LAYERNORM), int(OpType.RMSNORM),
    int(OpType.SSM_SCAN), int(OpType.FFT), int(OpType.SNN_LIF),
    int(OpType.POLY),
})

# "quantizable matmul fragments" (paper §5.3): FFN matmuls the default
# policy demotes to INT8 even in FP16-shipped models
QUANTIZABLE_FRAGMENT_RE = re.compile(
    r"(gate_up|ffn_up|ffn_down|fc1|fc2|mlp|shared_up|shared_down|"
    r"e\d+_down|l\d+_down|_ffn|in_proj)", re.IGNORECASE)


def _rescale_bytes(node, old_p: Precision) -> None:
    """Re-derive operand byte counts after a precision change."""
    ratio = PRECISION_BYTES[node.precision] / PRECISION_BYTES[old_p]
    node.bytes_in = int(node.bytes_in * ratio)
    node.bytes_w = int(node.bytes_w * ratio)
    node.bytes_out = int(node.bytes_out * ratio)


def assign_precision(g: WorkloadGraph, aggressive_int4: bool = False) -> WorkloadGraph:
    ship = g.model_precision
    mac_target: Optional[Precision] = None
    if ship == Precision.INT8:
        mac_target = Precision.INT8
    elif ship == Precision.INT4:
        mac_target = Precision.INT4
    if aggressive_int4:
        mac_target = Precision.INT4

    for node in g.nodes:
        old = node.precision
        if node.op_cls == OpClass.MAC:
            if node.accuracy_sensitive or ACCURACY_SENSITIVE_RE.search(node.name):
                node.accuracy_sensitive = True
                node.precision = Precision.FP16
            elif mac_target is not None:
                node.precision = mac_target
            elif int(node.precision) >= int(Precision.FP16) \
                    and QUANTIZABLE_FRAGMENT_RE.search(node.name):
                node.precision = Precision.INT8
        else:
            # vector / special operators run at >= FP16 (default policy)
            if int(node.op_type) in _FP16_MIN_OPS and int(node.precision) < int(Precision.FP16):
                node.precision = Precision.FP16
        if node.precision != old:
            _rescale_bytes(node, old)
    return g
