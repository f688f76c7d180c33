"""Host-side preparation of workloads and configs for the batched engine.

Port of the preparation half of ``repro/core/dse/batch_eval.py``
(``prepare_workload``, ``prepare_configs``).  Both are numpy host code
and give the reference's arrays exactly.  The reference module's
``scan`` evaluator (the approximate in-scan mapping behind
``backend="scan"``) is not ported yet.
"""
from __future__ import annotations

import copy
from typing import Dict, Sequence

import numpy as np

from ..arch import ChipConfig
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..compiler.fusion import fuse
from ..compiler.precision import assign_precision
from ..ir import WorkloadGraph, bucket_ops
from ..simulator.batched import stack_chip_configs

__all__ = ["prepare_workload", "prepare_configs"]


def prepare_workload(g: WorkloadGraph, aggressive_int4: bool = False,
                     enable_fusion: bool = True) -> Dict[str, np.ndarray]:
    """Run the config-independent compiler passes 1-2 and emit SoA arrays."""
    g = copy.deepcopy(g)
    g = assign_precision(g, aggressive_int4=aggressive_int4)
    if enable_fusion:
        g = fuse(g)
    t = g.to_tensor(max_ops=bucket_ops(len(g.nodes)))
    a = dict(t.arrays)
    a["preds"] = t.preds
    num_preds = (t.preds >= 0).sum(axis=1).astype(np.float64)
    a["num_preds"] = num_preds
    a["per_pred_bytes"] = a["bytes_in"] / np.maximum(num_preds, 1.0)
    # PPM energy + Eq. 6 refund for fused children, credited to the head
    fused_lane_ops = np.zeros(t.max_ops)
    fused_refund_b = np.zeros(t.max_ops)
    for nd in g.nodes:
        if nd.fused_into >= 0:
            fused_lane_ops[nd.fused_into] += nd.elems * 2.0
            fused_refund_b[nd.fused_into] += 2.0 * nd.bytes_out
    a["fused_lane_ops"] = fused_lane_ops
    a["fused_refund_bytes"] = fused_refund_b
    a["total_macs"] = np.float64(g.total_macs)
    return a


def prepare_configs(chips: Sequence[ChipConfig],
                    calib: CalibrationTable = DEFAULT_CALIB
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """Stack a list of chips into (B, MAX_TILES) / (B,) arrays."""
    return stack_chip_configs(chips, calib)
