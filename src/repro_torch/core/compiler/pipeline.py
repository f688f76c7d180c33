"""The compiler's entry point: runs the four ordered passes (paper §3.2)
and returns an ExecutionPlan for the simulator, plus the plan -> op-table
lowering consumed by the batched simulator backend.

Port of ``repro/core/compiler/pipeline.py``.  Two exact compile paths
exist, selected by how many candidates you have:

* **Per-candidate (this module)** -- ``compile_workload`` runs the host
  passes (deepcopy -> ``assign_precision`` -> ``fuse`` -> ``map_graph``
  -> ``emit_schedule``) for one (workload, chip) pair; ``lower_plan``
  flattens the result into the ``PlanTensor`` op-table that
  ``simulator.batched.batch_simulate`` executes on the card.  This is the
  oracle-reference path: it keeps the graph objects, so ``ChipSim`` can
  replay it with per-op traces.
* **Compile-free batched (``compiler.batched_mapper``)** -- the same
  Eq. 1-3 mapping decisions for (B, MAX_TILES) tile tensors on the card,
  emitting the stacked placement arrays directly; placements equal
  ``map_graph``'s.

``dse.engine.EvalEngine`` picks between them: ``backend="batched"`` and
``rescore()`` default to the compile-free path, ``exact_mapper="python"``
forces this module's per-candidate pipeline, and ``backend="oracle"``
walks ``ChipSim`` on ``map_graph`` placements.  ``plan_from_arrays``
rebuilds an ``ExecutionPlan`` from one candidate's stacked placement
arrays, so the oracle can replay a batched-mapper result.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from ..arch import ChipConfig
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..ir import (AXIS_CODES, PlanTensor, WorkloadGraph, bucket_ops,
                  placement_rows)
from ..simulator.orchestrator import ExecutionPlan, Placement
from .fusion import fuse
from .mapper import map_graph
from .precision import assign_precision
from .schedule import emit_schedule

__all__ = ["compile_workload", "lower_plan", "compile_to_table",
           "plan_from_arrays"]


def compile_workload(g: WorkloadGraph, chip: ChipConfig,
                     calib: CalibrationTable = DEFAULT_CALIB,
                     aggressive_int4: bool = False,
                     enable_fusion: bool = True,
                     enable_split: bool = True,
                     mode: str = "latency") -> ExecutionPlan:
    """Compile a (workload, architecture) pair into an execution plan.

    The input graph is deep-copied: passes 1-2 mutate node precision and
    fusion tags, and the same workload object is reused across thousands of
    candidate architectures during DSE.
    """
    g = copy.deepcopy(g)
    g = assign_precision(g, aggressive_int4=aggressive_int4)
    if enable_fusion:
        g = fuse(g)
    placements = map_graph(g, chip, calib, enable_split=enable_split)
    return emit_schedule(g, placements, mode=mode)


def lower_plan(plan: ExecutionPlan, num_tiles: int,
               max_ops: Optional[int] = None) -> PlanTensor:
    """Lower a compiled plan into the fixed-shape SoA op-table executed by
    ``simulator.batched``.

    Ops are padded to ``max_ops`` rows (default: the 64-multiple bucket of
    the graph length, the reference's op-table layout).
    Placements become integer arrays: ``owner`` (= ``Placement.tiles[0]``),
    ``n_split`` / ``split_axis`` / per-slot ``split_mask`` for Eq. 3 split
    executions.  Config-independent auxiliaries (per-pred byte shares,
    fused-group PPM energy and Eq. 6 refunds, total MACs) ride along in
    ``aux`` so the executor needs no graph object.
    """
    g = plan.graph
    n = len(g.nodes)
    cap = max_ops or bucket_ops(n)
    t = g.to_tensor(max_ops=cap)

    owner = np.full(cap, -1, np.int32)
    n_split = np.zeros(cap, np.int32)
    split_axis = np.full(cap, -1, np.int32)
    split_mask = np.zeros((cap, num_tiles), np.int8)
    for i, pl in plan.placements.items():
        owner[i] = pl.tiles[0]
        n_split[i] = len(pl.tiles)
        split_axis[i] = AXIS_CODES[pl.axis] if len(pl.tiles) > 1 else -1
        split_mask[i, list(pl.tiles)] = 1

    num_preds = (t.preds >= 0).sum(axis=1).astype(np.float64)
    fused_lane_ops = np.zeros(cap)
    fused_refund_b = np.zeros(cap)
    for j, nd in enumerate(g.nodes):
        if nd.fused_into >= 0:
            fused_lane_ops[nd.fused_into] += nd.elems * 2.0
            fused_refund_b[nd.fused_into] += 2.0 * nd.bytes_out
    aux = {
        "num_preds": num_preds,
        "per_pred_bytes": t.arrays["bytes_in"] / np.maximum(num_preds, 1.0),
        "fused_lane_ops": fused_lane_ops,
        "fused_refund_bytes": fused_refund_b,
        "total_macs": np.float64(sum(nd.macs for nd in g.nodes
                                     if nd.fused_into < 0)),
    }
    table = PlanTensor(ops=t, owner=owner, n_split=n_split,
                       split_axis=split_axis, split_mask=split_mask,
                       num_tiles=num_tiles, aux=aux, mode=plan.mode)
    table.validate()
    return table


def compile_to_table(g: WorkloadGraph, chip: ChipConfig,
                     calib: CalibrationTable = DEFAULT_CALIB,
                     max_ops: Optional[int] = None,
                     **compile_kwargs) -> PlanTensor:
    """``compile_workload`` + ``lower_plan`` in one step.

    The per-candidate exact path (full host passes per call).  At
    population scale prefer ``compiler.batched_mapper.map_and_simulate``,
    which makes the same placement decisions without any per-candidate
    host work.
    """
    plan = compile_workload(g, chip, calib, **compile_kwargs)
    return lower_plan(plan, chip.num_tiles, max_ops=max_ops)


def plan_from_arrays(g: WorkloadGraph, owner: np.ndarray,
                     n_split: np.ndarray, split_axis: np.ndarray,
                     split_mask: np.ndarray,
                     mode: str = "latency") -> ExecutionPlan:
    """Rebuild an ``ExecutionPlan`` from ONE candidate's stacked placement
    arrays (a ``batched_map`` row, or a ``PlanTensor``'s fields) so the
    ``ChipSim`` oracle can replay a batched-mapper result with full per-op
    traces.  ``g`` must be the prepared graph the arrays were mapped from
    (passes 1-2 already applied)."""
    placements = {
        i: Placement(list(tiles), axis)
        for i, (tiles, axis) in placement_rows(
            owner, n_split, split_axis, split_mask).items()}
    return emit_schedule(g, placements, mode=mode)

