"""Pass 4 — schedule emission (paper §3.2).

Converts the per-op mapping into an execution schedule.  *Latency* mode
parallelizes distinct-tile assignments (the orchestrator's per-tile finish
times realize the overlap); *throughput* mode pipelines successive
batches through the same placements and is scored by the steady-state
initiation interval (``simulator.costs.pipeline_bounds``) instead of the
one-batch makespan.

``ExecutionPlan.mode`` dispatches downstream: ``ChipSim.run`` attaches
the pipeline steady state (II, fill latency, bottleneck bounds,
steady-state energy) to its result for throughput plans, the batched
executor carries the mode through ``PlanTensor`` / ``stack_plan_tables``,
and every backend raises ``ValueError`` on a mode it cannot model rather
than silently returning latency numbers.

Port of ``repro/core/compiler/schedule.py`` (host code).
"""
from __future__ import annotations

from typing import Dict

from ..ir import WorkloadGraph
from ..simulator.orchestrator import (SCHEDULE_MODES, ExecutionPlan,
                                      Placement)

__all__ = ["emit_schedule", "SCHEDULE_MODES"]


def emit_schedule(g: WorkloadGraph, placements: Dict[int, Placement],
                  mode: str = "latency") -> ExecutionPlan:
    if mode not in SCHEDULE_MODES:
        raise ValueError(f"unknown schedule mode {mode!r}; expected one of "
                         f"{SCHEDULE_MODES}")
    # topological order is preserved by construction; validate coverage
    for i, nd in enumerate(g.nodes):
        if nd.fused_into < 0 and i not in placements:
            raise ValueError(f"{g.name}: op {i} has no placement")
    return ExecutionPlan(graph=g, placements=placements, mode=mode)
