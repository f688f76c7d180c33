"""Perf-tuning knobs (a port of ``repro/launch/tuning.py``, with the same
four knobs and defaults).

Each knob is a module-level cell the launcher sets before a run: the
LM layers read ``ssd_chunk`` and ``moe_dispatch_bf16``; the dry-run
(``launch.dryrun``) reads ``act_mode`` for the residual-stream
constraint and ``microbatches`` for the train step
(``train.step.make_grads_fn(microbatches=)``), and measures the effect on
the roofline terms (``launch.hillclimb``'s cell mode).
"""
from __future__ import annotations

import dataclasses

__all__ = ["PerfKnobs", "KNOBS", "set_knobs"]


@dataclasses.dataclass
class PerfKnobs:
    # residual-stream constraint between layer periods:
    #   "seq"    -- (batch, "model", None): sequence parallelism (baseline)
    #   "dmodel" -- (batch, None, "model"): shard d_model instead
    #   "batch"  -- (batch, None, None): batch-only (no SP)
    act_mode: str = "seq"
    # Mamba2 SSD chunk length (intra-chunk working set is O(chunk^2))
    ssd_chunk: int = 64
    # MoE dispatch tensors in bf16 instead of f32
    moe_dispatch_bf16: bool = False
    # gradient-accumulation microbatches in the train step
    microbatches: int = 1


KNOBS = PerfKnobs()


def set_knobs(**kw) -> PerfKnobs:
    global KNOBS
    KNOBS = dataclasses.replace(PerfKnobs(), **kw)
    return KNOBS
