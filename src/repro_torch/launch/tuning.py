"""The tuning knobs that the LM layers read, copied from
``repro/launch/tuning.py`` with the same defaults.

Only the two knobs on the serving path are kept: the Mamba2 SSD chunk
length and the precision of the MoE dispatch tensors.
"""
from __future__ import annotations

import dataclasses

__all__ = ["PerfKnobs", "KNOBS", "set_knobs"]


@dataclasses.dataclass
class PerfKnobs:
    # Mamba2 SSD chunk length (intra-chunk working set is O(chunk^2))
    ssd_chunk: int = 64
    # MoE dispatch tensors in bf16 instead of f32
    moe_dispatch_bf16: bool = False


KNOBS = PerfKnobs()


def set_knobs(**kw) -> PerfKnobs:
    global KNOBS
    KNOBS = dataclasses.replace(PerfKnobs(), **kw)
    return KNOBS
