"""Orchestrator constants shared by the batched simulator and the engine.

In ``repro`` this module holds ``ChipSim``, the per-candidate Python
oracle.  The port has not brought the oracle over yet; it lands in this
same file in a later slice.  For now the file carries what
``simulator.batched`` and ``dse.engine`` import from it: the schedule
modes, the activation-cache fraction and the hop-count model.
"""
from __future__ import annotations

import math

from ..arch import Interconnect
from .costs import CACHE_FRAC

__all__ = ["noc_hops", "CACHE_FRAC", "SCHEDULE_MODES"]

# The two §3.2 execution modes.
SCHEDULE_MODES = ("latency", "throughput")


def noc_hops(interconnect: Interconnect, num_tiles: int) -> int:
    """Average hop count by interconnect topology."""
    if interconnect == Interconnect.BUS:
        return 1
    if interconnect == Interconnect.RING:
        return max(num_tiles // 4, 1)
    if interconnect == Interconnect.NOC:
        return 2
    return max(int(math.ceil(math.sqrt(num_tiles))), 1)  # mesh
