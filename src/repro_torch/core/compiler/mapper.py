"""Pass 3 — DAG-aware mapping with op-splitting (paper §3.2, Eqs. 1-3).

Operators are visited in topological order.  For each operator o the
mapper filters tiles by op-type + precision compatibility, then for each
compatible tile T computes the earliest start time

    t_start(o,T) = max( tile_finish[T],
                        max_{(f_j,T_j) in preds(o)} ( f_j + 1[T_j != T] * d_NoC ) )

and the roofline cycle estimate (Eq. 2), placing o on the tile minimizing
*completion time* t_start + C_hat.  For splittable MAC-class ops with
multiple compatible MAC tiles it evaluates an even split along OC / B / IC
with the explicit reduce/concat cost of Eq. 3, accepting the split only if
its finish time beats single-tile placement.

Compatibility filters and roofline estimates are evaluated through the
shared ``simulator.costs.CostModel`` -- vectorized across the tile axis in
one numpy call per (op, bandwidth) query -- with values bitwise identical
to the per-tile ``TileSim`` wrappers.

Port of ``repro/core/compiler/mapper.py``.  This is host code: the
per-candidate compile runs the cost model's numpy path through a
``CostModel`` built on ``"cpu"``.  Its placements feed the ``ChipSim``
oracle and, lowered by ``compiler.pipeline.lower_plan``, the batched plan
executor on the card; ``compiler.batched_mapper`` makes the same
decisions for a whole population on the card.

Under a heterogeneous architecture this rule routes each op to the
smallest compatible tile (the paper's FP16-MATMUL->Big / INT8-Conv->any /
FFT->Special-Function behaviour) and partitions bulk MAC work across
Big+Little.  FP16-only ops on chips with one FP16-capable tile serialize --
visible in the 800 mm^2 regression the paper reports.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ..arch import ChipConfig
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..ir import OpClass, WorkloadGraph, slice_op
from ..simulator.costs import TILE_COST_KEYS, cost_model
from ..simulator.modules import HOST, tile_cost_dict
from ..simulator.orchestrator import Placement, noc_hops
from ..simulator.tile import _SFU_FOR_OP, op_cost_dict

__all__ = ["map_graph", "UnmappableError", "SPLIT_AXES"]

SPLIT_AXES = ("OC", "B", "IC")


class UnmappableError(RuntimeError):
    """No tile on the chip can execute some operator."""


def map_graph(g: WorkloadGraph, chip: ChipConfig,
              calib: CalibrationTable = DEFAULT_CALIB,
              enable_split: bool = True) -> Dict[int, Placement]:
    templates = chip.instances()
    n = len(templates)
    cm = cost_model(calib, HOST)
    # (n,) tile-field arrays: one vectorized CostModel query scores every
    # tile at once (bitwise equal to per-tile TileSim calls)
    dicts = [tile_cost_dict(t) for t in templates]
    T = {k: np.asarray([d[k] for d in dicts], np.float64)
         for k in TILE_COST_KEYS}
    # memo of the tile-only terms per op precision / sparsity / type
    # (``CostModel._cached``): the same values, computed once per chip
    T["_cache"] = {}
    clock_hz = T["clock_hz"]
    hops = noc_hops(chip.interconnect, n)
    ref_hz = chip.ref_clock_mhz * 1e6
    # static per-tile bandwidth share for the estimate domain; the
    # orchestrator replays with the dynamic N_active share (§3.3.4)
    bw_share = chip.dram_gbps / n

    def noc_s(nbytes: float) -> float:
        cycles = math.ceil(nbytes / chip.noc_bytes_per_cycle) \
            + hops * chip.noc_base_cycles
        return cycles / ref_hz

    tile_finish = [0.0] * n
    op_finish: Dict[int, float] = {}
    op_tile: Dict[int, int] = {}
    placements: Dict[int, Placement] = {}

    for i, op in enumerate(g.nodes):
        if op.fused_into >= 0:
            continue
        opd = op_cost_dict(op)
        # the op's class is known on the host: evaluate only its branch of
        # the cost model (``CostModel.*_cls``, the same bits)
        cls = int(op.op_cls)
        compat_mask = np.asarray(cm.supports_cls(T, opd, cls))
        compat = [t for t in range(n) if compat_mask[t]]
        if not compat:
            raise UnmappableError(
                f"{g.name}: op {i} ({op.name}, {op.op_type.name}, "
                f"prec={op.precision.name}) has no compatible tile on {chip.name}")
        # The compatibility filter routes special ops to Special-Function
        # tiles whenever the chip has one with the required SFU (paper §3.2:
        # "FFT -> Special-Function"); MAC/DSP lowering is only the fallback
        # on chips without the unit.
        if op.op_cls == OpClass.SPECIAL:
            native = [t for t in compat
                      if templates[t].sfu_mask & _SFU_FOR_OP[int(op.op_type)]]
            if native:
                compat = native

        per_pred = op.bytes_in / max(len(op.preds), 1)

        def t_start_on(t: int) -> float:
            dep = 0.0
            for p in op.preds:
                f = op_finish.get(p, 0.0)
                if op_tile.get(p, t) != t:
                    f += noc_s(per_pred)
                dep = max(dep, f)
            return max(tile_finish[t], dep)

        # --- single-tile candidates (Eq. 1 + Eq. 2) -------------------------
        c_hat_s = np.asarray(cm.roofline_cycles_cls(T, opd, bw_share, cls)) \
            / clock_hz
        best_t, best_fin, best_start = -1, float("inf"), 0.0
        for t in compat:
            ts = t_start_on(t)
            fin = ts + float(c_hat_s[t])
            # tie-break toward the smallest compatible tile
            if fin < best_fin - 1e-15 or (
                    abs(fin - best_fin) <= 1e-15 and best_t >= 0
                    and templates[t].num_macs < templates[best_t].num_macs):
                best_t, best_fin, best_start = t, fin, ts
        choice = Placement([best_t])
        choice_fin = best_fin

        # --- split candidates (Eq. 3) ---------------------------------------
        if (enable_split and op.op_cls == OpClass.MAC and op.splittable
                and op.macs > 0):
            mac_tiles = [t for t in compat if templates[t].num_macs > 0]
            if len(mac_tiles) > 1:
                k = len(mac_tiles)
                for axis in SPLIT_AXES:
                    sub = slice_op(op, axis, k)
                    ch_s = np.asarray(cm.roofline_cycles_mac(
                        T, op_cost_dict(sub), bw_share / k)) / clock_hz
                    fins = [t_start_on(t) + float(ch_s[t]) for t in mac_tiles]
                    # Eq. 3 reduce/concat cost over the NoC
                    fin = max(fins) + noc_s(op.bytes_out / k)
                    if fin < choice_fin:
                        choice = Placement(list(mac_tiles), axis)
                        choice_fin = fin

        placements[i] = choice
        owner = choice.tiles[0]
        if len(choice.tiles) == 1:
            tile_finish[owner] = choice_fin
        else:
            for t in choice.tiles:
                tile_finish[t] = max(tile_finish[t], choice_fin)
        op_finish[i] = choice_fin
        op_tile[i] = owner

    return placements
