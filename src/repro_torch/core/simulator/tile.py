"""Per-tile module pipeline (paper §3.3.1-§3.3.3) — the reference oracle.

Routes one compiled operator through one of the three execution paths
(MAC, DSP, Special-Function) of a tile, accumulating cycles and energy at
each of the seven modules, and combines them with the total-cycle model
(Eq. 5).  Operators that land on a tile lacking their natural unit are
*lowered* (paper §2.5): FFT onto the MAC array as an O(N^2) DFT matmul,
LIF and polynomial onto the DSP with their sequential multipliers, MAC ops
onto the DSP when a Special-Function tile must run a stray matmul.

Port of ``repro/core/simulator/tile.py``.  All arithmetic is delegated
to the shared ``simulator.costs`` CostModel -- the code the batched plan
executor runs on (B, MAX_TILES) tensors -- so the oracle and the batched
backends share one set of calibrated formulas.  This is host code: the
oracle evaluates the model's numpy path on Python floats through a
``CostModel`` built on ``"cpu"``, and no tensor enters it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..arch import TileTemplate, SFU_FFT, SFU_SNN, SFU_POLY
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..ir import OpNode, OpType
from .costs import cost_model
from .modules import HOST, tile_cost_dict
from .outputs import EnergyBreakdown

__all__ = ["TileSim", "OpExec", "op_cost_dict"]

_SFU_FOR_OP = {
    int(OpType.FFT): SFU_FFT,
    int(OpType.SNN_LIF): SFU_SNN,
    int(OpType.POLY): SFU_POLY,
}

_PATH_NAME = {0: "MAC", 1: "DSP", 2: "SFU"}
_ROOFLINE_NAME = {0: "compute", 1: "memory"}


def op_cost_dict(op: OpNode) -> Dict[str, float]:
    """OpNode -> the scalar field dict the shared CostModel reads."""
    return {
        "op_type": int(op.op_type),
        "op_cls": int(op.op_cls),
        "macs": float(op.macs),
        "elems": float(op.elems),
        "m": float(op.m),
        "k": float(op.k),
        "n": float(op.n),
        "precision": int(op.precision),
        "bytes_in": float(op.bytes_in),
        "bytes_w": float(op.bytes_w),
        "bytes_out": float(op.bytes_out),
        "act_sparsity": float(op.act_sparsity),
        "w_sparsity": float(op.w_sparsity),
        "fft_n": float(op.fft_n),
        "poly_degree": float(op.poly_degree),
        "snn_timesteps": float(op.snn_timesteps),
        "seq_len": float(op.seq_len),
    }


@dataclasses.dataclass
class OpExec:
    cycles: float
    seconds: float
    energy: EnergyBreakdown
    path: str
    roofline: str
    dram_rd: float
    dram_wr: float
    dram_bytes: float = 0.0  # burst-aligned rd+wr as charged (Eq. 5 stage)


class TileSim:
    """Analytical model of one tile instance (scalar CostModel frontend)."""

    def __init__(self, tile: TileTemplate, calib: CalibrationTable = DEFAULT_CALIB,
                 cache_frac: float = 0.25):
        self.tile = tile
        self.calib = calib
        self.cache_frac = cache_frac
        self.clock_hz = tile.clock_mhz * 1e6
        # SRAM staging bandwidth: banks x 16-byte word per cycle
        self.sram_bpc = max(tile.sram_banks, 1) * 16.0
        self._cm = cost_model(calib, HOST)
        self._T = tile_cost_dict(tile, cache_frac)

    # ------------------------------------------------------------------ API
    def supports(self, op: OpNode) -> bool:
        """Compatibility filter (paper §3.2): op-type and precision.

        The precision set is a property of the MAC datapath; the vector DSP
        and SFUs are FP16-native in every tile, so only ops that execute on
        the MAC array check precision."""
        return bool(self._cm.supports(self._T, op_cost_dict(op)))

    def roofline_cycles(self, op: OpNode, bw_gbps: float) -> float:
        """Mapper's cycle estimate (Eq. 2): max of compute- and
        bandwidth-bound counts.  Cheap, used for placement decisions."""
        return float(self._cm.roofline_cycles(self._T, op_cost_dict(op),
                                              float(bw_gbps)))

    def execute(self, op: OpNode, bw_gbps: float, dram_rd: float,
                dram_wr: float) -> OpExec:
        """Full seven-module execution (Eq. 4-6).

        ``dram_rd`` / ``dram_wr`` are the effective DRAM bytes after the
        orchestrator's cross-tile activation-cache adjustment (§3.3.4).
        """
        out = self._cm.execute(self._T, op_cost_dict(op), float(bw_gbps),
                               float(dram_rd), float(dram_wr),
                               cache_frac=self.cache_frac)
        e = EnergyBreakdown(
            compute=float(out["e_compute"]),
            dram=float(out["e_dram"]),
            sram=float(out["e_sram"]),
            irf=float(out["e_irf"]),
            orf=float(out["e_orf"]),
            dsp=float(out["e_dsp"]),
            special=float(out["e_special"]),
        )
        cycles = float(out["cycles"])
        return OpExec(cycles=cycles, seconds=cycles / self.clock_hz, energy=e,
                      path=_PATH_NAME[int(out["path"])],
                      roofline=_ROOFLINE_NAME[int(out["roofline"])],
                      dram_rd=dram_rd, dram_wr=dram_wr,
                      dram_bytes=float(out["dram_bytes"]))
