"""Per-module cycle and energy models (paper §3.3.1) -- scalar wrappers.

Port of ``repro/core/simulator/modules.py``.  The formulas live in
``simulator.costs``, shared by this host path and the batched executors
on torch.  This module keeps the scalar/TileTemplate-typed entry points
used by ``TileSim`` and tests.  It is host code: every call evaluates
the cost model's numpy path on Python floats, through a ``CostModel``
built on ``"cpu"``, so it never needs a card.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

from ..arch import Dataflow, TileTemplate
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from .costs import ACC_BYTES, CACHE_FRAC, DSP_OPS_PER_ELEM, cost_model

# mac_tiling / mac_cycles / sram_traffic are calibration-free -- any table
# binds the same formulas; reuse one cached model.
DEFAULT_CALIB_FOR_TILING = DEFAULT_CALIB

# the host's cost model: scalar numpy inputs only, so its lookup tables
# never leave the CPU
HOST = "cpu"

__all__ = [
    "DSP_OPS_PER_ELEM", "ACC_BYTES", "mac_tiling", "mac_cycles",
    "sram_traffic", "dsp_cycles_energy", "sfu_cycles_energy",
    "dram_cycles_energy", "pick_dataflow", "tile_cost_dict",
]

_BURST = 64.0  # DRAM burst alignment (bytes)


def tile_cost_dict(tile: TileTemplate, cache_frac: float = CACHE_FRAC
                   ) -> Dict[str, float]:
    """TileTemplate -> the scalar field dict the shared CostModel reads."""
    return {
        "exists": 1.0,
        "num_macs": float(tile.num_macs),
        "rows": float(tile.rows),
        "cols": float(tile.cols),
        "engine": float(int(tile.engine)),
        "prec_mask": float(tile.precision_mask),
        "asym_mac": float(int(tile.asym_mac)),
        "sparsity": float(int(tile.sparsity)),
        "dataflow": float(int(tile.dataflow)),
        "sram_kb": float(tile.sram_kb),
        "dsp_lanes": float(tile.dsp_count * tile.dsp_simd),
        "dsp_count": float(tile.dsp_count),
        "sfu_mask": float(tile.sfu_mask),
        "sfu_parallel": float(tile.sfu_parallel),
        "double_buffer": float(tile.double_buffer),
        "pipeline_depth": float(tile.pipeline_depth),
        "clock_hz": tile.clock_mhz * 1e6,
        "sram_bpc": max(tile.sram_banks, 1) * 16.0,
        "max_prec": float(int(tile.max_precision)),
        "cache_cap": tile.sram_kb * 1024.0 * cache_frac,
    }


def pick_dataflow(tile: TileTemplate, m: float, k: float, n: float) -> Dataflow:
    """AUTO rule (paper §3.2): OS when M*N exceeds both K*N and M*K by 4x."""
    if tile.dataflow != Dataflow.AUTO:
        return tile.dataflow
    if m * n > 4.0 * k * n and m * n > 4.0 * m * k:
        return Dataflow.OS
    return Dataflow.WS


def mac_tiling(tile: TileTemplate, m: float, k: float, n: float,
               bpe: float, cache_frac: float = 0.25) -> Tuple[float, float, float]:
    """SRAM-budget tiling pass (paper §3.3.1): returns (m_t, k_t, n_t);
    ``cache_frac`` of SRAM is reserved for the activation cache (§3.3.4)."""
    cm = cost_model(DEFAULT_CALIB_FOR_TILING, HOST)
    T = tile_cost_dict(tile, cache_frac)
    m_t, k_t, n_t = cm.mac_tiling(T, float(m), float(k), float(n),
                                  float(bpe), cache_frac)
    return float(m_t), float(k_t), float(n_t)


def mac_cycles(tile: TileTemplate, m: float, k: float, n: float,
               eta: float, m_t: float, k_t: float, n_t: float) -> float:
    """Engine-specific compute-cycle model (Eq. 4)."""
    cm = cost_model(DEFAULT_CALIB_FOR_TILING, HOST)
    return float(cm.mac_cycles(tile_cost_dict(tile), float(m), float(k),
                               float(n), float(eta), float(m_t), float(k_t),
                               float(n_t)))


def sram_traffic(dataflow: Dataflow, m: float, k: float, n: float,
                 bpe: float, m_t: float, k_t: float, n_t: float) -> Tuple[float, float, float]:
    """Tiling-aware SRAM traffic (bytes in, weights, out) from dataflow
    reuse (WS / OS / RS; see CostModel.sram_traffic)."""
    cm = cost_model(DEFAULT_CALIB_FOR_TILING, HOST)
    T = {"dataflow": float(int(dataflow))}
    in_b, w_b, out_b, _ = cm.sram_traffic(T, float(m), float(k), float(n),
                                          float(bpe), float(m_t), float(k_t),
                                          float(n_t))
    return float(in_b), float(w_b), float(out_b)


def dsp_cycles_energy(tile: TileTemplate, op_type: int, elems: float,
                      seq_len: float, calib: CalibrationTable) -> Tuple[float, float]:
    """Vector-DSP path; the SSM scan carries a sequence-length sequential
    multiplier (paper §3.3.1)."""
    cyc, en = cost_model(calib, HOST).dsp_cycles_energy(
        tile_cost_dict(tile), int(op_type), float(elems), float(seq_len))
    return float(cyc), float(en)


def sfu_cycles_energy(tile: TileTemplate, op_type: int, elems: float,
                      fft_n: float, poly_degree: float, snn_t: float,
                      calib: CalibrationTable) -> Tuple[float, float]:
    """Special-function path (paper §3.3.1): radix-2 FFT N log2 N cycles,
    LIF ceil(N/N_par)*T cycles, Horner polynomial N*d cycles."""
    cyc, en = cost_model(calib, HOST).sfu_cycles_energy(
        tile_cost_dict(tile), int(op_type), float(elems), float(fft_n),
        float(poly_degree), float(snn_t))
    return float(cyc), float(en)


def dram_cycles_energy(bytes_rd: float, bytes_wr: float, bw_gbps: float,
                       clock_hz: float, calib: CalibrationTable) -> Tuple[float, float]:
    """Burst-aligned DRAM staging at the tile's (dynamically shared)
    bandwidth, plus the LPDDR5 access latency."""
    total = 0.0
    for b in (bytes_rd, bytes_wr):
        if b > 0:
            total += math.ceil(b / _BURST) * _BURST
    if total == 0:
        return 0.0, 0.0
    bytes_per_cycle = bw_gbps * 1e9 / clock_hz
    cycles = total / max(bytes_per_cycle, 1e-9) + calib.dram_latency_cycles
    return cycles, total * calib.e_dram_pj_per_byte
