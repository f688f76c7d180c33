"""Analytical area model (paper Eq. 7).

A_tile = N_MAC * max_p A_MAC(p) + A_SRAM + A_DSP + A_spec + A_ports

Per-MAC area is taken over the *largest supported precision* — a
multi-precision MAC carries the wide datapath.  IRF/ORF area folds into
A_ports.  Chip area adds the NoC and omits floorplan dead space (paper §7;
the RTL gating study bounds the mismatch to ~8 %).
"""
from __future__ import annotations

from typing import Dict

from ..arch import ChipConfig, TileTemplate, SFU_FFT, SFU_SNN, SFU_POLY
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB

__all__ = ["tile_area", "chip_area", "area_breakdown", "noc_area_scale"]


def tile_area(tile: TileTemplate, calib: CalibrationTable = DEFAULT_CALIB) -> float:
    return sum(area_breakdown(tile, calib).values())


def area_breakdown(tile: TileTemplate, calib: CalibrationTable = DEFAULT_CALIB) -> Dict[str, float]:
    a_mac_unit = calib.mac_area(int(tile.max_precision), int(tile.engine))
    a_mac = tile.num_macs * a_mac_unit * calib.sparsity_a_mult[int(tile.sparsity)]
    a_sram = tile.sram_kb * calib.a_sram_mm2_per_kb
    a_dsp = tile.dsp_count * tile.dsp_simd * calib.a_dsp_mm2_per_lane
    a_spec = 0.0
    if tile.sfu_mask & SFU_FFT:
        a_spec += calib.a_fft_mm2
    if tile.sfu_mask & SFU_SNN:
        a_spec += calib.a_lif_mm2
    if tile.sfu_mask & SFU_POLY:
        a_spec += calib.a_poly_mm2
    # load/store ports + PPM + IRF/ORF + control (fitted; see calibrate/asap7)
    a_ports = calib.a_ports_base_mm2 + (tile.rows + tile.cols) * calib.a_ports_per_lane_mm2
    return {"mac": a_mac, "sram": a_sram, "dsp": a_dsp, "special": a_spec,
            "ports": a_ports}


def noc_area_scale(noc_bytes_per_cycle: float, torus: bool) -> float:
    """Interconnect area multiplier on the per-tile NoC term: router/link
    width grows with flit width (64 B/cycle is the calibrated baseline),
    and a torus carries the wrap-around links."""
    return (0.5 + 0.5 * noc_bytes_per_cycle / 64.0) * (1.25 if torus else 1.0)


def chip_area(chip: ChipConfig, calib: CalibrationTable = DEFAULT_CALIB) -> float:
    a = sum(tile_area(t, calib) * c for t, c in chip.tiles)
    a = a + chip.num_tiles * calib.a_noc_mm2_per_tile \
        * noc_area_scale(chip.noc_bytes_per_cycle, chip.torus)
    return a + (chip.dram_channels - 1) * calib.a_dram_phy_mm2
