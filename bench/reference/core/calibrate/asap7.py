"""ASAP7-7nm-grounded energy / area / timing calibration tables.

Anchor points and their provenance:

* Three-level energy hierarchy (paper §2.1, citing Horowitz ISSCC'14 and
  CACTI): IRF/ORF ~1-3 pJ/byte, SRAM ~5 pJ/byte, DRAM 40-200 pJ/byte.
* LPDDR5-6400 pairing (paper §3.4): 40 pJ/byte, 51.2 GB/s (rounded to
  64 GB/s on the DSE grid), 100-cycle access latency.
* Power gating (paper §3.3.4): gated tiles retain 5 % residual leakage.
* MAC energies follow the Horowitz 45 nm table scaled to 7 nm (~5x); the
  INT8:FP16 energy ratio (~4.4x) matches the mixed-precision literature the
  paper builds on (Spantidi et al.).
* Per-MAC / port / PPM areas are FITTED so the analytical Eq. 7 reproduces
  the paper's own Table 2 MOSAIC column (nv_small 0.71 mm^2, nv_full
  4.96 mm^2, cmac+CBUF subset 3.308 mm^2) — the same role DC synthesis
  plays in the paper.  See scripts/fit_calibration.py for the fit.

All energies in pJ, areas in mm^2, clocks in MHz unless stated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..arch import Sparsity

__all__ = ["CalibrationTable", "DEFAULT_CALIB"]


@dataclasses.dataclass(frozen=True)
class CalibrationTable:
    # ---- energy (pJ) --------------------------------------------------------
    # per-MAC dynamic energy by precision (index = Precision)
    e_mac_pj: tuple = (0.040, 0.080, 0.350, 0.350, 0.900)
    # engine-type energy multiplier on e_mac (index = Engine):
    #   systolic 1.0; spatial pays extra operand-network toggling; dot-product
    #   trees amortize the accumulator; CIM mults in-array are ~2x cheaper.
    engine_e_mult: tuple = (1.0, 1.15, 0.95, 0.50)
    e_sram_pj_per_byte: float = 5.0
    e_irf_pj_per_byte: float = 1.0
    e_orf_pj_per_byte: float = 3.0
    e_dram_pj_per_byte: float = 40.0        # LPDDR5-6400
    e_noc_pj_per_byte_hop: float = 0.8
    # residual toggling of the wide datapath when a narrow op runs on a
    # multi-precision MAC with the upper bits clock-gated.  Grounded by the
    # paper's system-level RTL gating study (§5.1.3): the homogeneous design
    # clock-gates its FP16 path under INT8 yet still draws far more power
    # than the power-gated precision-matched heterogeneous design.
    datapath_residual: float = 0.35
    # vector DSP: per lane-op (ALU + register access), FP16
    e_dsp_pj_per_lane_op: float = 0.5
    # special-function units
    e_fft_pj_per_butterfly: float = 1.5     # 1 cmul + 2 cadd @FP16
    e_lif_pj_per_neuron_step: float = 0.10  # few gates/neuron (paper §2.5)
    e_poly_pj_per_fma: float = 0.40         # Horner-rule fused multiply-add
    # ---- leakage ------------------------------------------------------------
    # ASAP7 7.5T HD cells at the 0.7 V low-leakage corner.  FITTED so the
    # paper's chip-level claims reproduce: the Fig. 7 inverted-U requires
    # 100-400 mm^2 chips to be leakage-viable at single-inference latencies.
    leak_mw_per_mm2: float = 11.0
    power_gate_residual: float = 0.05       # paper §3.3.4: 5 % residual
    # ---- area (mm^2) --------------------------------------------------------
    # per-MAC area by max supported precision (index = Precision).  FITTED to
    # Table 2 (multi-precision MACs include the wide datapath, Eq. 7).
    a_mac_mm2: tuple = (4.0e-4, 8.0e-4, 1.35e-3, 1.35e-3, 2.8e-3)
    engine_a_mult: tuple = (1.0, 1.10, 0.92, 0.60)
    a_sram_mm2_per_kb: float = 8.8e-4       # CACTI-7-style 7 nm macro density
    a_dsp_mm2_per_lane: float = 3.5e-4
    a_fft_mm2: float = 0.055
    a_lif_mm2: float = 0.012
    a_poly_mm2: float = 0.024
    # load/store ports + PPM + control: fixed + per-edge DMA lanes.  FITTED
    # against Table 2 (nv_small 0.71 mm^2 total, nv_full 4.96 mm^2 with a
    # 3.308 mm^2 cmac+CBUF subset): the per-edge DMA/PPM overhead scales
    # with array rows+cols.
    a_ports_base_mm2: float = 0.36
    a_ports_per_lane_mm2: float = 1.25e-2   # per (row+col) DMA lane
    a_noc_mm2_per_tile: float = 0.045
    # per-channel DRAM PHY + controller (beyond the first, which the
    # baseline area already carries)
    a_dram_phy_mm2: float = 1.8
    # sparsity-logic area overhead multipliers (index = Sparsity)
    sparsity_a_mult: tuple = (1.0, 1.06, 1.06, 1.12, 1.04)
    # ---- timing -------------------------------------------------------------
    dram_latency_cycles: float = 100.0      # paper §3.4
    # sparsity throughput multiplier cap (eta in Eq. 2); skipping logic cannot
    # exploit unbounded sparsity
    eta_cap: float = 4.0

    # ------------------------------------------------------------------ utils
    def mac_energy(self, precision: int, engine: int,
                   datapath_precision: int = -1) -> float:
        """Per-MAC energy for an op at ``precision`` on a datapath built for
        ``datapath_precision`` (= the tile's widest supported precision).
        Narrow ops on a wide datapath pay a clock-gating residual."""
        e = self.e_mac_pj[precision]
        if datapath_precision > precision:
            e = e + self.datapath_residual * (
                self.e_mac_pj[datapath_precision] - e)
        return e * self.engine_e_mult[engine]

    def mac_area(self, max_precision: int, engine: int) -> float:
        return self.a_mac_mm2[max_precision] * self.engine_a_mult[engine]

    def eta(self, sparsity_mode: int, act_sp: float, w_sp: float) -> float:
        """Per-MAC throughput multiplier eta_T (> 1 when skipping applies)."""
        act_sp = min(max(act_sp, 0.0), 0.95)
        w_sp = min(max(w_sp, 0.0), 0.95)
        if sparsity_mode == int(Sparsity.NONE):
            return 1.0
        if sparsity_mode == int(Sparsity.ACT):
            e = 1.0 / (1.0 - act_sp)
        elif sparsity_mode == int(Sparsity.WEIGHT):
            e = 1.0 / (1.0 - w_sp)
        elif sparsity_mode == int(Sparsity.TWO_SIDED):
            e = 1.0 / max((1.0 - act_sp) * (1.0 - w_sp), 1e-3)
        else:  # structured N:M — fixed 2x when weights are >= 50 % sparse
            e = 2.0 if w_sp >= 0.5 else 1.0
        return float(min(e, self.eta_cap))

    def as_arrays(self) -> Dict[str, np.ndarray]:
        """Dense-array view of the calibration constants."""
        return {
            "e_mac": np.asarray(self.e_mac_pj, np.float64),
            "engine_e_mult": np.asarray(self.engine_e_mult, np.float64),
            "a_mac": np.asarray(self.a_mac_mm2, np.float64),
            "engine_a_mult": np.asarray(self.engine_a_mult, np.float64),
            "sparsity_a_mult": np.asarray(self.sparsity_a_mult, np.float64),
            "scalars": np.asarray(
                [
                    self.e_sram_pj_per_byte, self.e_irf_pj_per_byte,
                    self.e_orf_pj_per_byte, self.e_dram_pj_per_byte,
                    self.e_noc_pj_per_byte_hop, self.e_dsp_pj_per_lane_op,
                    self.e_fft_pj_per_butterfly, self.e_lif_pj_per_neuron_step,
                    self.e_poly_pj_per_fma, self.leak_mw_per_mm2,
                    self.power_gate_residual, self.a_sram_mm2_per_kb,
                    self.a_dsp_mm2_per_lane, self.a_fft_mm2, self.a_lif_mm2,
                    self.a_poly_mm2, self.a_ports_base_mm2,
                    self.a_ports_per_lane_mm2, self.a_noc_mm2_per_tile,
                    self.dram_latency_cycles, self.eta_cap,
                ],
                np.float64,
            ),
        }


# Index map for CalibrationTable.as_arrays()["scalars"] — keep in sync.
SCALAR_IDX = {
    name: i
    for i, name in enumerate(
        [
            "e_sram", "e_irf", "e_orf", "e_dram", "e_noc", "e_dsp",
            "e_fft", "e_lif", "e_poly", "leak_mw_mm2", "gate_residual",
            "a_sram_kb", "a_dsp_lane", "a_fft", "a_lif", "a_poly",
            "a_ports_base", "a_ports_lane", "a_noc_tile", "dram_lat", "eta_cap",
        ]
    )
}

DEFAULT_CALIB = CalibrationTable()
