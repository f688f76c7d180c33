"""NVDLA cross-validation reference points (paper §5.1.2, Table 2).

NVDLA is the external axis of MOSAIC's three-axis validation: the only
openly available production NPU shipping synthesizable RTL together with a
published per-module area/energy breakdown.  The rows below transcribe the
NVDLA columns of Table 2 (the published reference values) plus the two
design-point definitions:

* nv_small: 8x8 INT8 systolic, 64 KB convolution buffer (CBUF)
* nv_full : 32x64 INT8+FP16, 512 KB CBUF  (32x in MAC density vs nv_small)

Both are exercised on an INT8 64x64x64 GEMM that fits on-chip.

Port of ``repro/core/calibrate/nvdla.py`` (host data, no torch).
"""
from __future__ import annotations

import dataclasses

from ..arch import ChipConfig, Dataflow, Engine, Sparsity, TileTemplate
from ..ir import Precision

__all__ = ["NVDLAPoint", "NVDLA_SMALL", "NVDLA_FULL", "nvdla_chip"]


@dataclasses.dataclass(frozen=True)
class NVDLAPoint:
    """Published NVDLA reference values (Table 2, NVDLA columns)."""

    name: str
    rows: int
    cols: int
    cbuf_kb: int
    precisions: frozenset
    peak_tops: float
    latency_us: float
    energy_nj: float
    area_mm2: float
    tops_per_w: float
    # synthesized cmac+CBUF subset area the paper quotes for nv_full
    cmac_cbuf_mm2: float = 0.0


NVDLA_SMALL = NVDLAPoint(
    name="nv_small", rows=8, cols=8, cbuf_kb=64,
    precisions=frozenset({Precision.INT8}),
    peak_tops=0.064, latency_us=5.12, energy_nj=567.7, area_mm2=0.40,
    tops_per_w=0.58,
)

NVDLA_FULL = NVDLAPoint(
    name="nv_full", rows=32, cols=64, cbuf_kb=512,
    precisions=frozenset({Precision.INT8, Precision.FP16}),
    peak_tops=2.048, latency_us=1.15, energy_nj=567.7, area_mm2=3.31,
    tops_per_w=4.16, cmac_cbuf_mm2=3.238,
)


def nvdla_chip(point: NVDLAPoint) -> ChipConfig:
    """Express an NVDLA design point in MOSAIC's architecture schema.

    NVDLA has no vector DSP or SFU; its convolution pipeline is a
    weight-stationary MAC fabric fed from the CBUF.  Clock: 1 GHz (the
    paper's validation clock, §4.4).
    """
    tile = TileTemplate(
        name=point.name,
        rows=point.rows,
        cols=point.cols,
        engine=Engine.SYSTOLIC,
        precisions=point.precisions,
        sparsity=Sparsity.NONE,
        dataflow=Dataflow.WS,
        sram_kb=point.cbuf_kb,
        # NVDLA's SDP/PDP post-processing path: a narrow vector unit for
        # activations / pooling / normalization
        dsp_count=1,
        dsp_simd=16,
        sfu_mask=0,
        double_buffer=True,
        pipeline_depth=4,
        clock_mhz=1000,
    )
    return ChipConfig(
        name=f"mosaic-{point.name}",
        tiles=((tile, 1),),
        dram_gbps=10.0,   # NVDLA Primer AXI sustained bandwidth class
        ref_clock_mhz=1000,
    )
