"""MOSAIC architecture schema: tile templates, chip configs, and the 12-knob
DSE grid (paper §3.1, §4.5).

The same schema describes a homogeneous chip (one template), a mixed-
precision chip (two templates) or a Big+Little+Special-Function chip.
``ChipConfig.to_vector()`` flattens a chip into a fixed-width float vector so
batches of thousands of candidate chips can be evaluated as (B, MAX_TILES)
tensors by the batched executor (and packed for the CUDA ``dse_eval``
roofline kernel, ``dse.prefilter``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

from .ir import Precision

__all__ = [
    "Engine", "Sparsity", "Dataflow", "Interconnect", "AsymMAC",
    "TileTemplate", "ChipConfig", "KNOB_GRID", "MAX_TILE_TYPES",
    "MAX_TILES", "TILE_VEC_FIELDS", "CHIP_VEC_FIELDS",
]

MAX_TILE_TYPES = 3   # paper §4.5: 1-3 tile types
MAX_INSTANCES = 8    # paper §4.5: 1-8 instances per type
MAX_TILES = MAX_TILE_TYPES * MAX_INSTANCES


class Engine(enum.IntEnum):
    SYSTOLIC = 0
    SPATIAL = 1
    DOT = 2
    CIM = 3          # compute-in-memory


class Sparsity(enum.IntEnum):
    NONE = 0
    ACT = 1          # activation-sided skipping
    WEIGHT = 2       # weight-sided skipping
    TWO_SIDED = 3
    NM = 4           # structured N:M


class Dataflow(enum.IntEnum):
    WS = 0
    OS = 1
    RS = 2
    AUTO = 3


class Interconnect(enum.IntEnum):
    MESH = 0
    BUS = 1
    RING = 2
    NOC = 3


class AsymMAC(enum.IntEnum):
    NONE = 0
    W4A8 = 1
    W2A8 = 2
    W4A16 = 3        # paper: W4A16+W8A16 variant


# --- SFU bit masks -----------------------------------------------------------
SFU_FFT, SFU_SNN, SFU_POLY = 1, 2, 4


def prec_mask(precisions: Sequence[Precision]) -> int:
    m = 0
    for p in precisions:
        m |= 1 << int(p)
    return m


@dataclasses.dataclass(frozen=True)
class TileTemplate:
    """One tile type; a chip instantiates ``count`` copies of each template.

    ``rows == cols == 0`` describes a Special-Function tile (no MAC array).
    The supported-precision set is a per-tile knob (paper §3.3.5), not a
    property of the Big/Little label.
    """

    name: str
    rows: int = 32
    cols: int = 32
    engine: Engine = Engine.SYSTOLIC
    precisions: FrozenSet[Precision] = frozenset({Precision.INT8, Precision.FP16})
    sparsity: Sparsity = Sparsity.NONE
    dataflow: Dataflow = Dataflow.AUTO
    sram_kb: int = 512
    sram_banks: int = 8
    irf_bytes: int = 2048
    orf_bytes: int = 2048
    dsp_count: int = 1
    dsp_simd: int = 64           # lanes
    sfu_mask: int = 0            # OR of SFU_FFT / SFU_SNN / SFU_POLY
    sfu_parallel: int = 16       # N_par for the LIF unit; butterflies/cycle for FFT
    double_buffer: bool = True
    pipeline_depth: int = 4
    clock_mhz: int = 1200        # fixed per-type clock domain (paper §3.1)
    asym_mac: AsymMAC = AsymMAC.NONE

    @property
    def is_special(self) -> bool:
        return self.rows == 0 or self.cols == 0

    @property
    def num_macs(self) -> int:
        return self.rows * self.cols

    @property
    def max_precision(self) -> Precision:
        return max(self.precisions, key=int)

    @property
    def precision_mask(self) -> int:
        return prec_mask(sorted(self.precisions))

    def supports_precision(self, p: Precision) -> bool:
        if p in self.precisions:
            return True
        # Asymmetric-precision MAC variants accept narrower weights on the
        # wider datapath (W4A8 etc.).
        if self.asym_mac in (AsymMAC.W4A8, AsymMAC.W2A8) and p == Precision.INT4:
            return Precision.INT8 in self.precisions
        if self.asym_mac == AsymMAC.W4A16 and p in (Precision.INT4, Precision.INT8):
            return Precision.FP16 in self.precisions
        return False


@dataclasses.dataclass(frozen=True)
class ChipConfig:
    """A full HPU: tile templates + counts + interconnect + DRAM."""

    name: str
    tiles: Tuple[Tuple[TileTemplate, int], ...]
    interconnect: Interconnect = Interconnect.MESH
    dram_gbps: float = 64.0
    dram_latency_cycles: int = 100   # LPDDR5 access latency (paper §3.4)
    noc_bytes_per_cycle: float = 64.0
    noc_base_cycles: int = 8         # per-hop base latency
    ref_clock_mhz: int = 1000        # chip-level cycle base for NoC/DRAM DMA
    # link-fidelity interconnect structure (ignored by the aggregate tier)
    torus: bool = False              # wrap-around links on the tile grid
    grid_aspect: float = 1.0         # grid_w ~= round(sqrt(n) * aspect)
    dram_channels: int = 1           # address-interleaved DRAM channels

    def __post_init__(self):
        if not (1 <= len(self.tiles) <= MAX_TILE_TYPES):
            raise ValueError(f"{self.name}: need 1..{MAX_TILE_TYPES} tile types")
        for t, c in self.tiles:
            if not (1 <= c <= MAX_INSTANCES):
                raise ValueError(f"{self.name}/{t.name}: count {c} out of 1..{MAX_INSTANCES}")
        if self.dram_channels < 1:
            raise ValueError(f"{self.name}: dram_channels must be >= 1")
        if self.grid_aspect <= 0:
            raise ValueError(f"{self.name}: grid_aspect must be > 0")

    def instances(self) -> List[TileTemplate]:
        out: List[TileTemplate] = []
        for t, c in self.tiles:
            out.extend([t] * c)
        return out

    @property
    def num_tiles(self) -> int:
        return sum(c for _, c in self.tiles)

    # ------------------------------------------------------------------ SoA
    def to_vector(self) -> Dict[str, np.ndarray]:
        """Flatten to fixed-width arrays over MAX_TILES instance slots."""
        inst = self.instances()
        vec = {f: np.zeros(MAX_TILES, dtype=np.float64) for f in TILE_VEC_FIELDS}
        for i, t in enumerate(inst):
            vec["exists"][i] = 1.0
            vec["rows"][i] = t.rows
            vec["cols"][i] = t.cols
            vec["engine"][i] = int(t.engine)
            vec["prec_mask"][i] = t.precision_mask
            vec["asym_mac"][i] = int(t.asym_mac)
            vec["sparsity"][i] = int(t.sparsity)
            vec["dataflow"][i] = int(t.dataflow)
            vec["sram_kb"][i] = t.sram_kb
            vec["dsp_count"][i] = t.dsp_count
            vec["dsp_simd"][i] = t.dsp_simd
            vec["sfu_mask"][i] = t.sfu_mask
            vec["sfu_parallel"][i] = t.sfu_parallel
            vec["double_buffer"][i] = float(t.double_buffer)
            vec["pipeline_depth"][i] = t.pipeline_depth
            vec["clock_mhz"][i] = t.clock_mhz
        chip = {
            "dram_gbps": np.float64(self.dram_gbps),
            "dram_latency_cycles": np.float64(self.dram_latency_cycles),
            "noc_bytes_per_cycle": np.float64(self.noc_bytes_per_cycle),
            "noc_base_cycles": np.float64(self.noc_base_cycles),
            "interconnect": np.float64(int(self.interconnect)),
            "ref_clock_mhz": np.float64(self.ref_clock_mhz),
            "torus": np.float64(self.torus),
            "grid_aspect": np.float64(self.grid_aspect),
            "dram_channels": np.float64(self.dram_channels),
        }
        return {"tile": vec, "chip": chip}


TILE_VEC_FIELDS = (
    "exists", "rows", "cols", "engine", "prec_mask", "asym_mac", "sparsity",
    "dataflow", "sram_kb", "dsp_count", "dsp_simd", "sfu_mask", "sfu_parallel",
    "double_buffer", "pipeline_depth", "clock_mhz",
)
CHIP_VEC_FIELDS = (
    "dram_gbps", "dram_latency_cycles", "noc_bytes_per_cycle",
    "noc_base_cycles", "interconnect", "ref_clock_mhz",
    "torus", "grid_aspect", "dram_channels",
)


# =============================================================================
# The 12-knob DSE grid (paper §4.5, verbatim value sets)
# =============================================================================
KNOB_GRID: Dict[str, tuple] = {
    "array_dim": (8, 16, 32, 64, 128),                       # rows and cols
    "sram_kb": (64, 128, 256, 512, 1024, 2048, 4096),
    "precision_set": (
        frozenset({Precision.INT8}),
        frozenset({Precision.INT4, Precision.INT8}),
        frozenset({Precision.INT8, Precision.FP16}),
        frozenset({Precision.INT4, Precision.INT8, Precision.FP16}),
    ),
    "dram_gbps": (16, 32, 64, 128, 256, 512),
    "count": tuple(range(1, MAX_INSTANCES + 1)),
    "sparsity": (Sparsity.NONE, Sparsity.ACT, Sparsity.TWO_SIDED),
    "engine": (Engine.SYSTOLIC, Engine.SPATIAL, Engine.DOT, Engine.CIM),
    "dataflow": (Dataflow.WS, Dataflow.OS, Dataflow.RS),
    "interconnect": (Interconnect.MESH, Interconnect.BUS, Interconnect.RING, Interconnect.NOC),
    # link-fidelity interconnect knobs (searched as genome genes; the
    # aggregate tier only reads noc_bpc)
    "noc_topology": (False, True),                           # mesh, torus
    "grid_aspect": (0.5, 1.0, 2.0),
    "noc_bpc": (32, 64, 128, 256),
    "dram_channels": (1, 2, 4, 8),
    "double_buffer": (False, True),
    "asym_mac": (AsymMAC.NONE, AsymMAC.W4A8, AsymMAC.W2A8, AsymMAC.W4A16),
    "pipeline_depth": (1, 4, 8, 16),
    # tile-type composition is the 12th knob: how many types and which kinds
    "sfu_mask": (0, SFU_FFT, SFU_SNN, SFU_POLY, SFU_FFT | SFU_SNN | SFU_POLY),
}


def knob_space_size() -> float:
    """Rough cardinality of the joint space; the paper quotes > 1e14."""
    per_tile = (
        len(KNOB_GRID["array_dim"]) ** 2
        * len(KNOB_GRID["sram_kb"])
        * len(KNOB_GRID["precision_set"])
        * len(KNOB_GRID["count"])
        * len(KNOB_GRID["sparsity"])
        * len(KNOB_GRID["engine"])
        * len(KNOB_GRID["dataflow"])
        * len(KNOB_GRID["double_buffer"])
        * len(KNOB_GRID["asym_mac"])
        * len(KNOB_GRID["pipeline_depth"])
        * len(KNOB_GRID["sfu_mask"])
    )
    chip = (
        len(KNOB_GRID["dram_gbps"]) * len(KNOB_GRID["interconnect"])
        * len(KNOB_GRID["noc_topology"]) * len(KNOB_GRID["grid_aspect"])
        * len(KNOB_GRID["noc_bpc"]) * len(KNOB_GRID["dram_channels"])
    )
    return float(per_tile) ** MAX_TILE_TYPES * chip


# =============================================================================
# Canonical tile templates / baselines used throughout the paper's results
# =============================================================================

def big_tile(rows: int = 64, cols: int = 64, sram_kb: int = 2048,
             precisions: FrozenSet[Precision] = frozenset({Precision.INT8, Precision.FP16}),
             **kw) -> TileTemplate:
    """Paper §3.3.5 Big tile: large array, ample SRAM, two-sided sparsity, dual DSP."""
    kw.setdefault("sparsity", Sparsity.TWO_SIDED)
    kw.setdefault("dsp_count", 2)
    kw.setdefault("clock_mhz", 1200)
    return TileTemplate(name="big", rows=rows, cols=cols, sram_kb=sram_kb,
                        precisions=precisions, **kw)


def little_tile(rows: int = 16, cols: int = 16, sram_kb: int = 256,
                precisions: FrozenSet[Precision] = frozenset({Precision.INT4, Precision.INT8}),
                **kw) -> TileTemplate:
    """Paper §3.3.5 Little tile: small array, modest SRAM, single DSP, 500 MHz."""
    kw.setdefault("sparsity", Sparsity.ACT)
    kw.setdefault("dsp_count", 1)
    kw.setdefault("clock_mhz", 500)
    return TileTemplate(name="little", rows=rows, cols=cols, sram_kb=sram_kb,
                        precisions=precisions, **kw)


def special_tile(sfu_mask: int = SFU_FFT | SFU_SNN | SFU_POLY, sram_kb: int = 256,
                 **kw) -> TileTemplate:
    """Paper §3.3.5 Special-Function tile: no MAC array, SFUs + one DSP."""
    kw.setdefault("dsp_count", 1)
    kw.setdefault("clock_mhz", 800)
    return TileTemplate(name="special", rows=0, cols=0, sram_kb=sram_kb,
                        precisions=frozenset({Precision.FP16, Precision.INT8}),
                        sfu_mask=sfu_mask, **kw)


def homogeneous_baseline(n_tiles: int = 6, rows: int = 32, cols: int = 32,
                         sram_kb: int = 2048, dram_gbps: float = 64.0) -> ChipConfig:
    """Intel LNL-class homogeneous NPU (paper §3.1): identical FP16+INT8 MAC
    tiles with matched SRAM and DSPs, mesh interconnect, one DRAM channel."""
    t = TileTemplate(
        name="homog", rows=rows, cols=cols, sram_kb=sram_kb,
        precisions=frozenset({Precision.INT8, Precision.FP16}),
        sparsity=Sparsity.NONE, dsp_count=2, clock_mhz=1200,
    )
    return ChipConfig(name=f"homo-{n_tiles}x{rows}x{cols}",
                      tiles=((t, n_tiles),), dram_gbps=dram_gbps)


def hetero_bl(n_big: int = 2, n_little: int = 4, dram_gbps: float = 64.0) -> ChipConfig:
    return ChipConfig(name=f"heteroBL-{n_big}B{n_little}L",
                      tiles=((big_tile(), n_big), (little_tile(), n_little)),
                      dram_gbps=dram_gbps)


def hetero_bls(n_big: int = 2, n_little: int = 4, n_special: int = 1,
               dram_gbps: float = 64.0) -> ChipConfig:
    return ChipConfig(
        name=f"heteroBLS-{n_big}B{n_little}L{n_special}S",
        tiles=((big_tile(), n_big), (little_tile(), n_little),
               (special_tile(), n_special)),
        dram_gbps=dram_gbps)
