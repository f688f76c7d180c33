"""Genome encoding for the 12-knob design space (paper §4.5).

A genome is a fixed-length integer vector indexing the knob grids of
``repro.core.arch.KNOB_GRID``:

  [ n_tile_types,
    (count, rows, cols, sram, prec, sparsity, engine, dataflow,
     sfu, asym, pipe, db)  x MAX_TILE_TYPES,
    dram_bw, interconnect ]

A tile type with sfu > 0 decodes to a Special-Function tile (rows=cols=0,
SFUs + one DSP) — SFUs live in Special-Function tiles, matching the
paper's tile taxonomy (§3.3.5).  Clock domains follow the paper's fixed
assignment: >= 32x32 MAC tiles at 1200 MHz (Big), smaller at 500 MHz
(Little), Special-Function at 800 MHz.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..arch import KNOB_GRID, MAX_TILE_TYPES, ChipConfig, TileTemplate
from ..ir import Precision

_HOMO_PREC_IDX = KNOB_GRID["precision_set"].index(
    frozenset({Precision.INT8, Precision.FP16}))

__all__ = ["Genome", "GENOME_LEN", "FIELDS_PER_TILE", "decode",
           "random_genomes", "genome_bounds", "FAMILIES",
           "IDX_DRAM", "IDX_ICONN", "IDX_TOPO", "IDX_ASPECT",
           "IDX_NOC_BPC", "IDX_DRAM_CH", "INTERCONNECT_GENE_DEFAULTS"]

_TILE_FIELDS = ("count", "rows", "cols", "sram", "prec", "sparsity",
                "engine", "dataflow", "sfu", "asym", "pipe", "db")
FIELDS_PER_TILE = len(_TILE_FIELDS)
# chip-level genes trail the tile blocks: dram bw, interconnect enum,
# then the interconnect-structure genes (mesh/torus, grid aspect,
# NoC bytes/cycle, DRAM channel count)
GENOME_LEN = 1 + MAX_TILE_TYPES * FIELDS_PER_TILE + 6
IDX_DRAM = 1 + MAX_TILE_TYPES * FIELDS_PER_TILE          # 37
IDX_ICONN = IDX_DRAM + 1                                 # 38
IDX_TOPO = IDX_DRAM + 2                                  # 39
IDX_ASPECT = IDX_DRAM + 3                                # 40
IDX_NOC_BPC = IDX_DRAM + 4                               # 41
IDX_DRAM_CH = IDX_DRAM + 5                               # 42

_ASPECT_DEFAULT_IDX = KNOB_GRID["grid_aspect"].index(1.0)
_NOC_BPC_DEFAULT_IDX = KNOB_GRID["noc_bpc"].index(64)
# gene values that reproduce the pre-topology chip (mesh, square grid,
# 64 B/cycle NoC, one DRAM channel) — the canonical interconnect
INTERCONNECT_GENE_DEFAULTS = {
    IDX_TOPO: 0,
    IDX_ASPECT: _ASPECT_DEFAULT_IDX,
    IDX_NOC_BPC: _NOC_BPC_DEFAULT_IDX,
    IDX_DRAM_CH: 0,
}

_GRID_FOR_FIELD = {
    "count": KNOB_GRID["count"],
    "rows": KNOB_GRID["array_dim"],
    "cols": KNOB_GRID["array_dim"],
    "sram": KNOB_GRID["sram_kb"],
    "prec": KNOB_GRID["precision_set"],
    "sparsity": KNOB_GRID["sparsity"],
    "engine": KNOB_GRID["engine"],
    "dataflow": KNOB_GRID["dataflow"],
    "sfu": KNOB_GRID["sfu_mask"],
    "asym": KNOB_GRID["asym_mac"],
    "pipe": KNOB_GRID["pipeline_depth"],
    "db": KNOB_GRID["double_buffer"],
}

FAMILIES = ("homo", "hetero_bl", "hetero_bls")

Genome = np.ndarray  # (GENOME_LEN,) int32


def genome_bounds() -> np.ndarray:
    """Exclusive upper bound per gene (for sampling / mutation clipping)."""
    b: List[int] = [MAX_TILE_TYPES]  # n_tile_types - 1 in [0, 2]
    for _ in range(MAX_TILE_TYPES):
        b.extend(len(_GRID_FOR_FIELD[f]) for f in _TILE_FIELDS)
    b.append(len(KNOB_GRID["dram_gbps"]))
    b.append(len(KNOB_GRID["interconnect"]))
    b.append(len(KNOB_GRID["noc_topology"]))
    b.append(len(KNOB_GRID["grid_aspect"]))
    b.append(len(KNOB_GRID["noc_bpc"]))
    b.append(len(KNOB_GRID["dram_channels"]))
    return np.asarray(b, dtype=np.int32)


def _tile_slice(t: int) -> slice:
    start = 1 + t * FIELDS_PER_TILE
    return slice(start, start + FIELDS_PER_TILE)


def decode(genome: Genome, name: str = "dse") -> ChipConfig:
    """Decode a genome into a ChipConfig."""
    genome = np.asarray(genome, dtype=np.int64)
    n_types = int(genome[0]) + 1
    tiles: List[Tuple[TileTemplate, int]] = []
    for t in range(n_types):
        vals = dict(zip(_TILE_FIELDS, genome[_tile_slice(t)]))
        sfu = KNOB_GRID["sfu_mask"][vals["sfu"] % len(KNOB_GRID["sfu_mask"])]
        rows = KNOB_GRID["array_dim"][vals["rows"] % 5]
        cols = KNOB_GRID["array_dim"][vals["cols"] % 5]
        if sfu:
            rows = cols = 0
            clock = 800
            dsp_count, dsp_simd = 1, 64
        else:
            clock = 1200 if rows * cols >= 1024 else 500
            dsp_count = 2 if rows * cols >= 1024 else 1
            dsp_simd = 64
        tmpl = TileTemplate(
            name=f"t{t}" + ("s" if sfu else ""),
            rows=rows, cols=cols,
            engine=KNOB_GRID["engine"][vals["engine"] % 4],
            precisions=KNOB_GRID["precision_set"][vals["prec"] % 4],
            sparsity=KNOB_GRID["sparsity"][vals["sparsity"] % 3],
            dataflow=KNOB_GRID["dataflow"][vals["dataflow"] % 3],
            sram_kb=KNOB_GRID["sram_kb"][vals["sram"] % 7],
            dsp_count=dsp_count, dsp_simd=dsp_simd,
            sfu_mask=sfu,
            double_buffer=bool(KNOB_GRID["double_buffer"][vals["db"] % 2]),
            pipeline_depth=KNOB_GRID["pipeline_depth"][vals["pipe"] % 4],
            clock_mhz=clock,
            asym_mac=KNOB_GRID["asym_mac"][vals["asym"] % 4],
        )
        tiles.append((tmpl, int(KNOB_GRID["count"][vals["count"] % 8])))
    return ChipConfig(
        name=name, tiles=tuple(tiles),
        interconnect=KNOB_GRID["interconnect"][int(genome[IDX_ICONN]) % 4],
        dram_gbps=float(KNOB_GRID["dram_gbps"][int(genome[IDX_DRAM]) % 6]),
        torus=bool(KNOB_GRID["noc_topology"][int(genome[IDX_TOPO]) % 2]),
        grid_aspect=float(KNOB_GRID["grid_aspect"][int(genome[IDX_ASPECT]) % 3]),
        noc_bytes_per_cycle=float(KNOB_GRID["noc_bpc"][int(genome[IDX_NOC_BPC]) % 4]),
        dram_channels=int(KNOB_GRID["dram_channels"][int(genome[IDX_DRAM_CH]) % 4]),
    )


def _family_fixup(genomes: np.ndarray, family: str) -> np.ndarray:
    """Constrain genomes to an architecture-family stratum (§4.5)."""
    g = genomes
    if family == "homo":
        # iso-knob homogeneous baseline (§4.3): N identical FP16+INT8 MAC
        # tiles — the commercial-NPU template the savings are measured
        # against, on the stock mesh/1-channel interconnect
        g[:, 0] = 0
        for idx, v in INTERCONNECT_GENE_DEFAULTS.items():
            g[:, idx] = v
        sl = _tile_slice(0)
        g[:, sl.start + _TILE_FIELDS.index("sfu")] = 0
        g[:, sl.start + _TILE_FIELDS.index("prec")] = _HOMO_PREC_IDX
        # LNL-class baseline (§3.1): no sparsity skipping, no asym MACs
        g[:, sl.start + _TILE_FIELDS.index("sparsity")] = 0
        g[:, sl.start + _TILE_FIELDS.index("asym")] = 0
    elif family == "hetero_bl":
        g[:, 0] = 1
        for t in range(2):
            g[:, _tile_slice(t)][:, _TILE_FIELDS.index("sfu")] = 0
    else:  # hetero_bls: 3 types, third is Special-Function
        g[:, 0] = 2
        for t in range(2):
            g[:, _tile_slice(t)][:, _TILE_FIELDS.index("sfu")] = 0
        sfu_col = 1 + 2 * FIELDS_PER_TILE + _TILE_FIELDS.index("sfu")
        # force a non-empty SFU set on the third type
        g[:, sfu_col] = np.where(g[:, sfu_col] == 0,
                                 len(KNOB_GRID["sfu_mask"]) - 1, g[:, sfu_col])
    return g


def random_genomes(rng: np.random.Generator, n: int,
                   family: Optional[str] = None) -> np.ndarray:
    """Uniform random genomes, optionally constrained to a family stratum."""
    bounds = genome_bounds()
    g = (rng.random((n, GENOME_LEN)) * bounds).astype(np.int32)
    if family is not None:
        g = _family_fixup(g, family)
    return g


_GROWABLE = tuple(_TILE_FIELDS.index(f) for f in ("count", "rows", "cols", "sram"))


_BOUNDS_CACHE = genome_bounds()


def sample_in_bracket(rng: np.random.Generator, n: int, family: str,
                      bracket: float, area_fn, max_repair: int = 24,
                      max_attempts_per_sample: int = 12) -> np.ndarray:
    """Stratified sampling (paper §4.5): draw genomes and repair them into
    the (bracket/2, bracket] area band by growing/shrinking the structural
    genes (tile count, array dims, SRAM).  ``area_fn(genome) -> mm^2``.

    Some strata are unreachable (a single-type Homo chip tops out near
    ~220 mm^2 on the paper's knob grid): after the attempt budget, the
    largest-area genome seen is accepted with area <= bracket, so the
    800 mm^2 homogeneous baseline is simply "the biggest homo chip" —
    consistent with the paper's iso-area comparison semantics.
    """
    lo, hi = bracket / 2.0, bracket
    bounds = _BOUNDS_CACHE
    out = []
    while len(out) < n:
        best_fallback, best_area = None, -1.0
        accepted = False
        for _ in range(max_attempts_per_sample):
            g = random_genomes(rng, 1, family=family)[0]
            n_types = int(g[0]) + 1
            for _ in range(max_repair):
                a = area_fn(g)
                if lo < a <= hi:
                    out.append(g)
                    accepted = True
                    break
                if a <= hi and a > best_area:
                    best_fallback, best_area = g.copy(), a
                t = int(rng.integers(0, n_types))
                gene = 1 + t * FIELDS_PER_TILE + _GROWABLE[int(rng.integers(0, 4))]
                if a > hi and g[gene] > 0:
                    g[gene] -= 1
                elif a <= lo and g[gene] < bounds[gene] - 1:
                    g[gene] += 1
                else:
                    cg = 1 + t * FIELDS_PER_TILE
                    if a > hi and g[cg] > 0:
                        g[cg] -= 1
                    elif a <= lo and g[cg] < bounds[cg] - 1:
                        g[cg] += 1
            if accepted:
                break
        if not accepted:
            if best_fallback is None:
                best_fallback = random_genomes(rng, 1, family=family)[0]
            out.append(best_fallback)
    return np.asarray(out[:n])
