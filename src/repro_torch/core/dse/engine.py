"""Cache-aware DSE evaluation engine on torch -- the search's one hot path.

Port of ``repro/core/dse/engine.py``.  The default backend, ``"scan"``,
scores every cache miss with the approximate in-scan mapping of
``batch_eval.batch_evaluate``, one call per workload; ``rescore`` on a
scan engine goes through the exact path.  The compile-free exact backends,
``"exact"`` and ``"batched"``, score every cache miss with one
``compiler.batched_mapper.search_population`` call per micro-batch over
all the workloads (the exact Eq. 1-3 mapping and the batched plan
executor in one pass per workload, returning only the mode's three
metric columns); in the reference they are two programs with the same
results, so the two names share memo keys.  ``exact_mapper="python"``
compiles each candidate on the host instead (``map_graph`` ->
``emit_schedule`` -> ``lower_plan``) and executes the plan tables with
``simulator.batched.batch_simulate`` on the engine's device;
``backend="oracle"`` and ``rescore(oracle=True)`` walk the host
``ChipSim`` on the same placements.  The engine keeps the reference's
three host caches: the per-workload preparation cache
(``prepared_workload``, and ``_prepared_graph`` for the host compiler),
the genome memo behind the ``ResultStore`` interface (keys are ``mode:``
+ canonical genome bytes), and the vectorized genome -> config stacking
(``genomes_to_configs``, bitwise the reference's).

``EvalEngine(workloads, config=EngineConfig(...), device=None)`` runs on
``cuda`` and raises without a card unless ``device="cpu"`` is passed.
Every backend runs in both modes and both fidelity tiers.  ``shard=True``
splits each micro-batch over the local devices
(``launch.mesh.candidate_sharding``): the batch is padded to a multiple
of the device count by repeating its first row (``_pad_size``), each
device scores one contiguous block, and the blocks' rows are joined in
order, bit for bit the one-device result; on one device it is the
one-device path.  The blocks are dispatched one after another from the
calling thread, so while that stays so ``shard=True`` buys no speed on
several devices: it spreads the rows, not the time.  The
reference's deprecated per-knob constructor arguments (``batch=``,
``backend=``, ``memo_limit=`` and the rest) are keyword-only after
``device`` and behave as the reference's: one ``DeprecationWarning`` per
call, then the same ``EngineConfig``.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...device import resolve_device
from ..arch import KNOB_GRID, MAX_TILE_TYPES, MAX_TILES, prec_mask
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..compiler.batched_mapper import search_population
from ..compiler.fusion import fuse
from ..compiler.mapper import UnmappableError, map_graph
from ..compiler.pipeline import lower_plan
from ..compiler.precision import assign_precision
from ..compiler.schedule import emit_schedule
from ..simulator.batched import CHIP_KEYS as _CHIP_KEYS
from ..simulator.batched import (batch_simulate, place_configs,
                                 stack_plan_tables)
from ..simulator.costs import grid_dims
from ..simulator.orchestrator import (CACHE_FRAC, SCHEDULE_MODES,
                                      check_fidelity, noc_hops)
from ..simulator.orchestrator import simulate as oracle_simulate
from ..workloads import build
from .api import BACKENDS, META_VERSION, EngineConfig
from .batch_eval import batch_evaluate, prepare_configs, prepare_workload
from .encoding import (FIELDS_PER_TILE, GENOME_LEN, IDX_ASPECT, IDX_DRAM,
                       IDX_DRAM_CH, IDX_ICONN, IDX_NOC_BPC, IDX_TOPO,
                       _TILE_FIELDS, decode)
from .store import MemoryLRUStore, ResultStore, TieredStore

__all__ = ["EvalEngine", "EngineStats", "EngineConfig",
           "NonFiniteMetricsError", "genomes_to_configs", "genome_areas",
           "canonical_genomes", "prepared_workload", "BACKENDS",
           "SCHEDULE_MODES"]


class NonFiniteMetricsError(RuntimeError):
    """A freshly simulated metric row contained NaN (or a non-finite
    TOPS/W) — raised *before* the row can enter any memo, store, or
    Pareto front, naming the offending canonical genome.  ``retryable``
    because the poisoned batch was never memoized: a retry re-simulates
    it cleanly when the corruption was transient (the chaos suite's
    injected-NaN case)."""

    retryable = True

    def __init__(self, canon: np.ndarray, mode: str,
                 row: Tuple[np.ndarray, np.ndarray, np.ndarray]):
        self.canon = np.asarray(canon, np.int64).copy()
        self.mode = str(mode)
        self.row = tuple(np.asarray(a, np.float64).copy() for a in row)
        super().__init__(
            f"non-finite metrics for canonical genome "
            f"{self.canon.tolist()} (mode={self.mode}): lat="
            f"{self.row[0].tolist()} en={self.row[1].tolist()} "
            f"tops_w={self.row[2].tolist()}; pass nonfinite='skip' to "
            f"score such rows -inf instead")


# metric keys each §3.2 schedule mode scores on
_MODE_KEYS = {
    "latency": ("latency_s", "energy_pj", "achieved_tops"),
    "throughput": ("ii_s", "energy_ss_pj", "achieved_tops_ss"),
}


@functools.lru_cache(maxsize=128)
def _prepared_graph(name: str, aggressive_int4: bool = False,
                    enable_fusion: bool = True):
    """Config-independent compiler passes 1-2 on one workload, cached so
    the per-candidate paths re-run only the per-chip mapping.  Callers
    must treat the returned graph as read-only (map_graph does)."""
    g = copy.deepcopy(build(name))
    g = assign_precision(g, aggressive_int4=aggressive_int4)
    if enable_fusion:
        g = fuse(g)
    return g


# =============================================================================
# workload preparation cache (cache 1)
# =============================================================================

@functools.lru_cache(maxsize=128)
def prepared_workload(name: str, aggressive_int4: bool = False,
                      enable_fusion: bool = True) -> Dict[str, np.ndarray]:
    """Config-independent compile of one workload, cached process-wide.
    Callers must treat the returned arrays as read-only."""
    return prepare_workload(build(name), aggressive_int4=aggressive_int4,
                            enable_fusion=enable_fusion)


# =============================================================================
# vectorized genome -> SoA config stacking (cache 3's fast path)
# =============================================================================
# Grid lookup tables.  Index order matches KNOB_GRID, and the modulo used
# per field matches decode() exactly.

_ARRAY_DIM = np.asarray(KNOB_GRID["array_dim"], np.float64)
_SRAM_KB = np.asarray(KNOB_GRID["sram_kb"], np.float64)
_COUNT = np.asarray(KNOB_GRID["count"], np.int64)
_SFU = np.asarray(KNOB_GRID["sfu_mask"], np.float64)
_ENGINE = np.asarray([int(e) for e in KNOB_GRID["engine"]], np.float64)
_SPARSITY = np.asarray([int(s) for s in KNOB_GRID["sparsity"]], np.float64)
_DATAFLOW = np.asarray([int(d) for d in KNOB_GRID["dataflow"]], np.float64)
_PIPE = np.asarray(KNOB_GRID["pipeline_depth"], np.float64)
_DB = np.asarray([float(b) for b in KNOB_GRID["double_buffer"]], np.float64)
_ASYM = np.asarray([int(a) for a in KNOB_GRID["asym_mac"]], np.float64)
_PREC_MASK = np.asarray([prec_mask(sorted(s))
                         for s in KNOB_GRID["precision_set"]], np.float64)
_PREC_MAX = np.asarray([int(max(s, key=int))
                        for s in KNOB_GRID["precision_set"]], np.int64)
_DRAM = np.asarray(KNOB_GRID["dram_gbps"], np.float64)
_ICONN = [ic for ic in KNOB_GRID["interconnect"]]
# interconnect-structure gene grids (PR 9 topology genes)
_TOPO = np.asarray([float(b) for b in KNOB_GRID["noc_topology"]], np.float64)
_ASPECT = np.asarray(KNOB_GRID["grid_aspect"], np.float64)
_NOC_BPC = np.asarray(KNOB_GRID["noc_bpc"], np.float64)
_DRAM_CH = np.asarray(KNOB_GRID["dram_channels"], np.float64)
# hop counts tabulated over (interconnect, num_tiles): 4 x (MAX_TILES+1)
_HOPS_TABLE = np.asarray(
    [[float(noc_hops(ic, max(n, 1))) for n in range(MAX_TILES + 1)]
     for ic in _ICONN], np.float64)

_FIELD_COL = {f: i for i, f in enumerate(_TILE_FIELDS)}


def _tile_cols(genomes: np.ndarray, t: int, field: str) -> np.ndarray:
    return genomes[:, 1 + t * FIELDS_PER_TILE + _FIELD_COL[field]]


def _per_type_values(genomes: np.ndarray, calib: CalibrationTable):
    """(B, MAX_TILE_TYPES) arrays of per-tile-type template values,
    replicating decode()'s knob lookups (including its modulo wrapping) and
    tile_area()'s arithmetic term-for-term so parity is bitwise."""
    B = len(genomes)
    T = MAX_TILE_TYPES
    v: Dict[str, np.ndarray] = {}
    f64 = lambda a: np.asarray(a, np.float64)

    sfu_idx = np.stack([_tile_cols(genomes, t, "sfu") % len(_SFU)
                        for t in range(T)], axis=1)
    sfu = _SFU[sfu_idx]
    special = sfu > 0

    rows = np.stack([_ARRAY_DIM[_tile_cols(genomes, t, "rows") % 5]
                     for t in range(T)], axis=1)
    cols = np.stack([_ARRAY_DIM[_tile_cols(genomes, t, "cols") % 5]
                     for t in range(T)], axis=1)
    rows = np.where(special, 0.0, rows)
    cols = np.where(special, 0.0, cols)
    big = rows * cols >= 1024.0
    v["rows"], v["cols"] = rows, cols
    v["num_macs"] = rows * cols
    v["clock_mhz"] = np.where(special, 800.0, np.where(big, 1200.0, 500.0))
    v["dsp_count"] = np.where(special, 1.0, np.where(big, 2.0, 1.0))
    v["dsp_simd"] = np.full((B, T), 64.0)
    v["sfu_mask"] = sfu
    v["sfu_parallel"] = np.full((B, T), 16.0)
    v["sram_bpc"] = np.full((B, T), 8 * 16.0)   # default sram_banks=8

    v["engine"] = np.stack([_ENGINE[_tile_cols(genomes, t, "engine") % 4]
                            for t in range(T)], axis=1)
    prec_idx = np.stack([_tile_cols(genomes, t, "prec") % 4
                         for t in range(T)], axis=1)
    v["prec_mask"] = _PREC_MASK[prec_idx]
    max_prec = _PREC_MAX[prec_idx]
    v["max_prec"] = f64(max_prec)
    v["sparsity"] = np.stack([_SPARSITY[_tile_cols(genomes, t, "sparsity") % 3]
                              for t in range(T)], axis=1)
    v["dataflow"] = np.stack([_DATAFLOW[_tile_cols(genomes, t, "dataflow") % 3]
                              for t in range(T)], axis=1)
    v["sram_kb"] = np.stack([_SRAM_KB[_tile_cols(genomes, t, "sram") % 7]
                             for t in range(T)], axis=1)
    v["double_buffer"] = np.stack([_DB[_tile_cols(genomes, t, "db") % 2]
                                   for t in range(T)], axis=1)
    v["pipeline_depth"] = np.stack([_PIPE[_tile_cols(genomes, t, "pipe") % 4]
                                    for t in range(T)], axis=1)
    v["asym_mac"] = np.stack([_ASYM[_tile_cols(genomes, t, "asym") % 4]
                              for t in range(T)], axis=1)
    v["cache_cap"] = v["sram_kb"] * 1024.0 * CACHE_FRAC
    v["dsp_lanes"] = v["dsp_count"] * v["dsp_simd"]
    v["clock_hz"] = v["clock_mhz"] * 1e6

    # tile_area (Eq. 7), same term order as simulator.area.area_breakdown
    a_mac_mm2 = np.asarray(calib.a_mac_mm2, np.float64)
    eng_a = np.asarray(calib.engine_a_mult, np.float64)
    sp_a = np.asarray(calib.sparsity_a_mult, np.float64)
    eng_idx = np.asarray(v["engine"], np.int64)
    sp_idx = np.asarray(v["sparsity"], np.int64)
    a_mac_unit = a_mac_mm2[max_prec] * eng_a[eng_idx]
    a_mac = v["num_macs"] * a_mac_unit * sp_a[sp_idx]
    a_sram = v["sram_kb"] * calib.a_sram_mm2_per_kb
    a_dsp = v["dsp_count"] * v["dsp_simd"] * calib.a_dsp_mm2_per_lane
    sfu_i = np.asarray(sfu, np.int64)
    a_spec = np.where(sfu_i & 1, calib.a_fft_mm2, 0.0)
    a_spec = a_spec + np.where(sfu_i & 2, calib.a_lif_mm2, 0.0)
    a_spec = a_spec + np.where(sfu_i & 4, calib.a_poly_mm2, 0.0)
    a_ports = calib.a_ports_base_mm2 \
        + (rows + cols) * calib.a_ports_per_lane_mm2
    v["area_mm2"] = a_mac + a_sram + a_dsp + a_spec + a_ports

    counts = np.stack([_COUNT[_tile_cols(genomes, t, "count") % 8]
                       for t in range(T)], axis=1)
    n_types = (genomes[:, 0] + 1)[:, None]  # decode: genome[0] + 1
    counts = np.where(np.arange(T)[None, :] < n_types, counts, 0)
    v["counts"] = counts
    return v


def genomes_to_configs(genomes: np.ndarray,
                       calib: CalibrationTable = DEFAULT_CALIB
                       ) -> Dict[str, Dict[str, np.ndarray]]:
    """Vectorized equivalent of ``prepare_configs([decode(g) for g in
    genomes], calib)`` — bitwise identical output, no per-genome Python
    object materialization."""
    genomes = np.asarray(genomes, dtype=np.int64).reshape(-1, GENOME_LEN)
    B = len(genomes)
    v = _per_type_values(genomes, calib)
    counts = v["counts"]                        # (B, T) ints
    starts = np.zeros_like(counts)
    starts[:, 1:] = np.cumsum(counts, axis=1)[:, :-1]
    ends = starts + counts

    slots = np.arange(MAX_TILES)                # (S,)
    # (B, T, S) membership of each instance slot in each tile type
    member = (slots[None, None, :] >= starts[:, :, None]) \
        & (slots[None, None, :] < ends[:, :, None])

    tile_f = {}
    for f in ("num_macs", "rows", "cols", "engine", "prec_mask", "asym_mac",
              "sparsity", "dataflow", "sram_kb", "dsp_lanes", "dsp_count",
              "sfu_mask", "sfu_parallel", "double_buffer", "pipeline_depth",
              "clock_hz", "cache_cap", "sram_bpc", "area_mm2", "max_prec"):
        # exactly one membership per occupied slot -> the masked sum is the
        # per-type value itself, bit-for-bit
        tile_f[f] = np.sum(np.where(member, v[f][:, :, None], 0.0), axis=1)
    tile_f["exists"] = member.any(axis=1).astype(np.float64)

    num_tiles = counts.sum(axis=1)              # (B,) ints
    chip_f = {f: np.zeros(B) for f in _CHIP_KEYS}
    chip_f["dram_gbps"] = _DRAM[genomes[:, IDX_DRAM] % 6].copy()
    iconn_idx = np.asarray(genomes[:, IDX_ICONN] % 4)
    chip_f["hops"] = _HOPS_TABLE[iconn_idx, num_tiles]
    chip_f["noc_bpc"] = _NOC_BPC[genomes[:, IDX_NOC_BPC] % 4].copy()
    chip_f["noc_base_cycles"] = np.full(B, 8.0)  # ChipConfig defaults
    chip_f["ref_clock_hz"] = np.full(B, 1000 * 1e6)
    # interconnect-structure genes (decode()'s knob lookups, vectorized)
    chip_f["torus"] = _TOPO[genomes[:, IDX_TOPO] % 2].copy()
    chip_f["dram_channels"] = _DRAM_CH[genomes[:, IDX_DRAM_CH] % 4].copy()
    aspect = _ASPECT[genomes[:, IDX_ASPECT] % 3]
    gw, gh = grid_dims(np.asarray(num_tiles, np.float64), aspect)
    chip_f["grid_w"], chip_f["grid_h"] = gw, gh

    # peak_tops: sequential per-instance sum, matching prepare_configs
    term = tile_f["num_macs"] * tile_f["clock_hz"]
    acc = np.zeros(B)
    for s in range(MAX_TILES):
        acc = acc + term[:, s]
    chip_f["peak_tops"] = acc / 1e12

    # chip_area: per-type tile_area * count summed in type order + NoC
    # (router/link width + torus scale) + extra DRAM-channel PHYs —
    # term-for-term simulator.area.chip_area
    area = np.zeros(B)
    for t in range(MAX_TILE_TYPES):
        area = area + v["area_mm2"][:, t] * counts[:, t]
    noc_scale = (0.5 + 0.5 * chip_f["noc_bpc"] / 64.0) \
        * np.where(chip_f["torus"] > 0, 1.25, 1.0)
    area = area + num_tiles * calib.a_noc_mm2_per_tile * noc_scale
    chip_f["chip_area"] = area \
        + (chip_f["dram_channels"] - 1) * calib.a_dram_phy_mm2
    return {"tile": tile_f, "chip": chip_f}


def genome_areas(genomes: np.ndarray,
                 calib: CalibrationTable = DEFAULT_CALIB) -> np.ndarray:
    """(N,) chip areas straight from genomes (== chip_area(decode(g)))."""
    return genomes_to_configs(genomes, calib)["chip"]["chip_area"]


_SFU_COL = _FIELD_COL["sfu"]
# genes decode() ignores on a Special-Function tile (rows/cols are forced
# to 0) plus the MAC-path knobs whose values only feed terms that a
# zero-MAC tile multiplies or gates away (engine/precision/sparsity/
# dataflow/asym/pipeline) — bitwise inertness is pinned by
# tests/test_engine.py::test_special_tile_inert_genes
_SPECIAL_INERT_COLS = tuple(
    _FIELD_COL[f] for f in ("rows", "cols", "engine", "prec", "sparsity",
                            "dataflow", "asym", "pipe"))
_PREC_COL = _FIELD_COL["prec"]
_ASYM_COL = _FIELD_COL["asym"]
# asym_mac acts only through supports_precision, so per precision-set the
# four variants collapse into equivalence classes (row = prec gene, col =
# asym gene): {INT8} gains INT4 from W4A8/W2A8 and nothing from W4A16;
# {INT4,INT8} and the full set gain nothing; {INT8,FP16} gains INT4 from
# any variant.  Pinned bitwise by tests/test_engine.py.
_ASYM_CANON = np.asarray([[0, 1, 1, 0],
                          [0, 0, 0, 0],
                          [0, 1, 1, 1],
                          [0, 0, 0, 0]], np.int64)


def canonical_genomes(genomes: np.ndarray) -> np.ndarray:
    """Zero every don't-care gene so genomes that decode() maps to the
    same chip (or to chips with bitwise-identical metrics) share one memo
    entry: the tile-type blocks beyond ``n_tile_types``, and the inert
    genes of Special-Function tiles.  Crossover and mutation constantly
    touch these genes — without canonicalization every such child looks
    novel and gets re-simulated."""
    g = np.asarray(genomes, dtype=np.int64).reshape(-1, GENOME_LEN).copy()
    n_types = g[:, 0] + 1
    for t in range(MAX_TILE_TYPES):
        base = 1 + t * FIELDS_PER_TILE
        inactive = t >= n_types
        block = g[:, base:base + FIELDS_PER_TILE]
        g[:, base:base + FIELDS_PER_TILE] = \
            np.where(inactive[:, None], 0, block)
        special = (_SFU[g[:, base + _SFU_COL] % len(_SFU)] > 0) & ~inactive
        for col in _SPECIAL_INERT_COLS:
            g[:, base + col] = np.where(special, 0, g[:, base + col])
        g[:, base + _ASYM_COL] = _ASYM_CANON[g[:, base + _PREC_COL] % 4,
                                             g[:, base + _ASYM_COL] % 4]
    return g



# =============================================================================
# the engine
# =============================================================================

@dataclasses.dataclass
class EngineStats:
    """Counters over the engine's lifetime.  ``requests`` counts genome
    scoring requests (one per genome per evaluate() call); a request is a
    hit (memoized), a skip (rejected by the ``keep`` predicate), or a
    miss (simulated now, on every workload)."""

    requests: int = 0
    hits: int = 0
    skips: int = 0
    misses: int = 0
    eval_seconds: float = 0.0
    workloads: int = 0
    # fused miss-batch dispatches: one per simulated micro-batch (the unit
    # the serving layer's cross-request coalescing reduces)
    dispatches: int = 0

    def hit_rate(self) -> float:
        return self.hits / max(self.requests, 1)

    def throughput(self) -> float:
        """Scored (config x workload) pairs per second of evaluate() time,
        counting cache hits as scored work (that is the point)."""
        pairs = (self.hits + self.misses) * self.workloads
        return pairs / max(self.eval_seconds, 1e-12)


# sentinel distinguishing "caller passed this legacy kwarg" (deprecation
# shim fires) from "default" on EvalEngine.__init__
_UNSET = object()


class EvalEngine:
    """Unified cached scorer: genomes x fixed workload list -> metrics.

    ``evaluate`` returns ``latency`` (N, W), ``energy`` (N, W),
    ``tops_w`` (N, W), ``area`` (N,) and ``meta``; in throughput mode the
    three metric columns are the steady-state II, per-inference energy
    and TOPS/W.  ``device`` (default: the card) is where every miss is
    simulated.
    """

    def __init__(self, workloads: Sequence[str],
                 calib: CalibrationTable = DEFAULT_CALIB,
                 config: Optional[EngineConfig] = None,
                 device=None, *,
                 batch=_UNSET, memoize=_UNSET, vectorized=_UNSET,
                 shard=_UNSET, aggressive_int4=_UNSET,
                 enable_fusion=_UNSET, memo_max=_UNSET, backend=_UNSET,
                 exact_mapper=_UNSET, mode=_UNSET, memo_limit=_UNSET,
                 store=_UNSET, nonfinite=_UNSET, fidelity=_UNSET):
        # ``config=EngineConfig(...)`` is the canonical construction; the
        # per-knob kwargs are the reference's pre-config surface, kept
        # working behind a deprecation shim (they warn, then assemble the
        # same config).
        if memo_limit is not _UNSET:
            warnings.warn(
                "EvalEngine(memo_limit=...) is deprecated; pass "
                "config=EngineConfig(memo_max=...) (memo_limit is the "
                "old alias of memo_max)", DeprecationWarning, stacklevel=2)
            if memo_max is not _UNSET:
                raise ValueError("pass memo_max or its legacy alias "
                                 "memo_limit, not both")
            memo_max = memo_limit
        legacy = {k: v for k, v in [
            ("batch", batch), ("memoize", memoize),
            ("vectorized", vectorized), ("shard", shard),
            ("aggressive_int4", aggressive_int4),
            ("enable_fusion", enable_fusion), ("memo_max", memo_max),
            ("backend", backend), ("exact_mapper", exact_mapper),
            ("mode", mode), ("store", store), ("nonfinite", nonfinite),
            ("fidelity", fidelity)] if v is not _UNSET}
        if config is not None:
            if legacy:
                raise ValueError(
                    f"pass config=EngineConfig(...) or the legacy per-knob "
                    f"kwargs, not both (got both config= and "
                    f"{sorted(legacy)})")
        else:
            if legacy:
                warnings.warn(
                    f"EvalEngine per-knob kwargs ({sorted(legacy)}) are "
                    f"deprecated; pass config=EngineConfig(...) instead",
                    DeprecationWarning, stacklevel=2)
            config = EngineConfig(**legacy)
        check_fidelity(config.fidelity)
        self.device = resolve_device(device)
        self.shard = config.shard
        self._devices = None
        if config.shard:
            from ...launch.mesh import candidate_sharding
            self._devices = candidate_sharding(self.device)
        self.config = config
        self.exact_mapper = config.exact_mapper
        self.mode = config.mode
        self.fidelity = config.fidelity
        self.workloads = list(workloads)
        self.calib = calib
        self.batch = config.batch
        self.memoize = config.memoize
        self.vectorized = config.vectorized
        self.aggressive_int4 = config.aggressive_int4
        self.enable_fusion = config.enable_fusion
        self.backend = config.backend
        self.nonfinite = config.nonfinite
        self.stats = EngineStats(workloads=len(self.workloads))
        explicit_cap = config.memo_max is not None
        self.memo_max = max(config.memo_max if explicit_cap else 131_072,
                            self.batch)
        if config.store is None:
            self.store: ResultStore = MemoryLRUStore(self.memo_max)
        else:
            self.store = config.store
            if explicit_cap:
                store = self.store
                lru = store if isinstance(store, MemoryLRUStore) else (
                    store.front if isinstance(store, TieredStore)
                    and isinstance(store.front, MemoryLRUStore) else None)
                if lru is None:
                    raise ValueError(
                        "memo_max cannot cap a store without an in-memory "
                        "LRU tier -- size the store yourself and drop "
                        "memo_max, or wrap it in a TieredStore with a "
                        "MemoryLRUStore front")
                lru.resize(self.memo_max)
        self.store.bind(self.context_key())
        # export_memo's bulk views, keyed on the LRU tier's mutation stamp
        # (_memo_stamp): a preload over an unchanged store skips the walk
        self._export_cache: Dict[str, Tuple[tuple, Tuple[np.ndarray,
                                                         np.ndarray]]] = {}

    def context_key(self) -> bytes:
        """``api.context_digest`` over this engine's config, framework and
        device type (``EngineConfig.context_digest``)."""
        return self.config.context_digest(self.workloads, self.calib,
                                          self.device)

    # ------------------------------------------------------------- plumbing
    def check_workloads(self, workloads: Sequence[str],
                        calib: Optional[CalibrationTable] = None
                        ) -> "EvalEngine":
        """Guard for shared-engine frontends: metric columns follow
        *this* engine's workload order and calibration, so a caller
        holding a different list (or passing a different calib) would get
        silently mislabeled or miscalibrated numbers."""
        if list(workloads) != self.workloads:
            raise ValueError(
                f"engine workloads {self.workloads} != caller workloads "
                f"{list(workloads)}")
        if calib is not None and calib != self.calib:
            raise ValueError("caller calib differs from the shared "
                             "engine's calib — results would not match")
        return self

    def _prepared(self, wname: str) -> Dict[str, np.ndarray]:
        return prepared_workload(wname, self.aggressive_int4,
                                 self.enable_fusion)

    def _configs(self, genomes: np.ndarray):
        if self.vectorized:
            return genomes_to_configs(genomes, self.calib)
        chips = [decode(g, f"g{i}") for i, g in enumerate(genomes)]
        return prepare_configs(chips, self.calib)

    @staticmethod
    def _key(genome: np.ndarray) -> bytes:
        return np.ascontiguousarray(genome, dtype=np.int64).tobytes()

    @staticmethod
    def _take(cfgs, idx):
        return {"tile": {k: v[idx] for k, v in cfgs["tile"].items()},
                "chip": {k: v[idx] for k, v in cfgs["chip"].items()}}

    def _pad_size(self, n: int) -> int:
        """Rows a sharded micro-batch is padded to: ``n`` rounded up to a
        multiple of the device count, so that every device takes an equal
        block (the reference rounds its jit bucket up the same way; the
        port compiles no shapes, so there is no bucket).  ``n`` on one
        device."""
        ndev = len(self._devices) if self._devices is not None else 1
        return -(-n // ndev) * ndev

    def _blocks(self, n: int):
        """How ``n`` rows are split: ``(pad, [(device, rows), ...])``, the
        padded row count (``_pad_size``; the callers fill the padding with
        row 0) and one contiguous ``slice`` of the padded rows per device,
        in order.  One block of ``n`` rows on one device.  The callers
        (``_simulate`` and the fused GA's scorer) dispatch the blocks one
        after another from one thread, so more devices add padding and
        transfers but no speed until the dispatch runs them at once."""
        devs = self._devices or [self.device]
        pad = self._pad_size(n)
        blk = pad // len(devs)
        return pad, [(d, slice(i * blk, (i + 1) * blk))
                     for i, d in enumerate(devs)]

    def _simulate(self, cfgs, genomes: np.ndarray, mode: str,
                  oracle: Optional[bool] = None, exact: bool = False):
        """(n, W) lat/en/tw for a config stack (and its genomes) through
        this engine's backend, or the oracle when ``oracle`` says so;
        ``exact`` sends a scan engine through the exact paths
        (``rescore``).  Unmappable (genome, workload) pairs score inf
        latency/energy and 0 TOPS/W.  A sharded engine pads the stack to
        ``_pad_size`` rows by repeating row 0 and scores one contiguous
        block per device."""
        self.stats.dispatches += 1
        n = len(genomes)
        pad, blocks = self._blocks(n)
        if len(blocks) == 1 or n == 0:
            return self._dispatch(cfgs, genomes, mode, oracle, exact,
                                  self.device)
        sel = np.concatenate([np.arange(n), np.zeros(pad - n, np.int64)])
        cfgs, genomes = self._take(cfgs, sel), genomes[sel]
        parts = [self._dispatch(self._take(cfgs, np.arange(pad)[rows]),
                                genomes[rows], mode, oracle, exact, dev)
                 for dev, rows in blocks]
        return tuple(np.concatenate([p[k] for p in parts])[:n]
                     for k in range(3))

    def _dispatch(self, cfgs, genomes: np.ndarray, mode: str,
                  oracle: Optional[bool], exact: bool, device):
        """``_simulate``'s work for one block on ``device``."""
        oracle = self.backend == "oracle" if oracle is None else oracle
        if self.backend == "scan" and not (exact or oracle):
            return self._simulate_scan(cfgs, mode, device)
        if oracle or self.exact_mapper == "python":
            return self._simulate_per_candidate(cfgs, genomes, mode, oracle,
                                                device)
        lkey, ekey, akey = _MODE_KEYS[mode]
        n, W = len(cfgs["chip"]["chip_area"]), len(self.workloads)
        lat = np.full((n, W), np.inf)
        en = np.full((n, W), np.inf)
        tw = np.zeros((n, W))
        # device placement once, not once per workload
        placed = place_configs(cfgs, device)
        results = search_population(
            [self._prepared(w) for w in self.workloads], cfgs, self.calib,
            mode=mode, out_keys=(lkey, ekey, akey),
            fidelity=self.fidelity, device=device, placed=placed)
        for j, res in enumerate(results):
            ok = res["ok"]
            l, e = res[lkey], res[ekey]
            lat[ok, j] = l[ok]
            en[ok, j] = e[ok]
            power = e[ok] * 1e-12 / np.maximum(l[ok], 1e-30)
            tw[ok, j] = res[akey][ok] / np.maximum(power, 1e-30)
        return lat, en, tw

    def _simulate_scan(self, cfgs, mode: str, device):
        """The scan backend: ``batch_evaluate`` per workload on ``device``
        (the approximate in-scan mapping; unmappable pairs score inf
        latency and energy through it)."""
        lkey, ekey, akey = _MODE_KEYS[mode]
        n, W = len(cfgs["chip"]["chip_area"]), len(self.workloads)
        lat = np.zeros((n, W))
        en = np.zeros((n, W))
        tw = np.zeros((n, W))
        placed = place_configs(cfgs, device)
        for j, wname in enumerate(self.workloads):
            res = batch_evaluate(self._prepared(wname), cfgs, self.calib,
                                 fidelity=self.fidelity, device=device,
                                 placed=placed)
            lat[:, j] = res[lkey]
            en[:, j] = res[ekey]
            power = res[ekey] * 1e-12 / np.maximum(res[lkey], 1e-30)
            tw[:, j] = res[akey] / np.maximum(power, 1e-30)
        return lat, en, tw

    def _simulate_per_candidate(self, cfgs, genomes: np.ndarray, mode: str,
                                oracle: bool, device):
        """The per-candidate exact paths: ``map_graph`` on each decoded
        chip, then either the plan tables through ``batch_simulate`` on
        ``device`` (``exact_mapper="python"``; the chips'
        fields come from ``cfgs``, the stack the batched backend scores,
        so the two agree bit for bit), or the host ``ChipSim`` walk of
        each plan (``oracle``)."""
        lkey, ekey, akey = _MODE_KEYS[mode]
        chips = [decode(g, f"x{i}") for i, g in enumerate(genomes)]
        n, W = len(chips), len(self.workloads)
        lat = np.full((n, W), np.inf)
        en = np.full((n, W), np.inf)
        tw = np.zeros((n, W))
        for j, wname in enumerate(self.workloads):
            g = _prepared_graph(wname, self.aggressive_int4,
                                self.enable_fusion)
            plans, rows = [], []
            for i, chip in enumerate(chips):
                try:
                    placements = map_graph(g, chip, self.calib)
                except UnmappableError:
                    continue
                plans.append(emit_schedule(g, placements, mode=mode))
                rows.append(i)
            if not rows:
                continue
            if oracle:
                for i, plan in zip(rows, plans):
                    r = oracle_simulate(chips[i], plan, self.calib,
                                        fidelity=self.fidelity)
                    if mode == "throughput":
                        lat[i, j] = r.pipeline["ii_s"]
                        en[i, j] = r.pipeline["energy_ss_pj"]
                        a = r.pipeline["achieved_tops_ss"]
                    else:
                        lat[i, j], en[i, j] = r.latency_s, r.energy_pj
                        a = r.achieved_tops
                    power = en[i, j] * 1e-12 / max(lat[i, j], 1e-30)
                    tw[i, j] = a / max(power, 1e-30)
                continue
            tables = [lower_plan(p, chips[i].num_tiles)
                      for i, p in zip(rows, plans)]
            res = batch_simulate(stack_plan_tables(tables),
                                 self._take(cfgs, np.asarray(rows)),
                                 self.calib, mode=mode,
                                 fidelity=self.fidelity, device=device)
            l, e = res[lkey], res[ekey]
            lat[rows, j] = l
            en[rows, j] = e
            power = e * 1e-12 / np.maximum(l, 1e-30)
            tw[rows, j] = res[akey] / np.maximum(power, 1e-30)
        return lat, en, tw

    def _check_mode(self, mode: Optional[str]) -> str:
        mode = self.mode if mode is None else mode
        if mode not in SCHEDULE_MODES:
            raise ValueError(f"mode {mode!r} not in {SCHEDULE_MODES}")
        return mode

    # ----------------------------------------------------------- score_batch
    def score_batch(self, genomes: np.ndarray,
                    mode: Optional[str] = None) -> Dict[str, np.ndarray]:
        """The reentrant engine core: canonical (or raw) genomes in, this
        backend's metrics out, one dispatch per ``batch`` rows -- no cache
        interaction, no keep predicate, no request/hit/miss accounting
        (only ``stats.dispatches`` counts).  The port compiles no shapes,
        so only a sharded engine pads a micro-batch (``_pad_size``).
        Returns ``latency``/``energy``/
        ``tops_w`` (N, W) and ``area`` (N,), bit for bit ``evaluate``'s
        rows for the same genomes."""
        mode = self._check_mode(mode)
        genomes = np.asarray(genomes, dtype=np.int64).reshape(-1, GENOME_LEN)
        n = len(genomes)
        cfgs = self._configs(genomes)
        area = np.asarray(cfgs["chip"]["chip_area"], np.float64).copy()
        lat = np.zeros((n, len(self.workloads)))
        en = np.zeros_like(lat)
        tw = np.zeros_like(lat)
        for s in range(0, n, self.batch):
            chunk = np.arange(s, min(s + self.batch, n))
            l, e, t = self._simulate(self._take(cfgs, chunk),
                                     genomes[chunk], mode)
            lat[chunk], en[chunk], tw[chunk] = l, e, t
        return {"latency": lat, "energy": en, "tops_w": tw, "area": area}

    # ------------------------------------------------------------- evaluate
    def evaluate(self, genomes: np.ndarray,
                 keep: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 mode: Optional[str] = None,
                 canonical: Optional[np.ndarray] = None
                 ) -> Dict[str, np.ndarray]:
        """Score every genome on every workload, through the memo.

        ``keep(areas) -> (N,) bool`` skips simulation of genomes the caller
        will discard (they come back inf / inf / 0 and are not memoized);
        ``mode`` overrides the engine's schedule mode for this call;
        ``canonical`` supplies precomputed ``canonical_genomes`` rows.
        """
        mode = self._check_mode(mode)
        t0 = time.perf_counter()
        pre = dataclasses.replace(self.stats)
        genomes = np.asarray(genomes, dtype=np.int64).reshape(-1, GENOME_LEN)
        n, W = len(genomes), len(self.workloads)
        lat = np.zeros((n, W))
        en = np.zeros((n, W))
        tw = np.zeros((n, W))
        cfgs = self._configs(genomes)
        area = np.asarray(cfgs["chip"]["chip_area"], np.float64).copy()
        self.stats.requests += n

        tag = mode.encode() + b":"
        canon = canonical_genomes(genomes) if canonical is None else \
            np.asarray(canonical, np.int64).reshape(-1, GENOME_LEN)
        keys = [tag + self._key(g) for g in canon]
        keep_mask = np.ones(n, bool) if keep is None else \
            np.asarray(keep(area), bool)

        miss_idx: List[int] = []
        dup_idx: List[int] = []
        seen_this_call: Dict[bytes, int] = {}
        for i, k in enumerate(keys):
            row = self.store.get(k) if self.memoize else None
            if row is not None:
                lat[i], en[i], tw[i] = row
                self.stats.hits += 1
            elif not keep_mask[i]:
                lat[i] = np.inf
                en[i] = np.inf
                self.stats.skips += 1
            elif self.memoize and k in seen_this_call:
                dup_idx.append(i)       # resolved from the first copy's row
                self.stats.hits += 1
            else:
                seen_this_call[k] = i
                miss_idx.append(i)
                self.stats.misses += 1

        nonfinite = 0
        for s in range(0, len(miss_idx), self.batch):
            chunk = miss_idx[s:s + self.batch]
            l, e, t = self._simulate(self._take(cfgs, np.asarray(chunk)),
                                     genomes[chunk], mode)
            for r, i in enumerate(chunk):
                # NaN anywhere (or a non-finite TOPS/W) is cost-model
                # corruption and must not be cached; unmappable rows
                # legitimately score (inf, inf, 0)
                if (np.isnan(l[r]).any() or np.isnan(e[r]).any()
                        or np.isnan(t[r]).any() or np.isinf(t[r]).any()):
                    nonfinite += 1
                    if self.nonfinite == "raise":
                        raise NonFiniteMetricsError(
                            canon[i], mode, (l[r], e[r], t[r]))
                    lat[i], en[i] = np.inf, np.inf
                    tw[i] = 0.0
                    continue
                lat[i], en[i], tw[i] = l[r], e[r], t[r]
                if self.memoize:
                    self.store.put(
                        keys[i], (l[r].copy(), e[r].copy(), t[r].copy()))
        for i in dup_idx:
            j = seen_this_call[keys[i]]
            lat[i], en[i], tw[i] = lat[j], en[j], tw[j]
        self.stats.eval_seconds += time.perf_counter() - t0
        meta = {"meta_version": META_VERSION, "backend": self.backend,
                "mode": mode, "fidelity": self.fidelity, "requests": n,
                "hits": self.stats.hits - pre.hits,
                "misses": self.stats.misses - pre.misses,
                "skips": self.stats.skips - pre.skips,
                "nonfinite": nonfinite,
                "dispatches": self.stats.dispatches - pre.dispatches}
        meta["hit_rate"] = meta["hits"] / max(n, 1)
        return {"latency": lat, "energy": en, "tops_w": tw, "area": area,
                "meta": meta}

    def rescore(self, genomes: np.ndarray, oracle: bool = False,
                mode: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Exact re-scoring through this engine's exact mapper (the
        compile-free search by default, ``exact_mapper="python"`` the
        per-candidate host compile), or the ``ChipSim`` walk with
        ``oracle=True``, whatever this engine's search backend (a scan
        engine's too); bypasses the memo."""
        mode = self._check_mode(mode)
        genomes = np.asarray(genomes, dtype=np.int64).reshape(-1, GENOME_LEN)
        lat, en, tw = self._simulate(self._configs(genomes), genomes, mode,
                                     oracle=oracle, exact=True)
        return {"latency": lat, "energy": en, "tops_w": tw,
                "area": self.areas(genomes),
                "meta": {"meta_version": META_VERSION,
                         "backend": "oracle" if oracle else "batched",
                         "mapper": "python" if oracle else self.exact_mapper,
                         "mode": mode, "fidelity": self.fidelity,
                         "requests": len(genomes), "hits": 0,
                         "misses": len(genomes), "skips": 0,
                         "hit_rate": 0.0}}

    # --------------------------------------------------- device-memo sync
    def export_memo(self, mode: Optional[str] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Bulk view of the store's in-memory tier for one schedule mode:
        ``(canon (N, GENOME_LEN) int64, rows (N, 3, W) float64)`` in LRU
        order -- what ``device_memo.memo_from_store`` preloads.  Only the
        enumerable LRU tier exports (a sqlite back tier is keyed by
        digests); no stats or recency side effects.  Views are cached per
        mode against the tier's mutation stamp; callers must treat them
        as read-only."""
        mode = self._check_mode(mode)
        stamp = self._memo_stamp()
        cached = self._export_cache.get(mode)
        if stamp is not None and cached is not None and cached[0] == stamp:
            return cached[1]
        tag = mode.encode() + b":"
        W = len(self.workloads)
        d = self.store.lru_dict()
        genomes: List[np.ndarray] = []
        rows: List[np.ndarray] = []
        for k, row in (list(d.items()) if d else ()):
            if not k.startswith(tag):
                continue
            genomes.append(np.frombuffer(k[len(tag):], np.int64))
            rows.append(np.stack([np.asarray(a, np.float64) for a in row]))
        if not genomes:
            out = (np.zeros((0, GENOME_LEN), np.int64),
                   np.zeros((0, 3, W), np.float64))
        else:
            out = (np.asarray(genomes, np.int64),
                   np.asarray(rows, np.float64))
        if stamp is not None:
            self._export_cache[mode] = (stamp, out)
        return out

    def _memo_stamp(self) -> Optional[tuple]:
        """Mutation stamp of the store's enumerable LRU tier: changes
        exactly when its membership changes (accepted puts, evictions);
        None when the tier keeps no stats, which disables the cache."""
        front = getattr(self.store, "front", self.store)
        stats = getattr(front, "stats", None)
        if stats is None:
            return None
        return (id(front), stats.puts, stats.evictions)

    def import_memo(self, canon: np.ndarray, rows: np.ndarray,
                    mode: Optional[str] = None) -> int:
        """Offer drained device-memo entries to the host store
        (put-if-absent; a persistent tier makes them durable).  ``canon``
        (N, GENOME_LEN) canonical genomes, ``rows`` (N, 3, W).  Returns
        the number of rows offered."""
        mode = self._check_mode(mode)
        tag = mode.encode() + b":"
        canon = np.asarray(canon, np.int64).reshape(-1, GENOME_LEN)
        rows = np.asarray(rows, np.float64)
        if rows.shape[:1] != (len(canon),) or rows.ndim != 3 \
                or rows.shape[1] != 3:
            raise ValueError(f"rows shape {rows.shape} does not match "
                             f"{len(canon)} genomes x (3, W)")
        for g, r in zip(canon, rows):
            self.store.put(tag + self._key(g),
                           (r[0].copy(), r[1].copy(), r[2].copy()))
        return len(canon)

    def reserve_shapes(self, max_batch: int = 64) -> None:
        """The reference's signature.  The reference pre-registers its
        jit batch buckets here; the port compiles no shapes (a sharded
        engine pads only to a multiple of its device count), so there is
        nothing to reserve and this changes nothing."""

    def warmup(self, buckets: Sequence[int] = tuple(range(16, 68, 4))
               ) -> None:
        """Run one small dispatch of this engine's backend on every
        workload (one genome, bypassing the memo), so that the first
        generation's time excludes first-use costs: the preparation cache,
        the cost model's device tables and the device's own start-up.
        ``buckets`` is the reference's signature; the port has no batch
        shapes to compile."""
        g = np.zeros((1, GENOME_LEN), np.int64)
        self._simulate(self._configs(g), g, self.mode)

    def areas(self, genomes: np.ndarray) -> np.ndarray:
        """Chip areas only -- no simulation, no cache interaction (both
        paths are bitwise identical; pick by batch size)."""
        genomes = np.asarray(genomes, dtype=np.int64).reshape(-1, GENOME_LEN)
        if self.vectorized and len(genomes) >= 16:
            return genome_areas(genomes, self.calib)
        from ..simulator.area import chip_area
        return np.asarray([chip_area(decode(g), self.calib)
                           for g in genomes])
