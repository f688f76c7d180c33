"""Device-side GA generation loop (paper §4.5) over the exact search path.

Port of ``repro/core/dse/ga_device.py``.  The Stage-2 refinement with
the genetics on the device: tournament selection (size
``cfg.tournament``), uniform crossover, Poisson-k gene mutation and
elitism over the whole ``(P, GENOME_LEN)`` population as torch on the
engine's device, and the children's canonical forms (the engine's memo
keys, bit for bit ``engine.canonical_genomes``) in the same step.
Scoring goes through an ``EvalEngine``, by default the exact search
backend, so the Eq. 8 fitness the tournament selects on is computed from
exact metrics; the fitness itself (``fitness_device``) is a float64
kernel on the device.

Two loops:

* ``run_ga_device`` -- one genetics step per generation on the device,
  the population scored through the engine's host memo (the reference's
  ``run_ga`` default);
* ``run_ga_fused`` -- the whole refinement against the device-resident
  memo (``device_memo``): the configs are built on the device
  (``_configs_device``, bit for bit ``genomes_to_configs``), the exact
  search runs on them, and the population, fitness, memo, best-so-far
  and history stay on the device.  Torch has no device-side while loop,
  so the generation loop runs on the host; per generation it reads only
  the all-hit flag (an all-hit generation skips the search, as the
  reference's ``lax.cond`` does) and the stall count.  ``islands > 1``
  splits the population into islands: per-island draws and ring
  migration of the top ``migrate_k`` rows every ``migrate_every``
  generations; with several local devices each holds one block of
  islands (``launch.mesh.island_sharding``), on one card they are
  logical.  With one island it walks exactly ``run_ga_device``'s genome
  stream.

Random draws.  ``jax.random`` (threefry) and torch (Philox) streams
cannot match, so the genetics step takes its draws -- tournament
indices, crossover and swap uniforms, mutation uniforms, Poisson counts,
gene indices and value uniforms -- from an injectable source.
``draws(key)`` builds a source for one refinement, ``key = seed +
int(bracket)``; the default, ``TorchDraws``, draws from CPU
``torch.Generator``s seeded from that key alone (one per island) and
moves the draws to the device, so the card and the CPU walk the same
genome stream and a resumed refinement recomputes it.

The one documented departure from the host loop's numpy genetics, kept
from the reference: the Poisson-k mutation count is truncated at
``MUT_GENES_MAX`` (= 8) genes per child.

Float64 order.  The device does no area arithmetic (``_area_tables``);
Eq. 8's workload mean is a sequential sum times ``1 / W``, fused with the
TOPS/W term into one correctly rounded multiply-add, which is how the
reference's compiled kernel rounds it.  torch has no fused multiply-add,
so ``_fma`` emulates one with float64 operations (exact product and sum
by error-free transformations, the low part rounded to odd), the same
bits on every device.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ...device import F64, resolve_device
from ..arch import MAX_TILE_TYPES, MAX_TILES
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..compiler.batched_mapper import search_population
from ..simulator.batched import CHIP_KEYS, TILE_KEYS
from ..simulator.costs import grid_dims
from ..simulator.orchestrator import CACHE_FRAC
from .api import EngineConfig
from .device_memo import (DeviceMemo, drain_to_store, memo_from_store,
                          memo_init, memo_insert, memo_lookup)
from .encoding import (FIELDS_PER_TILE, GENOME_LEN, IDX_ASPECT, IDX_DRAM,
                       IDX_DRAM_CH, IDX_ICONN, IDX_NOC_BPC, IDX_TOPO,
                       genome_bounds, random_genomes)
from .engine import (_ARRAY_DIM, _ASPECT, _ASYM, _ASYM_CANON, _ASYM_COL,
                     _COUNT, _DATAFLOW, _DB, _DRAM, _DRAM_CH, _ENGINE,
                     _FIELD_COL, _HOPS_TABLE, _MODE_KEYS, _NOC_BPC, _PIPE,
                     _PREC_COL, _PREC_MASK, _PREC_MAX, _SFU, _SFU_COL,
                     _SPARSITY, _SPECIAL_INERT_COLS, _SRAM_KB, _TOPO,
                     EvalEngine)
from .objective import ALPHA, AREA_BRACKETS

__all__ = ["run_ga_device", "run_ga_fused", "FusedRefinement",
           "MUT_GENES_MAX", "canonical_genomes_device", "fitness_device",
           "bracket_bounds", "GeneticDraws", "TorchDraws", "genetics_step"]

# Poisson-k mutation truncation of the device loop (see module docstring)
MUT_GENES_MAX = 8

_I64 = torch.int64


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device) -> Dict[str, torch.Tensor]:
    """The knob-grid lookup tables of ``engine`` on one device."""
    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)
    return {"sfu": f64(_SFU), "asym_canon": torch.as_tensor(
                _ASYM_CANON, dtype=_I64, device=device),
            "array_dim": f64(_ARRAY_DIM), "sram_kb": f64(_SRAM_KB),
            "count": torch.as_tensor(_COUNT, dtype=_I64, device=device),
            "engine": f64(_ENGINE), "sparsity": f64(_SPARSITY),
            "dataflow": f64(_DATAFLOW), "pipe": f64(_PIPE), "db": f64(_DB),
            "asym": f64(_ASYM), "prec_mask": f64(_PREC_MASK),
            "prec_max": torch.as_tensor(_PREC_MAX, dtype=_I64,
                                        device=device),
            "dram": f64(_DRAM), "hops": f64(_HOPS_TABLE), "topo": f64(_TOPO),
            "aspect": f64(_ASPECT), "noc_bpc": f64(_NOC_BPC),
            "dram_ch": f64(_DRAM_CH),
            "bounds": torch.as_tensor(genome_bounds(), dtype=_I64,
                                      device=device)}


# =============================================================================
# device canonicalization (bit for bit engine.canonical_genomes)
# =============================================================================

def _canonical_device(g: torch.Tensor) -> torch.Tensor:
    """Torch mirror of ``engine.canonical_genomes`` on a (P, GENOME_LEN)
    int tensor: same zeroing order, same tables."""
    tb = _tables(g.device)
    g = g.clone()
    n_types = g[:, 0] + 1
    for t in range(MAX_TILE_TYPES):
        base = 1 + t * FIELDS_PER_TILE
        inactive = t >= n_types
        block = g[:, base:base + FIELDS_PER_TILE]
        g[:, base:base + FIELDS_PER_TILE] = torch.where(
            inactive[:, None], torch.zeros_like(block), block)
        sfu_i = (g[:, base + _SFU_COL] % len(_SFU)).long()
        special = (tb["sfu"][sfu_i] > 0) & ~inactive
        for col in _SPECIAL_INERT_COLS:
            g[:, base + col] = torch.where(
                special, torch.zeros_like(g[:, base + col]), g[:, base + col])
        g[:, base + _ASYM_COL] = tb["asym_canon"][
            (g[:, base + _PREC_COL] % 4).long(),
            (g[:, base + _ASYM_COL] % 4).long()].to(g.dtype)
    return g


def canonical_genomes_device(genomes: np.ndarray, device=None) -> np.ndarray:
    """Host-callable wrapper over the device canonicalizer (the card
    unless ``device="cpu"`` is asked for)."""
    g = np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN)
    dev = resolve_device(device)
    return _canonical_device(torch.as_tensor(g, device=dev)).cpu().numpy()


# =============================================================================
# Eq. 8 fitness kernel
# =============================================================================

def bracket_bounds(bracket: float):
    """(lo, hi] area band equivalent to ``area_bracket(a) == bracket``
    (the last bracket is open above: oversized chips land in it)."""
    if bracket not in AREA_BRACKETS:
        return math.nan, math.nan      # no design can match (host parity)
    bi = AREA_BRACKETS.index(bracket)
    lo = AREA_BRACKETS[bi - 1] if bi > 0 else -math.inf
    hi = bracket if bi < len(AREA_BRACKETS) - 1 else math.inf
    return lo, hi


_SPLIT = 134217729.0            # 2^27 + 1, Veltkamp's splitter for float64


def _two_sum(a, b):
    """s + e == a + b exactly (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """p + e == a * b exactly (Dekker's product over Veltkamp splits)."""
    p = a * b
    t = _SPLIT * a
    ah = t - (t - a)
    al = a - ah
    t = _SPLIT * b
    bh = t - (t - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, from float64 operations alone
    (Boldo and Melquiond's emulated FMA: the exact product's and sum's
    low parts added with rounding to odd).  Finite inputs only: other
    elements take ``a * b + c`` as two roundings (their fitness is
    masked anyway)."""
    b = torch.full_like(a, b)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(v.dtype)
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    fin = torch.isfinite(a) & torch.isfinite(c)
    return torch.where(fin, th + v, a * b + c)


def _fitness_kernel(en, tw, lat, area, e_homo, lo: float, hi: float,
                    alpha: float) -> torch.Tensor:
    """Eq. 8 on the (P, W) metric tensors: mean iso-area savings vs the
    bracket's homogeneous baseline + alpha * TOPS/W normalized over
    comparable (in-bracket, valid) designs only; invalid/out-of-bracket
    rows score -inf (``ga._fitness`` semantics)."""
    W = en.shape[1]
    sav = (e_homo[None, :] - en) / torch.clamp(e_homo[None, :], min=1e-30)
    acc = sav[:, 0]
    for j in range(1, W):
        acc = acc + sav[:, j]
    peak_tw = tw.max(dim=1).values
    bad = ~torch.isfinite(lat).all(dim=1) | ~(lat > 0).all(dim=1)
    bad = bad | ~((area > lo) & (area <= hi))
    ok = ~bad
    max_tw = torch.where(ok, peak_tw, -torch.inf).max()
    max_tw = torch.where(ok.any(), max_tw, 1.0)
    fit = _fma(acc, 1.0 / W, alpha * peak_tw / torch.clamp(max_tw,
                                                            min=1e-30))
    return torch.where(bad, -torch.inf, fit)


def fitness_device(metrics: Dict[str, np.ndarray], e_homo: np.ndarray,
                   bracket: float, alpha: float = ALPHA,
                   device=None) -> np.ndarray:
    """Eq. 8 fitness of an engine ``evaluate()``/``rescore()`` result
    through the device kernel on ``device`` (the card unless ``"cpu"``
    is asked for) -- the scoring the device GA loops select on."""
    dev = resolve_device(device)
    lo, hi = bracket_bounds(bracket)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    return _fitness_kernel(t(metrics["energy"]), t(metrics["tops_w"]),
                           t(metrics["latency"]), t(metrics["area"]),
                           t(e_homo), lo, hi, float(alpha)).cpu().numpy()


# =============================================================================
# the genetics step and its draws
# =============================================================================

class GeneticDraws(NamedTuple):
    """One generation's random draws for one island of ``population``
    genomes, ``n_children`` of them bred in ``n_pairs`` pairs."""

    tournament: torch.Tensor   # (n_children, K) int64 in [0, population)
    crossover: torch.Tensor    # (n_pairs,) float64 uniforms
    swap: torch.Tensor         # (n_pairs, GENOME_LEN) float64 uniforms
    mutate: torch.Tensor       # (n_children,) float64 uniforms
    poisson: torch.Tensor      # (n_children,) int64, Poisson(2) counts
    genes: torch.Tensor        # (n_children, MUT_GENES_MAX) int64 gene indices
    values: torch.Tensor       # (n_children, MUT_GENES_MAX) float64 uniforms


def _brood(population: int, n_elite: int):
    """(n_pairs, n_children) of one island's generation."""
    n_pairs = max(-(-(population - n_elite) // 2), 0)
    return n_pairs, n_pairs * 2


class TorchDraws:
    """The default draw source of one refinement: island ``i`` draws from
    a CPU ``torch.Generator`` (``key = seed + int(bracket)``; island 0
    seeded with the key itself, island ``i > 0`` with
    ``SeedSequence([key, i])``'s first word), in the order of
    ``GeneticDraws``' fields, and the draws move to the device.  Island
    0's stream depends on the key alone, so one island walks the same
    stream as ``run_ga_device``."""

    def __init__(self, key: int):
        self.key = int(key)
        self._gens: List[torch.Generator] = []

    def __call__(self, islands: int, population: int, tournament: int,
                 n_elite: int, device) -> List[GeneticDraws]:
        while len(self._gens) < islands:
            i = len(self._gens)
            g = torch.Generator()
            g.manual_seed(self.key if i == 0 else int(
                np.random.SeedSequence([self.key, i]).generate_state(1)[0]))
            self._gens.append(g)
        n_pairs, n_children = _brood(population, n_elite)
        out = []
        for g in self._gens[:islands]:
            d = GeneticDraws(
                tournament=torch.randint(0, population,
                                         (n_children, tournament),
                                         generator=g),
                crossover=torch.rand((n_pairs,), dtype=F64, generator=g),
                swap=torch.rand((n_pairs, GENOME_LEN), dtype=F64,
                                generator=g),
                mutate=torch.rand((n_children,), dtype=F64, generator=g),
                poisson=torch.poisson(torch.full((n_children,), 2.0,
                                                 dtype=F64),
                                      generator=g).to(_I64),
                genes=torch.randint(0, GENOME_LEN,
                                    (n_children, MUT_GENES_MAX),
                                    generator=g),
                values=torch.rand((n_children, MUT_GENES_MAX), dtype=F64,
                                  generator=g))
            out.append(GeneticDraws(*(x.to(device) for x in d)))
        return out


def genetics_step(pop: torch.Tensor, fit: torch.Tensor, d: GeneticDraws,
                  n_elite: int, crossover_rate: float,
                  mutation_rate: float):
    """One GA generation on the device: ``(pop, fit, draws) -> (children,
    canonical(children))``, the reference's ``_genetics_kernel`` given
    the same draws.  Elites pass through (stable fitness order), each
    non-elite pair comes from two size-K tournaments (the first maximum
    wins), uniform crossover swaps genes at ``crossover_rate``, and
    mutated children redraw Poisson-k genes (k in [1, MUT_GENES_MAX])
    uniformly under ``genome_bounds``, applied in order so that later
    draws overwrite earlier ones."""
    population = pop.shape[0]
    pop = pop.to(torch.int32)
    fit = fit.to(F64)
    n_pairs, n_children = _brood(population, n_elite)
    bounds = _tables(pop.device)["bounds"]
    # ---- elitism -----------------------------------------------------------
    elites = pop[torch.argsort(-fit, stable=True)[:n_elite]]
    # ---- tournament selection ----------------------------------------------
    idx = d.tournament
    winners = idx.gather(1, fit[idx].argmax(dim=1, keepdim=True))[:, 0]
    pa = pop[winners[0::2]]
    pb = pop[winners[1::2]]
    # ---- uniform crossover -------------------------------------------------
    do_cx = d.crossover < crossover_rate
    swap = do_cx[:, None] & (d.swap < 0.5)
    ca = torch.where(swap, pb, pa)
    cb = torch.where(swap, pa, pb)
    children = torch.stack([ca, cb], dim=1).reshape(n_children, GENOME_LEN)
    # ---- Poisson-k gene mutation -------------------------------------------
    do_mut = d.mutate < mutation_rate
    k_genes = torch.clamp(d.poisson, 1, MUT_GENES_MAX)
    vals = torch.floor(d.values * bounds[d.genes].to(F64)).to(torch.int32)
    for j in range(MUT_GENES_MAX):
        col = d.genes[:, j:j + 1]
        cur = children.gather(1, col)
        upd = (do_mut & (j < k_genes))[:, None]
        children = children.scatter(1, col, torch.where(
            upd, vals[:, j:j + 1], cur))
    new_pop = torch.cat([elites, children])[:population]
    return new_pop, _canonical_device(new_pop)


def _seed_population(sweep, bracket: float, cfg, seed: int) -> np.ndarray:
    """The reference's seed population: the top ``seed_top_k`` of the
    sweep in the bracket, topped up with random genomes from
    ``default_rng(seed + int(bracket))``; int32."""
    rng = np.random.default_rng(seed + int(bracket))
    fit_sweep = sweep.fitness(cfg.alpha)
    in_b = np.nonzero((sweep.bracket == bracket) & np.isfinite(fit_sweep))[0]
    order = in_b[np.argsort(-fit_sweep[in_b])][:cfg.seed_top_k]
    pop = sweep.genomes[order].copy()[:cfg.population]
    while len(pop) < cfg.population:
        fill = random_genomes(rng, cfg.population - len(pop),
                              family="hetero_bls" if rng.random() < 0.5
                              else None)
        pop = np.concatenate([pop, fill])[:cfg.population]
    return np.ascontiguousarray(pop, np.int32)


# =============================================================================
# the generation loop
# =============================================================================

def run_ga_device(sweep, bracket: float, cfg=None, seed: int = 0,
                  calib: CalibrationTable = DEFAULT_CALIB,
                  verbose: bool = False, engine: Optional[EvalEngine] = None,
                  prefilter: bool = True,
                  on_generation: Optional[Callable] = None, device=None,
                  draws: Optional[Callable] = None):
    """GA refinement at one area budget with the genetics on the device.

    Same contract as ``ga.run_ga`` (which delegates here by default):
    seeded from the sweep's top-k at the bracket, returns a ``GAResult``
    or None when the bracket has no homogeneous baseline.  Without an
    explicit ``engine``, scoring runs ``EvalEngine(backend="exact",
    nonfinite="skip")`` on ``device`` (the card unless ``"cpu"`` is asked
    for); ``engine`` may be any object with the engine's scoring surface
    (``check_workloads``, ``evaluate``), and the genetics run on its
    ``device`` when it has one, else on ``device``.  ``on_generation(gen,
    pop, fit, metrics)`` is called after every scored population (gen 0
    the seed population).  ``draws`` builds the random-draw source from
    ``seed + int(bracket)`` (default ``TorchDraws``)."""
    from .ga import GAConfig, GAResult
    cfg = cfg or GAConfig()
    engine = (engine.check_workloads(sweep.workloads, calib)
              if engine is not None
              else EvalEngine(sweep.workloads, calib,
                              config=EngineConfig(backend="exact",
                                                  nonfinite="skip"),
                              device=device))
    dev = getattr(engine, "device", None)
    dev = resolve_device(device) if dev is None else dev
    base = sweep.homo_baseline()
    if bracket not in base:
        return None
    e_homo = np.asarray(base[bracket], np.float64)
    lo, hi = bracket_bounds(bracket)
    pop = _seed_population(sweep, bracket, cfg, seed)

    def keep(areas: np.ndarray) -> np.ndarray:
        return (areas > lo) & (areas <= hi)

    def evaluate(genomes: np.ndarray, canonical=None):
        m = engine.evaluate(genomes, keep=keep if prefilter else None,
                            canonical=canonical)
        m.pop("meta", None)  # best_metrics holds per-genome arrays only
        return fitness_device(m, e_homo, bracket, cfg.alpha, dev), m

    fit, metrics = evaluate(pop)
    if on_generation is not None:
        on_generation(0, pop, fit, metrics)
    best_i = int(np.argmax(fit))
    best = (fit[best_i], pop[best_i].copy(),
            {k: v[best_i] for k, v in metrics.items()})
    history = [float(best[0])]
    evaluated = len(pop)
    stall = 0

    n_elite = max(int(cfg.elitism * cfg.population), 1)
    source = (draws or TorchDraws)(seed + int(bracket))
    pop_dev = torch.as_tensor(pop, dtype=torch.int32, device=dev)
    for gen in range(cfg.generations):
        d = source(1, cfg.population, cfg.tournament, n_elite, dev)[0]
        pop_dev, canon_dev = genetics_step(
            pop_dev, torch.as_tensor(fit, dtype=F64, device=dev), d,
            n_elite, cfg.crossover_rate, cfg.mutation_rate)
        # one host transfer per generation: the children and their
        # canonical forms (the engine's memo keys)
        pop = pop_dev.cpu().numpy()
        canon = canon_dev.cpu().numpy()
        fit, metrics = evaluate(pop, canonical=canon)
        if on_generation is not None:
            on_generation(gen + 1, pop, fit, metrics)
        evaluated += len(pop)
        gi = int(np.argmax(fit))
        if fit[gi] > best[0]:
            best = (fit[gi], pop[gi].copy(),
                    {k: v[gi] for k, v in metrics.items()})
            stall = 0
        else:
            stall += 1
        history.append(float(best[0]))
        if verbose:
            print(f"[ga-dev {bracket:.0f}mm2] gen {gen}: best={best[0]:+.4f} "
                  f"(stall {stall})")
        if stall >= cfg.early_stop:
            break

    sav = (e_homo - best[2]["energy"]) / np.maximum(e_homo, 1e-30)
    return GAResult(bracket=bracket, best_genome=best[1],
                    best_fitness=float(best[0]), best_savings_per_wl=sav,
                    best_metrics=best[2], history=history, evaluated=evaluated)


# =============================================================================
# device genome -> config stacking (bit for bit genomes_to_configs)
# =============================================================================

@functools.lru_cache(maxsize=4)
def _area_tables_host(calib: CalibrationTable):
    """Host-precomputed Eq. 7 area tables over the full (discrete) knob
    grid: per-type tile area, tile area x count, and NoC area by tile
    count, each entry computed by the numpy expressions
    ``engine._per_type_values`` runs (the same rounding by
    construction), so the device does no area arithmetic and nothing it
    runs can contract a multiply-add.  Grid: prec(4) x engine(4) x
    sparsity(3) x rows(5) x cols(5) x sfu(len _SFU) x sram(7)."""
    S = len(_SFU)
    p_, e_, s_, r_, c_, f_, k_ = np.meshgrid(
        np.arange(4), np.arange(4), np.arange(3), np.arange(5),
        np.arange(5), np.arange(S), np.arange(7), indexing="ij")
    sfu = _SFU[f_]
    special = sfu > 0
    rows = np.where(special, 0.0, _ARRAY_DIM[r_])
    cols = np.where(special, 0.0, _ARRAY_DIM[c_])
    num_macs = rows * cols
    big = num_macs >= 1024.0
    dsp_count = np.where(special, 1.0, np.where(big, 2.0, 1.0))
    dsp_simd = np.full_like(dsp_count, 64.0)
    max_prec = _PREC_MAX[p_]
    eng_idx = np.asarray(_ENGINE[e_], np.int64)
    sp_idx = np.asarray(_SPARSITY[s_], np.int64)
    sram_kb = _SRAM_KB[k_]

    a_mac_mm2 = np.asarray(calib.a_mac_mm2, np.float64)
    eng_a = np.asarray(calib.engine_a_mult, np.float64)
    sp_a = np.asarray(calib.sparsity_a_mult, np.float64)
    a_mac_unit = a_mac_mm2[max_prec] * eng_a[eng_idx]
    a_mac = num_macs * a_mac_unit * sp_a[sp_idx]
    a_sram = sram_kb * calib.a_sram_mm2_per_kb
    a_dsp = dsp_count * dsp_simd * calib.a_dsp_mm2_per_lane
    sfu_i = np.asarray(sfu, np.int64)
    a_spec = np.where(sfu_i & 1, calib.a_fft_mm2, 0.0)
    a_spec = a_spec + np.where(sfu_i & 2, calib.a_lif_mm2, 0.0)
    a_spec = a_spec + np.where(sfu_i & 4, calib.a_poly_mm2, 0.0)
    a_ports = calib.a_ports_base_mm2 \
        + (rows + cols) * calib.a_ports_per_lane_mm2
    area = a_mac + a_sram + a_dsp + a_spec + a_ports

    count_terms = area[..., None] * _COUNT        # x count, pre-rounded
    max_tiles = MAX_TILE_TYPES * int(np.max(_COUNT))
    # NoC term by (tile count, noc_bpc knob, torus knob): the host stack
    # computes ``(num_tiles * a_noc) * noc_scale`` left-associatively
    n_tiles = np.arange(max_tiles + 1, dtype=np.float64)
    noc_scale = (0.5 + 0.5 * _NOC_BPC / 64.0)[:, None] \
        * np.where(_TOPO[None, :] > 0, 1.25, 1.0)
    noc = (n_tiles * calib.a_noc_mm2_per_tile)[:, None, None] \
        * noc_scale[None, :, :]
    # per-channel DRAM PHY term by the dram_channels knob
    dram_phy = (_DRAM_CH - 1.0) * calib.a_dram_phy_mm2
    return (np.ascontiguousarray(area.reshape(-1)),
            np.ascontiguousarray(count_terms.reshape(-1, len(_COUNT))),
            np.ascontiguousarray(noc),
            np.ascontiguousarray(dram_phy))


@functools.lru_cache(maxsize=8)
def _area_tables(calib: CalibrationTable, device: torch.device):
    """``_area_tables_host`` on one device."""
    return tuple(torch.as_tensor(t, device=device)
                 for t in _area_tables_host(calib))


def _knob_index(g: torch.Tensor):
    """Per tile type: the flat index into the area grid, the count knob
    and the active mask, and the tile count."""
    T = MAX_TILE_TYPES

    def tcol(t, f):
        return g[:, 1 + t * FIELDS_PER_TILE + _FIELD_COL[f]]

    def stack(f, m):
        return torch.stack([tcol(t, f) % m for t in range(T)], dim=1)

    sfu_idx = stack("sfu", len(_SFU))
    prec_idx = stack("prec", 4)
    flat = (((prec_idx * 4 + stack("engine", 4)) * 3 + stack("sparsity", 3))
            * 5 + stack("rows", 5)) * 5 + stack("cols", 5)
    flat = (flat * len(_SFU) + sfu_idx) * 7 + stack("sram", 7)
    counts = _tables(g.device)["count"][stack("count", 8)]
    active = torch.arange(T, device=g.device)[None, :] < (g[:, 0] + 1)[:, None]
    counts = torch.where(active, counts, 0)
    return flat, stack("count", len(_COUNT)), active, counts


def _chip_sum(g, calib, flat, cnt_k, active, num_tiles):
    """chip_area: per-type terms summed in type order, then NoC, then the
    DRAM PHYs, every term a gather from the pre-rounded tables."""
    _, count_tab, noc_tab, dram_tab = _area_tables(calib, g.device)
    terms = torch.where(active, count_tab[flat, cnt_k], 0.0)
    area = torch.zeros(g.shape[0], dtype=F64, device=g.device)
    for t in range(MAX_TILE_TYPES):
        area = area + terms[:, t]
    area = area + noc_tab[num_tiles, g[:, IDX_NOC_BPC] % 4, g[:, IDX_TOPO] % 2]
    return area + dram_tab[g[:, IDX_DRAM_CH] % 4]


def _chip_area_device(g: torch.Tensor,
                      calib: CalibrationTable = DEFAULT_CALIB
                      ) -> torch.Tensor:
    """(P,) chip areas only -- what the Eq. 8 band consumes -- through the
    same gathers ``_configs_device`` runs, so an all-hit generation pays
    a few gathers instead of full config building."""
    g = g.to(_I64)
    flat, cnt_k, active, counts = _knob_index(g)
    return _chip_sum(g, calib, flat, cnt_k, active, counts.sum(dim=1))


def _configs_device(g: torch.Tensor,
                    calib: CalibrationTable = DEFAULT_CALIB):
    """Torch mirror of ``engine.genomes_to_configs`` on a (P, GENOME_LEN)
    int tensor: same knob tables, same modulo wrapping, same sequential
    chip-area accumulation.  Returns ``(tile, chip, chip_area)``: tile
    fields (P, MAX_TILES) and chip fields (P,) float64, exactly
    ``TILE_KEYS``/``CHIP_KEYS``, bit for bit the host stack."""
    g = g.to(_I64)
    B = g.shape[0]
    T = MAX_TILE_TYPES
    dev = g.device
    tb = _tables(dev)

    def tcol(t, f):
        return g[:, 1 + t * FIELDS_PER_TILE + _FIELD_COL[f]]

    def look(table, f, m):
        return torch.stack([tb[table][tcol(t, f) % m] for t in range(T)],
                           dim=1)

    def full(x):
        return torch.full((B, T), x, dtype=F64, device=dev)

    v: Dict[str, torch.Tensor] = {}
    sfu = look("sfu", "sfu", len(_SFU))
    special = sfu > 0
    rows = torch.where(special, 0.0, look("array_dim", "rows", 5))
    cols = torch.where(special, 0.0, look("array_dim", "cols", 5))
    big = rows * cols >= 1024.0
    v["rows"], v["cols"] = rows, cols
    v["num_macs"] = rows * cols
    clock_mhz = torch.where(special, 800.0,
                            torch.where(big, 1200.0, 500.0)).to(F64)
    v["dsp_count"] = torch.where(special, 1.0,
                                 torch.where(big, 2.0, 1.0)).to(F64)
    v["sfu_mask"] = sfu
    v["sfu_parallel"] = full(16.0)
    v["sram_bpc"] = full(8 * 16.0)              # default sram_banks=8
    v["engine"] = look("engine", "engine", 4)
    prec_idx = torch.stack([tcol(t, "prec") % 4 for t in range(T)], dim=1)
    v["prec_mask"] = tb["prec_mask"][prec_idx]
    v["max_prec"] = tb["prec_max"][prec_idx].to(F64)
    v["sparsity"] = look("sparsity", "sparsity", 3)
    v["dataflow"] = look("dataflow", "dataflow", 3)
    v["sram_kb"] = look("sram_kb", "sram", 7)
    v["double_buffer"] = look("db", "db", 2)
    v["pipeline_depth"] = look("pipe", "pipe", 4)
    v["asym_mac"] = look("asym", "asym", 4)
    v["cache_cap"] = v["sram_kb"] * 1024.0 * CACHE_FRAC
    v["dsp_lanes"] = v["dsp_count"] * full(64.0)
    v["clock_hz"] = clock_mhz * 1e6

    # tile_area (Eq. 7) as a pure gather from the host-precomputed grid
    flat, cnt_k, active, counts = _knob_index(g)
    v["area_mm2"] = _area_tables(calib, dev)[0][flat]

    starts = torch.cat([torch.zeros((B, 1), dtype=counts.dtype, device=dev),
                        torch.cumsum(counts, dim=1)[:, :-1]], dim=1)
    ends = starts + counts
    slots = torch.arange(MAX_TILES, device=dev)
    member = (slots[None, None, :] >= starts[:, :, None]) \
        & (slots[None, None, :] < ends[:, :, None])

    tile = {}
    for f in ("num_macs", "rows", "cols", "engine", "prec_mask", "asym_mac",
              "sparsity", "dataflow", "sram_kb", "dsp_lanes", "dsp_count",
              "sfu_mask", "sfu_parallel", "double_buffer", "pipeline_depth",
              "clock_hz", "cache_cap", "sram_bpc", "area_mm2", "max_prec"):
        # exactly one membership per occupied slot: the masked sum is the
        # per-type value itself, bit for bit
        tile[f] = torch.where(member, v[f][:, :, None], 0.0).sum(dim=1)
    tile["exists"] = member.any(dim=1).to(F64)

    num_tiles = counts.sum(dim=1)
    gw, gh = grid_dims(num_tiles.to(F64),
                       tb["aspect"][g[:, IDX_ASPECT] % 3])
    chip = {
        "dram_gbps": tb["dram"][g[:, IDX_DRAM] % 6],
        "hops": tb["hops"][g[:, IDX_ICONN] % 4, num_tiles],
        "noc_bpc": tb["noc_bpc"][g[:, IDX_NOC_BPC] % 4],
        "noc_base_cycles": torch.full((B,), 8.0, dtype=F64, device=dev),
        "ref_clock_hz": torch.full((B,), 1000 * 1e6, dtype=F64, device=dev),
        "torus": tb["topo"][g[:, IDX_TOPO] % 2],
        "dram_channels": tb["dram_ch"][g[:, IDX_DRAM_CH] % 4],
        "grid_w": gw,
        "grid_h": gh,
    }
    assert set(tile) == set(TILE_KEYS) and set(chip) == set(CHIP_KEYS)
    area = _chip_sum(g, calib, flat, cnt_k, active, num_tiles)
    return tile, chip, area


# =============================================================================
# the fused refinement: the whole GA run against the device memo
# =============================================================================

@dataclasses.dataclass
class FusedRefinement:
    """``run_ga_fused`` output: the ``GAResult`` plus what the pipeline's
    cross-seed Pareto merge and seed-boundary store sync consume -- the
    device memo state and the final scored population (which always
    contains the best-ever genome: elitism carries it forward)."""

    result: "GAResult"               # noqa: F821 -- ga.GAResult
    memo: DeviceMemo
    population: np.ndarray           # (P, GENOME_LEN) final genomes
    pop_metrics: Dict[str, np.ndarray]   # latency/energy/tops_w (P, W), area (P,)
    generations_run: int
    searches: int = 0                # generations that ran the search
    memo_hits: int = 0               # rows served by the device memo


class _Scorer:
    """The fused loop's scoring of one population against the device
    memo: areas by gather, a memo probe, the exact search on the misses'
    generation unless every row hits (one host read: the all-hit flag),
    the memo insert and Eq. 8."""

    def __init__(self, engine: EvalEngine, calib, e_homo, lo, hi, alpha):
        self.engine, self.calib = engine, calib
        self.keys = _MODE_KEYS[engine.mode]
        self.ws = [engine._prepared(w) for w in engine.workloads]
        self.e_homo = torch.as_tensor(e_homo, dtype=F64, device=engine.device)
        self.lo, self.hi, self.alpha = lo, hi, alpha
        self.searches, self.hits = 0, 0

    def _search(self, pop):
        """The exact search of ``pop`` on the engine's device, or, for a
        sharded engine, one block per device (``EvalEngine._blocks``: the
        rows padded with row 0), joined in order on the engine's
        device."""
        eng = self.engine
        n = len(pop)
        pad, blocks = eng._blocks(n)
        if len(blocks) == 1:
            return self._search_on(pop, eng.device)
        pop = torch.cat([pop, pop[:1].expand(pad - n, -1)])
        parts = [self._search_on(pop[rows].to(d), d) for d, rows in blocks]
        return tuple(torch.cat([p[k].to(eng.device) for p in parts])[:n]
                     for k in range(3))

    def _search_on(self, pop, device):
        lkey, ekey, akey = self.keys
        tile, chip, _ = _configs_device(pop, self.calib)
        chip = {k: x.reshape(-1, 1) for k, x in chip.items()}
        eng = self.engine
        outs = search_population(self.ws, None, self.calib, mode=eng.mode,
                                 out_keys=self.keys, fidelity=eng.fidelity,
                                 device=device, placed=(tile, chip),
                                 as_tensors=True)
        l = torch.stack([o[lkey] for o in outs], dim=1)       # (P, W)
        e = torch.stack([o[ekey] for o in outs], dim=1)
        a = torch.stack([o[akey] for o in outs], dim=1)
        ok = torch.stack([o["ok"] for o in outs], dim=1)
        power = e * 1e-12 / torch.clamp(l, min=1e-30)
        t = a / torch.clamp(power, min=1e-30)
        # unmappable rows: inf latency/energy, zero TOPS/W; a NaN cell is
        # masked the same way so the memo never caches a non-finite row
        okk = ok & ~(torch.isnan(l) | torch.isnan(e) | torch.isnan(t)
                     | torch.isinf(t))
        return (torch.where(okk, l, torch.inf), torch.where(okk, e, torch.inf),
                torch.where(okk, t, 0.0))

    def __call__(self, pop, canon, memo):
        area = _chip_area_device(pop, self.calib)
        hit, mv = memo_lookup(memo, canon)
        self.hits = self.hits + hit.sum()
        if bool(hit.all()):
            # warm replay: every child is memoized, the search is skipped
            lat, en, tw = mv[:, 0], mv[:, 1], mv[:, 2]
        else:
            self.searches += 1
            lat, en, tw = self._search(pop)
            h = hit[:, None]
            lat = torch.where(h, mv[:, 0], lat)
            en = torch.where(h, mv[:, 1], en)
            tw = torch.where(h, mv[:, 2], tw)
            memo = memo_insert(memo, canon, torch.stack([lat, en, tw], dim=1),
                               update=~hit)
        fit = _fitness_kernel(en, tw, lat, area, self.e_homo, self.lo,
                              self.hi, self.alpha)
        return fit, lat, en, tw, area, memo


def _migrate(pops, fits, per_block: int, k: int):
    """Ring migration over the island blocks (one block of ``per_block``
    islands per device): each island's top ``k`` rows (and their fitness)
    replace the next island's worst ``k``; the first island of a block
    takes the previous block's last island's migrants, moved across from
    that block's device."""
    parts = []
    for pop, fit in zip(pops, fits):
        P, L = pop.shape
        Pi = P // per_block
        popI = pop.reshape(per_block, Pi, L).clone()
        fitI = fit.reshape(per_block, Pi).clone()
        order = torch.argsort(-fitI, dim=1, stable=True)  # best first
        top, worst = order[:, :k], order[:, Pi - k:]
        parts.append((popI, fitI, worst,
                      popI.gather(1, top[:, :, None].expand(-1, -1, L)),
                      fitI.gather(1, top)))
    out_p, out_f = [], []
    for b, (popI, fitI, worst, mig_g, mig_f) in enumerate(parts):
        prev_g, prev_f = parts[b - 1][3], parts[b - 1][4]  # ring: i <- i-1
        in_g = torch.cat([prev_g[-1:].to(popI.device), mig_g[:-1]])
        in_f = torch.cat([prev_f[-1:].to(fitI.device), mig_f[:-1]])
        L = popI.shape[-1]
        popI.scatter_(1, worst[:, :, None].expand(-1, -1, L), in_g)
        fitI.scatter_(1, worst, in_f)
        out_p.append(popI.reshape(-1, L))
        out_f.append(fitI.reshape(-1))
    return out_p, out_f


def run_ga_fused(sweep, bracket: float, cfg=None, seed: int = 0,
                 calib: CalibrationTable = DEFAULT_CALIB,
                 verbose: bool = False,
                 engine: Optional[EvalEngine] = None,
                 islands: Optional[int] = None, migrate_every: int = 5,
                 migrate_k: int = 2, memo: Optional[DeviceMemo] = None,
                 memo_capacity: int = 1 << 15,
                 store_sync: bool = True, device=None,
                 draws: Optional[Callable] = None
                 ) -> Optional[FusedRefinement]:
    """GA refinement at one area budget with the whole run on the device,
    scored against the device-resident memo (``device_memo``) instead of
    the engine's host memo.

    Same seeding and contract as ``run_ga_device`` (None when the
    bracket has no homogeneous baseline); requires a local
    ``EvalEngine(backend="exact")`` -- without one it builds
    ``EngineConfig(backend="exact", nonfinite="skip")`` on ``device``.
    ``islands=None`` is ``launch.mesh.default_islands``: one island per
    local device when the population splits evenly, so one island on one
    card, which walks the genome stream of ``run_ga_device``.  With more
    than one device and islands that divide over them
    (``launch.mesh.island_sharding``), each device holds one contiguous
    block of islands and runs their genetics, and the ring migration
    moves rows between devices; a sharded engine splits the search of the
    misses over its devices.  The result is bit for bit the one-device
    run's.  ``store_sync=True`` treats this call as one seed
    boundary: the memo preloads from the engine store's LRU tier and
    drains back after the run (the pipeline passes ``memo=`` and manages
    the boundaries itself).  The engine's stats and store see nothing
    per generation; the result counts the searches and the memo hits."""
    from .ga import GAConfig, GAResult
    cfg = cfg or GAConfig()
    if engine is None:
        engine = EvalEngine(sweep.workloads, calib,
                            config=EngineConfig(backend="exact",
                                                nonfinite="skip"),
                            device=device)
    elif not isinstance(engine, EvalEngine):
        raise ValueError("run_ga_fused needs a local EvalEngine -- the "
                         "fused loop stages configs and the search itself, "
                         "which a remote client cannot serve")
    else:
        engine.check_workloads(sweep.workloads, calib)
    if engine.backend != "exact":
        raise ValueError("run_ga_fused requires backend='exact' (the fused "
                         f"search); got {engine.backend!r}")
    dev = engine.device
    base = sweep.homo_baseline()
    if bracket not in base:
        return None
    e_homo = np.asarray(base[bracket], np.float64)
    lo, hi = bracket_bounds(bracket)
    W = len(engine.workloads)
    pop0 = _seed_population(sweep, bracket, cfg, seed)

    P = cfg.population
    if islands is None:
        from ...launch.mesh import default_islands
        islands = default_islands(P, dev)
    islands = max(int(islands), 1)
    if P % islands:
        raise ValueError(f"population {P} not divisible into "
                         f"{islands} islands")
    Pi = P // islands
    n_elite = max(int(cfg.elitism * Pi), 1)
    if n_elite >= Pi:
        raise ValueError(f"per-island population {Pi} leaves no room for "
                         f"{n_elite} elites -- fewer islands or more genomes")
    mk = max(min(int(migrate_k), Pi // 2), 1) if islands > 1 else 0

    if memo is None:
        memo = memo_from_store(engine, memo_capacity) if store_sync \
            else memo_init(memo_capacity, W, dev)
    elif memo.vals.shape[-1] != W:
        raise ValueError(f"memo carries {memo.vals.shape[-1]}-workload "
                         f"rows; engine scores {W}")

    from ...launch.mesh import island_sharding
    homes = (island_sharding(islands, dev) if islands > 1 else None) \
        or [dev]
    per_block, Pb = islands // len(homes), P // len(homes)

    def blocks(t):
        return [t[b * Pb:(b + 1) * Pb].to(d) for b, d in enumerate(homes)]

    def joined(ts):
        return torch.cat([t.to(dev) for t in ts])

    score = _Scorer(engine, calib, e_homo, lo, hi, float(cfg.alpha))
    source = (draws or TorchDraws)(seed + int(bracket))
    pop = torch.as_tensor(pop0, dtype=torch.int32, device=dev)
    fit, lat, en, tw, area, memo = score(pop, _canonical_device(pop), memo)
    pops, fits = blocks(pop), blocks(fit)
    gi = fit.argmax()
    best = [fit[gi], pop[gi], lat[gi], en[gi], tw[gi], area[gi]]
    hist = torch.full((cfg.generations + 1,), -torch.inf, dtype=F64,
                      device=dev)
    hist[0] = fit[gi]
    stall = torch.zeros((), dtype=_I64, device=dev)
    gen, stall_h = 0, 0
    while gen < cfg.generations and stall_h < cfg.early_stop:
        if islands > 1 and gen > 0 and gen % migrate_every == 0:
            pops, fits = _migrate(pops, fits, per_block, mk)
        ds = source(islands, Pi, cfg.tournament, n_elite, dev)
        parts = []
        for b, home in enumerate(homes):
            for j in range(per_block):
                d = GeneticDraws(*(x.to(home)
                                   for x in ds[b * per_block + j]))
                parts.append(genetics_step(
                    pops[b][j * Pi:(j + 1) * Pi],
                    fits[b][j * Pi:(j + 1) * Pi], d, n_elite,
                    cfg.crossover_rate, cfg.mutation_rate))
        pops = [torch.cat([p[0] for p in parts[b * per_block:
                                                (b + 1) * per_block]])
                for b in range(len(homes))]
        pop = joined(pops)
        canon = joined([p[1] for p in parts])
        fit, lat, en, tw, area, memo = score(pop, canon, memo)
        fits = blocks(fit)
        gi = fit.argmax()
        imp = fit[gi] > best[0]
        best = [torch.where(imp, new, old) for new, old in
                zip((fit[gi], pop[gi], lat[gi], en[gi], tw[gi], area[gi]),
                    best)]
        stall = torch.where(imp, 0, stall + 1)
        hist[gen + 1] = best[0]
        gen += 1
        stall_h = int(stall)            # the loop's one read of the stall

    n_gens = gen
    history = [float(x) for x in hist[:n_gens + 1].cpu().numpy()]
    best_metrics = {"latency": best[2].cpu().numpy(),
                    "energy": best[3].cpu().numpy(),
                    "tops_w": best[4].cpu().numpy(),
                    "area": np.float64(best[5].item())}
    sav = (e_homo - best_metrics["energy"]) / np.maximum(e_homo, 1e-30)
    result = GAResult(
        bracket=bracket, best_genome=best[1].cpu().numpy(),
        best_fitness=float(best[0].item()), best_savings_per_wl=sav,
        best_metrics=best_metrics, history=history,
        evaluated=P * (n_gens + 1))
    if store_sync:
        drain_to_store(memo, engine)
    if verbose:
        print(f"[ga-fused {bracket:.0f}mm2] {n_gens} gens x {P} genomes "
              f"({islands} island(s)): best={result.best_fitness:+.4f}")
    return FusedRefinement(
        result=result, memo=memo, population=pop.cpu().numpy(),
        pop_metrics={"latency": lat.cpu().numpy(),
                     "energy": en.cpu().numpy(),
                     "tops_w": tw.cpu().numpy(),
                     "area": area.cpu().numpy()},
        generations_run=n_gens, searches=score.searches,
        memo_hits=int(score.hits))
