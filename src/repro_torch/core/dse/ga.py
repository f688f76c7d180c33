"""Stage 2 -- per-area-budget genetic-algorithm refinement (paper §4.5).

Port of ``repro/core/dse/ga.py``.  Paper settings: population 200, 100
generations, tournament selection of size 5, 80 % crossover, 20 %
mutation, 10 % elitism, seeded from the top 50 sweep individuals at each
budget, ten-generation no-improvement early stop.  Fitness is Eq. 8
against the sweep's best-homogeneous baseline at the same bracket.

``run_ga`` delegates to the device generation loop
(``ga_device.run_ga_device``) by default: genetics and canonicalization
on the device, scoring through the engine -- absent an explicit
``engine``, the exact search backend.  ``loop="fused"`` runs the whole
refinement against the device-resident memo (``ga_device.run_ga_fused``,
one island).  The numpy loop below (``loop="host"``) draws from
``np.random.default_rng``, so the same seed and the same metrics give the
reference's genomes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from .api import EngineConfig
from .encoding import GENOME_LEN, genome_bounds, random_genomes
from .engine import EvalEngine
from .objective import ALPHA, area_bracket
from .sweep import SweepResult

__all__ = ["GAConfig", "GAResult", "run_ga"]


@dataclasses.dataclass
class GAConfig:
    population: int = 200
    generations: int = 100
    tournament: int = 5
    crossover_rate: float = 0.8
    mutation_rate: float = 0.2
    elitism: float = 0.1
    seed_top_k: int = 50
    early_stop: int = 10  # generations without improvement
    alpha: float = ALPHA


@dataclasses.dataclass
class GAResult:
    bracket: float
    best_genome: np.ndarray
    best_fitness: float
    best_savings_per_wl: np.ndarray
    best_metrics: Dict[str, np.ndarray]
    history: List[float]
    evaluated: int


def _fitness(en: np.ndarray, tw: np.ndarray, lat: np.ndarray,
             area: np.ndarray, bracket: float, e_homo: np.ndarray,
             alpha: float) -> np.ndarray:
    sav = (e_homo[None, :] - en) / np.maximum(e_homo[None, :], 1e-30)
    fit = sav.mean(axis=1)
    peak_tw = tw.max(axis=1)
    bad = ~np.isfinite(lat).all(axis=1) | ~(lat > 0).all(axis=1)
    # out-of-bracket designs are not iso-area comparable
    bad |= np.array([area_bracket(a) != bracket for a in area])
    # normalize TOPS/W over comparable designs only: a -inf-fitness
    # out-of-bracket child must not rescale the alpha term of the valid
    # population (it also lets the engine skip simulating such children)
    ok = ~bad
    max_tw = peak_tw[ok].max() if ok.any() else 1.0
    fit = fit + alpha * peak_tw / max(max_tw, 1e-30)
    fit[bad] = -np.inf
    return fit


def run_ga(sweep: SweepResult, bracket: float,
           cfg: GAConfig = GAConfig(), seed: int = 0,
           calib: CalibrationTable = DEFAULT_CALIB,
           verbose: bool = False, engine: Optional[EvalEngine] = None,
           prefilter: bool = True, loop: str = "device",
           on_generation: Optional[Callable] = None, device=None
           ) -> Optional[GAResult]:
    """GA refinement at one area budget, seeded from the sweep.

    ``loop="device"`` (default) runs ``ga_device.run_ga_device`` and
    ``loop="fused"`` ``ga_device.run_ga_fused`` with one island (the same
    genomes; it needs a local exact engine and takes no
    ``on_generation``); without an ``engine`` both score through
    ``EvalEngine(backend="exact", nonfinite="skip")`` on ``device``.
    ``loop="host"`` runs the numpy generation loop.  Scoring goes through
    a (optionally shared) ``EvalEngine``: the elites re-entering every
    generation and duplicate children are cache hits, and with
    ``prefilter`` (default) out-of-bracket children -- whose Eq. 8
    fitness is -inf regardless of their metrics -- skip simulation.  An
    engine the host loop builds itself (no ``engine``) has the
    reference's default config, the scan backend, on ``device`` (the card
    unless ``"cpu"`` is asked for).

    ``on_generation(gen, pop, fit, metrics)``, when given, is called
    after every scored population -- ``gen`` 0 for the seed population,
    then 1..N -- with the raw genomes, their Eq. 8 fitness and the metric
    arrays; it must not mutate its arguments."""
    if loop not in ("device", "host", "fused"):
        raise ValueError(f"loop {loop!r} not in ('device', 'host', 'fused')")
    if loop == "device":
        from .ga_device import run_ga_device
        return run_ga_device(sweep, bracket, cfg, seed=seed, calib=calib,
                             verbose=verbose, engine=engine,
                             prefilter=prefilter,
                             on_generation=on_generation, device=device)
    if loop == "fused":
        if on_generation is not None:
            raise ValueError(
                "loop='fused' runs the whole refinement on the device -- "
                "per-generation hooks can't fire; use loop='device' or "
                "run_pipeline(on_stage=...)")
        from .ga_device import run_ga_fused
        fused = run_ga_fused(sweep, bracket, cfg, seed=seed, calib=calib,
                             verbose=verbose, engine=engine, islands=1,
                             device=device)
        return None if fused is None else fused.result
    engine = (engine.check_workloads(sweep.workloads, calib)
              if engine is not None
              else EvalEngine(sweep.workloads, calib,
                              config=EngineConfig(), device=device))
    rng = np.random.default_rng(seed + int(bracket))
    base = sweep.homo_baseline()
    if bracket not in base:
        return None
    e_homo = base[bracket]
    bounds = genome_bounds()

    # ---- seed population: top-k sweep individuals in this bracket ----------
    fit_sweep = sweep.fitness(cfg.alpha)
    in_b = np.nonzero((sweep.bracket == bracket) & np.isfinite(fit_sweep))[0]
    # seed_top_k may exceed the population: keep the fittest `population`
    order = in_b[np.argsort(-fit_sweep[in_b])][:cfg.seed_top_k]
    pop = sweep.genomes[order].copy()[:cfg.population]
    while len(pop) < cfg.population:
        fill = random_genomes(rng, cfg.population - len(pop),
                              family="hetero_bls" if rng.random() < 0.5 else None)
        pop = np.concatenate([pop, fill])[:cfg.population]

    def keep(areas: np.ndarray) -> np.ndarray:
        return np.fromiter((area_bracket(a) == bracket for a in areas),
                           bool, len(areas))

    def evaluate(genomes: np.ndarray):
        m = engine.evaluate(genomes, keep=keep if prefilter else None)
        m.pop("meta", None)  # best_metrics holds per-genome arrays only
        fit = _fitness(m["energy"], m["tops_w"], m["latency"], m["area"],
                       bracket, e_homo, cfg.alpha)
        return fit, m

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
    for gen in range(cfg.generations):
        # tournament selection
        def pick() -> np.ndarray:
            idx = rng.integers(0, len(pop), cfg.tournament)
            return pop[idx[np.argmax(fit[idx])]]

        children = []
        elite_idx = np.argsort(-fit)[:n_elite]
        children.extend(pop[elite_idx].copy())
        while len(children) < cfg.population:
            a, b = pick().copy(), pick().copy()
            if rng.random() < cfg.crossover_rate:   # uniform crossover
                mask = rng.random(GENOME_LEN) < 0.5
                a[mask], b[mask] = b[mask], a[mask]
            for child in (a, b):
                if rng.random() < cfg.mutation_rate:
                    k = max(1, rng.poisson(2))
                    genes = rng.integers(0, GENOME_LEN, k)
                    child[genes] = (rng.random(k) * bounds[genes]).astype(np.int32)
                children.append(child)
        pop = np.asarray(children[:cfg.population])
        fit, metrics = evaluate(pop)
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
            print(f"[ga {bracket:.0f}mm2] gen {gen}: best={best[0]:+.4f} "
                  f"(stall {stall})")
        if stall >= cfg.early_stop:
            break

    sav = (e_homo - best[2]["energy"]) / np.maximum(e_homo, 1e-30)
    return GAResult(bracket=bracket, best_genome=best[1],
                    best_fitness=float(best[0]), best_savings_per_wl=sav,
                    best_metrics=best[2], history=history, evaluated=evaluated)
