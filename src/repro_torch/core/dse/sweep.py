"""Stage 1 -- multi-seed stratified random sweep (paper §3.5, §4.5).

Port of ``repro/core/dse/sweep.py``.  Strata = area bracket x
architecture family ({Homo, Hetero-BL, Hetero-BLS}).  Per seed, a genome
pool is sampled per family, assigned to area brackets, and every
in-bracket config is scored on every workload through an ``EvalEngine``.
Per-workload savings are computed against the *best homogeneous design
at the same bracket* found in the same sweep (the iso-area baseline of
Eq. 8).  Every draw comes from ``np.random.default_rng(seed)``, so the
same seed samples the reference's genomes.

The default backend is the reference's, ``scan``; ``exact=True`` builds
an exact engine instead.  ``device`` places the engine a call builds
(the card unless ``"cpu"`` is asked for).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..workloads import build
from .api import EngineConfig
from .batch_eval import batch_evaluate, prepare_configs, prepare_workload
from .encoding import FAMILIES, decode, sample_in_bracket
from .engine import EvalEngine
from .objective import ALPHA, AREA_BRACKETS, area_bracket

__all__ = ["SweepResult", "run_sweep", "run_sweeps", "evaluate_genomes",
           "evaluate_genomes_reference"]


@dataclasses.dataclass
class SweepResult:
    """All sampled configs of one seed, plus per-workload metrics."""

    seed: int
    workloads: List[str]
    genomes: np.ndarray          # (N, GENOME_LEN)
    family: np.ndarray           # (N,) index into FAMILIES
    bracket: np.ndarray          # (N,) mm^2 bracket value
    area: np.ndarray             # (N,)
    latency: np.ndarray          # (N, W) seconds
    energy: np.ndarray           # (N, W) pJ
    tops_w: np.ndarray           # (N, W)

    def valid_mask(self) -> np.ndarray:
        ok = np.isfinite(self.latency).all(axis=1) & (self.latency > 0).all(axis=1)
        return ok & np.isfinite(self.energy).all(axis=1)

    def homo_baseline(self) -> Dict[float, np.ndarray]:
        """Per bracket: per-workload minimum energy over valid Homo configs
        with area <= bracket.  Cumulative over brackets because the largest
        single-type homo chip tops out near ~220 mm^2 on the paper's knob
        grid -- at 400/800 mm^2 the baseline is "the biggest homo chip"."""
        out: Dict[float, np.ndarray] = {}
        valid = self.valid_mask()
        best: Optional[np.ndarray] = None
        for b in AREA_BRACKETS:
            sel = valid & (self.family == 0) & (self.bracket == b)
            if sel.any():
                cur = self.energy[sel].min(axis=0)
                best = cur if best is None else np.minimum(best, cur)
            if best is not None:
                out[b] = best
        return out

    def savings(self) -> np.ndarray:
        """(N, W) iso-area fractional savings vs the homo baseline; NaN when
        the bracket has no homogeneous baseline."""
        base = self.homo_baseline()
        sav = np.full_like(self.energy, np.nan)
        for b, e_h in base.items():
            sel = self.bracket == b
            sav[sel] = (e_h[None, :] - self.energy[sel]) / np.maximum(e_h, 1e-30)
        sav[~self.valid_mask()] = np.nan
        return sav

    def fitness(self, alpha: float = ALPHA) -> np.ndarray:
        """(N,) Eq. 8 fitness (NaN-safe; invalid configs get -inf)."""
        sav = self.savings()
        mean_sav = np.nanmean(sav, axis=1)
        peak_tw = np.nanmax(np.where(np.isfinite(self.tops_w), self.tops_w, np.nan),
                            axis=1)
        max_tw = np.nanmax(peak_tw) if np.isfinite(peak_tw).any() else 1.0
        fit = mean_sav + alpha * peak_tw / max(max_tw, 1e-30)
        fit[~np.isfinite(fit)] = -np.inf
        return fit


def evaluate_genomes(genomes: np.ndarray, workloads: Sequence[str],
                     calib: CalibrationTable = DEFAULT_CALIB,
                     batch: int = 1024, device=None) -> Dict[str, np.ndarray]:
    """Score genomes on every workload (one-shot ``EvalEngine`` with the
    reference's default config, the scan backend, on ``device``).  Search
    loops should hold their own engine so its memo persists."""
    return EvalEngine(workloads, calib, config=EngineConfig(batch=batch),
                      device=device).evaluate(genomes)


def evaluate_genomes_reference(genomes: np.ndarray, workloads: Sequence[str],
                               calib: CalibrationTable = DEFAULT_CALIB,
                               batch: int = 1024,
                               device=None) -> Dict[str, np.ndarray]:
    """The reference's pre-engine host loop, kept verbatim as the parity
    baseline: re-prepares every workload per batch, decodes every genome
    into a ``ChipConfig`` and runs ``batch_eval.batch_evaluate`` on
    ``device``."""
    chips = [decode(g, f"g{i}") for i, g in enumerate(genomes)]
    n, w = len(chips), len(workloads)
    lat = np.zeros((n, w))
    en = np.zeros((n, w))
    tw = np.zeros((n, w))
    area = np.zeros(n)
    for s in range(0, n, batch):
        cfgs = prepare_configs(chips[s:s + batch], calib)
        area[s:s + batch] = cfgs["chip"]["chip_area"]
        for j, wname in enumerate(workloads):
            ws = prepare_workload(build(wname))
            res = batch_evaluate(ws, cfgs, calib, device=device)
            lat[s:s + batch, j] = res["latency_s"]
            en[s:s + batch, j] = res["energy_pj"]
            power = res["energy_pj"] * 1e-12 / np.maximum(res["latency_s"],
                                                          1e-30)
            tw[s:s + batch, j] = res["achieved_tops"] / np.maximum(power,
                                                                   1e-30)
    return {"latency": lat, "energy": en, "tops_w": tw, "area": area}


def _engine(engine: Optional[EvalEngine], workloads: Sequence[str],
            calib: CalibrationTable, exact: bool, device) -> EvalEngine:
    return (engine.check_workloads(workloads, calib)
            if engine is not None
            else EvalEngine(workloads, calib, config=EngineConfig(
                backend="exact" if exact else "scan"), device=device))


def run_sweep(workloads: Sequence[str], samples_per_stratum: int = 64,
              seed: int = 0, calib: CalibrationTable = DEFAULT_CALIB,
              brackets: Sequence[float] = AREA_BRACKETS,
              verbose: bool = False,
              engine: Optional[EvalEngine] = None,
              exact: bool = False, device=None) -> SweepResult:
    """One seed of the stratified sweep (strata = bracket x family).

    Pass a shared ``engine`` to reuse its caches across seeds and into
    the downstream GA refinement (repeated genomes are free).  The
    engine's §3.2 schedule mode flows through unchanged.  ``exact=True``
    (only meaningful without a shared ``engine``) scores through the
    exact search backend (``EvalEngine(backend="exact")``)."""
    engine = _engine(engine, workloads, calib, exact, device)
    rng = np.random.default_rng(seed)

    def area_fn(genome):
        return float(engine.areas(genome[None, :])[0])

    genomes_all, fam_all = [], []
    for fi, fam in enumerate(FAMILIES):
        for b in brackets:
            g = sample_in_bracket(rng, samples_per_stratum, fam, b, area_fn)
            genomes_all.append(g)
            fam_all.append(np.full(len(g), fi))
    genomes = np.concatenate(genomes_all)
    family = np.concatenate(fam_all)

    t0 = time.time()
    m = engine.evaluate(genomes)
    bracket = np.array([area_bracket(a) for a in m["area"]])
    if verbose:
        print(f"[sweep seed {seed}] {len(genomes)} configs x "
              f"{len(workloads)} workloads in {time.time() - t0:.1f}s "
              f"(cache hit rate {engine.stats.hit_rate():.0%})")
    return SweepResult(seed=seed, workloads=list(workloads), genomes=genomes,
                       family=family, bracket=bracket, area=m["area"],
                       latency=m["latency"], energy=m["energy"],
                       tops_w=m["tops_w"])


def run_sweeps(workloads: Sequence[str], seeds: Sequence[int] = (0, 1, 2),
               samples_per_stratum: int = 64,
               calib: CalibrationTable = DEFAULT_CALIB,
               brackets: Sequence[float] = AREA_BRACKETS,
               verbose: bool = False,
               engine: Optional[EvalEngine] = None,
               exact: bool = False, device=None) -> Dict[int, SweepResult]:
    """The paper's multi-seed Stage 1: one stratified sweep per seed,
    sharing one engine (repeated genomes across seeds are free).  Returns
    ``{seed: SweepResult}`` in seed order."""
    engine = _engine(engine, workloads, calib, exact, device)
    return {s: run_sweep(workloads, samples_per_stratum, seed=s, calib=calib,
                         brackets=brackets, verbose=verbose, engine=engine)
            for s in seeds}
