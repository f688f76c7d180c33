"""DSE objective (paper Eq. 8), on the host.

Port of ``repro/core/dse/objective.py`` (pure numpy, unchanged):

fitness(d) = mean_w [ (E_homo_w - E_d_w) / E_homo_w ]  +  alpha * TOPS/W(d) / max TOPS/W

The first term is the workload-equal-weighted mean iso-area energy savings
of the candidate over the *best homogeneous design at the same area
bracket* (found in the sweep); alpha is a small positive tie-breaker.

Both §3.2 schedule modes score through the same Eq. 8 shape: with an
engine in ``mode="latency"`` the energy matrix is per-batch energy at the
one-batch makespan; in ``mode="throughput"`` it is the steady-state
energy per inference (leakage charged over the initiation interval).
``serving_fitness`` adds the serving-deployment constraint: minimize
energy per inference subject to a per-workload II target.
"""
from __future__ import annotations

import numpy as np

__all__ = ["iso_area_savings", "fitness", "serving_fitness",
           "AREA_BRACKETS", "area_bracket"]

AREA_BRACKETS = (50.0, 100.0, 200.0, 400.0, 800.0)  # mm^2 (paper §4.5)
ALPHA = 0.05


def area_bracket(area_mm2: float) -> float:
    """Assign a chip to the smallest bracket that contains it."""
    for b in AREA_BRACKETS:
        if area_mm2 <= b:
            return b
    return AREA_BRACKETS[-1]


def iso_area_savings(energy_cand: np.ndarray, energy_homo_best: np.ndarray) -> np.ndarray:
    """Per-workload fractional savings (positive = candidate better)."""
    e_c = np.asarray(energy_cand, dtype=np.float64)
    e_h = np.asarray(energy_homo_best, dtype=np.float64)
    return (e_h - e_c) / np.maximum(e_h, 1e-30)


def fitness(energy_cand_per_wl: np.ndarray, energy_homo_per_wl: np.ndarray,
            tops_per_w: float, max_tops_per_w: float,
            alpha: float = ALPHA) -> float:
    """Eq. 8 scalar fitness for one candidate."""
    sav = iso_area_savings(energy_cand_per_wl, energy_homo_per_wl)
    tie = alpha * tops_per_w / max(max_tops_per_w, 1e-30)
    return float(np.mean(sav) + tie)


def serving_fitness(energy_ss_pj: np.ndarray, ii_s: np.ndarray,
                    ii_target_s) -> np.ndarray:
    """Serving-mode DSE score: negated mean steady-state energy per
    inference, with designs whose initiation interval misses the target
    on any workload scored ``-inf`` (they cannot sustain the request
    rate, so their energy is irrelevant).

    ``energy_ss_pj`` / ``ii_s`` are (N, W) throughput-mode engine outputs
    (the ``energy`` / ``latency`` columns of an ``EvalEngine`` running
    ``mode="throughput"``); ``ii_target_s`` is a scalar or (W,) per-
    workload rate target.  Returns (N,) — higher is better, so the same
    argmax machinery the Eq. 8 fitness feeds works unchanged.
    """
    e = np.asarray(energy_ss_pj, np.float64)
    ii = np.asarray(ii_s, np.float64)
    feasible = np.all(ii <= np.asarray(ii_target_s, np.float64), axis=-1)
    score = -np.mean(e, axis=-1)
    return np.where(feasible & np.isfinite(score), score, -np.inf)
