"""Bayesian-optimization search backend (paper §3.5): a sample-efficient
alternative to the stratified sweep when the simulation budget is
constrained.

Port of ``repro/core/dse/bayes.py`` (pure numpy; every draw from
``np.random.default_rng``, so the same seed and metrics give the
reference's genomes).  Surrogate: RBF-kernel ridge regression over
normalized genomes.  Acquisition: expected improvement, maximized over a
random candidate pool each round.  Scoring runs the engine's *exact*
search backend by default, so the surrogate is fit on, and the reported
optimum scored with, exact metrics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from .encoding import genome_bounds, random_genomes
from .api import EngineConfig
from .engine import EvalEngine

__all__ = ["BayesConfig", "run_bayes"]


@dataclasses.dataclass
class BayesConfig:
    init_samples: int = 64
    rounds: int = 8
    batch_per_round: int = 16
    candidate_pool: int = 2048
    length_scale: float = 1.2
    ridge: float = 1e-4
    explore: float = 0.01  # EI jitter


def _featurize(genomes: np.ndarray) -> np.ndarray:
    return genomes.astype(np.float64) / genome_bounds()[None, :]


def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / (2.0 * ls * ls))


class _Surrogate:
    def __init__(self, ls: float, ridge: float):
        self.ls, self.ridge = ls, ridge
        self.x: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self.x = x
        k = _rbf(x, x, self.ls) + self.ridge * np.eye(len(x))
        self.k_inv = np.linalg.inv(k)
        self.alpha = self.k_inv @ y
        self.y_mean = float(y.mean())

    def predict(self, x: np.ndarray):
        ks = _rbf(x, self.x, self.ls)
        mu = ks @ self.alpha
        var = np.maximum(1.0 - np.einsum("ij,jk,ik->i", ks, self.k_inv, ks), 1e-9)
        return mu, np.sqrt(var)


def _expected_improvement(mu, sigma, best, xi):
    z = (mu - best - xi) / sigma
    # standard normal pdf / cdf without scipy
    pdf = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)
    cdf = 0.5 * (1 + np.vectorize(_erf)(z / np.sqrt(2)))
    return (mu - best - xi) * cdf + sigma * pdf


def _erf(x: float) -> float:
    import math
    return math.erf(x)


def run_bayes(workloads: Sequence[str], objective_fn,
              cfg: BayesConfig = BayesConfig(), seed: int = 0,
              calib: CalibrationTable = DEFAULT_CALIB,
              verbose: bool = False,
              engine: Optional[EvalEngine] = None,
              device=None) -> Dict[str, object]:
    """Maximize ``objective_fn(metrics) -> (N,) score`` over the genome
    space.  Returns best genome/score plus the evaluation history.
    Scoring goes through a (optionally shared) ``EvalEngine``, so a
    candidate the acquisition re-picks in a later round is a cache hit.
    The default engine runs ``backend="exact"`` (search-time metrics ==
    ``rescore()`` bitwise); with a shared non-exact engine the best
    genome is exact-rescored after the rounds, and the result carries
    ``best_metrics_exact`` / ``best_score_exact`` alongside the
    search-time numbers.  ``device`` places an engine the loop builds
    itself (the card unless ``"cpu"`` is asked for)."""
    engine = (engine.check_workloads(workloads, calib)
              if engine is not None
              else EvalEngine(workloads, calib,
                              config=EngineConfig(backend="exact",
                                                  nonfinite="skip"),
                              device=device))
    rng = np.random.default_rng(seed)
    genomes = random_genomes(rng, cfg.init_samples)
    metrics = engine.evaluate(genomes)
    metrics.pop("meta", None)  # concatenated per-genome arrays only
    scores = objective_fn(metrics)
    history = [float(np.nanmax(scores))]
    surr = _Surrogate(cfg.length_scale, cfg.ridge)

    for rnd in range(cfg.rounds):
        ok = np.isfinite(scores)
        surr.fit(_featurize(genomes[ok]), scores[ok])
        best = float(scores[ok].max())
        pool = random_genomes(rng, cfg.candidate_pool)
        mu, sigma = surr.predict(_featurize(pool))
        ei = _expected_improvement(mu, sigma, best, cfg.explore)
        pick = pool[np.argsort(-ei)[:cfg.batch_per_round]]
        m2 = engine.evaluate(pick)
        s2 = objective_fn(m2)
        genomes = np.concatenate([genomes, pick])
        scores = np.concatenate([scores, s2])
        for k in metrics:
            metrics[k] = np.concatenate([metrics[k], m2[k]])
        history.append(float(np.nanmax(scores)))
        if verbose:
            print(f"[bayes] round {rnd}: best={history[-1]:+.4f}")

    bi = int(np.nanargmax(scores))
    # exact numbers for the reported optimum: free when the search itself
    # ran the exact backend; one fused rescore dispatch otherwise
    if engine.backend in ("exact", "batched"):
        m_exact = {k: metrics[k][bi:bi + 1] for k in
                   ("latency", "energy", "tops_w", "area")}
    else:
        m_exact = engine.rescore(genomes[bi][None, :])
        m_exact.pop("meta", None)
    score_exact = float(np.asarray(objective_fn(m_exact)).reshape(-1)[0])
    return {"best_genome": genomes[bi], "best_score": float(scores[bi]),
            "best_metrics_exact": m_exact, "best_score_exact": score_exact,
            "history": history, "genomes": genomes, "scores": scores,
            "metrics": metrics}
