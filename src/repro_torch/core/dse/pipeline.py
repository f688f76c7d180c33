"""The fused §4 multi-seed pipeline: sweep seeding -> per-seed GA
refinement -> Pareto merge, with device-resident memo state between
stages.

Port of ``repro/core/dse/pipeline.py``.  MOSAIC's Stage-1+2 study (paper
§4.5) is per seed: a stratified random sweep seeds one GA refinement per
area bracket, and the per-bracket winners across seeds merge into one
energy/area/latency Pareto front.  ``run_pipeline`` runs that study with
the host involved only at stage boundaries:

* Stage 1 per seed is ``sweep.run_sweep`` on a shared exact engine --
  scored batches land in the engine's host store, so repeated genomes
  across seeds (and across runs sharing a persistent store) are free.
* At each seed boundary the store's in-memory tier is loaded into a
  device-resident memo table (``device_memo.memo_from_store``) once;
  every refinement of that seed then runs on the device
  (``ga_device.run_ga_fused`` with ``store_sync=False``), threading the
  memo bracket to bracket.  After the last bracket the memo drains back
  to the store (``device_memo.drain_to_store``).
* The Pareto merge is ``pareto.pareto_mask_device`` on the engine's
  device over (mean energy, area, mean latency) of every valid refined
  candidate, keeping genomes aligned with surviving points.

``islands=None`` is one panmictic island on one card, whose seeded
genome stream is that of ``run_ga(loop="device")``.  The GA's random
draws come from ``draws(seed + int(bracket))`` (``ga_device.TorchDraws``
by default), so a resumed refinement recomputes its stream.

``on_stage`` streams progress: called after every completed stage with
an event dict carrying the stage name, seed/bracket, wall seconds, and
the *cumulative* Pareto front so far.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...device import resolve_device
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from .checkpoint import PipelineCheckpoint, run_digest
from .device_memo import (clear_fresh, drain_to_store, fresh_entries,
                          memo_from_store)
from .encoding import GENOME_LEN
from .api import EngineConfig
from .engine import EvalEngine, canonical_genomes
from .ga import GAConfig, GAResult
from .ga_device import run_ga_fused
from .objective import AREA_BRACKETS
from .pareto import pareto_mask_device
from .sweep import SweepResult, run_sweep

__all__ = ["PipelineResult", "run_pipeline"]


@dataclasses.dataclass
class PipelineResult:
    """Everything the §4 study produces, merged across seeds."""

    workloads: List[str]
    seeds: List[int]
    brackets: List[float]
    sweeps: Dict[int, SweepResult]
    # {seed: {bracket: GAResult}} — brackets without a homogeneous
    # baseline in that seed's sweep are absent (run_ga contract)
    results: Dict[int, Dict[float, GAResult]]
    front_points: np.ndarray     # (F, 3) mean energy pJ, area mm^2, mean lat s
    front_genomes: np.ndarray    # (F, GENOME_LEN) aligned with front_points
    evaluated: int               # genome evaluations across all GA stages
    stage_seconds: Dict[str, float]   # {"sweep": ..., "refine": ..., "merge": ...}

    def best(self, bracket: float) -> Optional[GAResult]:
        """Across seeds, the highest-fitness refinement at one bracket."""
        cands = [r[bracket] for r in self.results.values() if bracket in r]
        if not cands:
            return None
        return max(cands, key=lambda r: r.best_fitness)


def _sweep_arrays(swp: SweepResult) -> Dict[str, np.ndarray]:
    return {"genomes": swp.genomes, "family": swp.family,
            "bracket": swp.bracket, "area": swp.area,
            "latency": swp.latency, "energy": swp.energy,
            "tops_w": swp.tops_w}


def _sweep_from_record(seed: int, workloads: Sequence[str],
                       rec: Dict[str, np.ndarray]) -> SweepResult:
    return SweepResult(seed=seed, workloads=list(workloads),
                       genomes=rec["genomes"], family=rec["family"],
                       bracket=rec["bracket"], area=rec["area"],
                       latency=rec["latency"], energy=rec["energy"],
                       tops_w=rec["tops_w"])


def _import_sweep(engine: EvalEngine, swp: SweepResult) -> None:
    """Replay a resumed sweep's metric rows into the engine store —
    bitwise the rows ``run_sweep`` stored when it computed them — so
    the remaining stages' memo preloads and store probes hit exactly as
    the uninterrupted run's would."""
    rows = np.stack([swp.latency, swp.energy, swp.tops_w], axis=1)
    engine.import_memo(canonical_genomes(swp.genomes), rows)


def _refine_arrays(fused, front_pts: np.ndarray, front_genomes: np.ndarray,
                   dcanon: np.ndarray, drows: np.ndarray
                   ) -> Dict[str, np.ndarray]:
    r = fused.result
    return {"best_genome": r.best_genome,
            "best_fitness": np.float64(r.best_fitness),
            "best_savings": r.best_savings_per_wl,
            "best_lat": r.best_metrics["latency"],
            "best_en": r.best_metrics["energy"],
            "best_tw": r.best_metrics["tops_w"],
            "best_area": np.float64(r.best_metrics["area"]),
            "history": np.asarray(r.history, np.float64),
            "evaluated": np.int64(r.evaluated),
            "generations": np.int64(fused.generations_run),
            "front_points": front_pts, "front_genomes": front_genomes,
            "delta_canon": dcanon, "delta_rows": drows}


def _result_from_record(bracket: float, rec: Dict[str, np.ndarray]
                        ) -> GAResult:
    return GAResult(
        bracket=float(bracket), best_genome=rec["best_genome"],
        best_fitness=float(rec["best_fitness"]),
        best_savings_per_wl=rec["best_savings"],
        best_metrics={"latency": rec["best_lat"],
                      "energy": rec["best_en"],
                      "tops_w": rec["best_tw"],
                      "area": np.float64(rec["best_area"])},
        history=[float(x) for x in rec["history"]],
        evaluated=int(rec["evaluated"]))


def _valid_rows(metrics: Dict[str, np.ndarray]) -> np.ndarray:
    lat, en = metrics["latency"], metrics["energy"]
    ok = np.isfinite(lat).all(axis=1) & (lat > 0).all(axis=1)
    return ok & np.isfinite(en).all(axis=1)


def _merge_front(front_pts: np.ndarray, front_genomes: np.ndarray,
                 pop: np.ndarray, metrics: Dict[str, np.ndarray], device
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold one refined population into the cumulative front (device
    dominance kernel; keep-first dedupe favours the incumbent front)."""
    valid = _valid_rows(metrics)
    if not valid.any():
        return front_pts, front_genomes
    pts = np.stack([metrics["energy"][valid].mean(axis=1),
                    metrics["area"][valid],
                    metrics["latency"][valid].mean(axis=1)], axis=1)
    front_pts = np.concatenate([front_pts, pts])
    front_genomes = np.concatenate(
        [front_genomes, np.asarray(pop, np.int64)[valid]])
    mask = pareto_mask_device(front_pts, device).cpu().numpy()
    return front_pts[mask], front_genomes[mask]


def run_pipeline(workloads: Sequence[str], seeds: Sequence[int] = (0, 1, 2),
                 brackets: Sequence[float] = AREA_BRACKETS,
                 samples_per_stratum: int = 64,
                 cfg: Optional[GAConfig] = None,
                 calib: CalibrationTable = DEFAULT_CALIB,
                 engine: Optional[EvalEngine] = None,
                 islands: Optional[int] = None, migrate_every: int = 5,
                 migrate_k: int = 2, memo_capacity: int = 1 << 15,
                 verbose: bool = False,
                 on_stage: Optional[Callable[[Dict[str, Any]], None]] = None,
                 checkpoint: Optional[str] = None,
                 cluster=None, device=None,
                 draws: Optional[Callable] = None
                 ) -> PipelineResult:
    """Run the full multi-seed pipeline (see module docstring).

    ``engine`` must be a local exact engine when given (the fused
    refinement stages the search scan itself); by default one is built
    and shared across every stage, so its store accumulates the whole
    study.  ``cfg`` applies to every refinement; ``islands=None`` is one
    panmictic island on one card.

    ``checkpoint=<dir>`` makes every completed stage durable
    (``dse.checkpoint.PipelineCheckpoint``: atomic per-stage records +
    a run digest) and resumes from it: rerunning after a crash replays
    completed stages from their records — emitting their events with
    ``"resumed": True`` and re-importing their store rows so the
    remaining stages hit a warm store — and the finished study is
    **bitwise equal** to an uninterrupted run (pinned by
    tests/test_torch_pipeline.py).  When no ``engine`` is passed, the
    default engine's store persists in the same directory
    (``results.sqlite``).  In checkpointed runs the memo drains to the
    host store after every *bracket* (the recorded delta) rather than
    once per seed, so a kill mid-seed loses at most one refinement.

    ``on_stage(event)`` fires after each stage with

    * ``{"stage": "sweep", "seed": s, "configs": n, "seconds": dt}``
    * ``{"stage": "refine", "seed": s, "bracket": b, "seconds": dt,
      "best_fitness": f, "generations": g, "front": {"points": (F, 3)
      array, "genomes": (F, GENOME_LEN) array}}`` — the cumulative
      front after merging this stage (ordered by mean energy)
    * ``{"stage": "seed_done", "seed": s, "drained": n}`` after the
      seed's memo drains back to the store (in checkpointed runs ``n``
      counts the seed's per-bracket deltas, resumed ones included)

    and must not mutate its arguments.  A checkpointed stage's record
    is durable *before* its event fires, so an ``on_stage`` callback
    that raises (or a kill while it runs) never loses the stage.

    ``cluster=<serve.cluster.DSECluster>`` scores the Stage-1 sweeps
    through a worker cluster instead of the local engine: shard losses
    fail over to surviving workers inside the cluster, and the sweep's
    metric rows are then replayed into the local engine's store
    (``_import_sweep`` -- float64 round-trips bit for bit over the wire),
    so the fused refinements proceed from exactly the warm store an
    all-local run would have.  The study result is bit for bit the same
    with or without a cluster, so ``checkpoint=`` composes freely: a
    checkpoint written by a clustered run resumes on a local one (the
    run digest is identical).  The cluster must serve the same engine
    context as the local engine, device type included (its workers and
    the local engine both on ``cuda``, or both on ``cpu``).

    ``device`` places the engine a call builds (the card unless
    ``"cpu"`` is asked for); ``draws`` builds each refinement's
    random-draw source from ``seed + int(bracket)``
    (``ga_device.TorchDraws`` by default).
    """
    cfg = cfg or GAConfig()
    if engine is None:
        device = resolve_device(device)   # no card: raise before any I/O
    ck = PipelineCheckpoint(checkpoint) if checkpoint is not None else None
    if engine is None:
        engine = EvalEngine(workloads, calib, config=EngineConfig(
            backend="exact", nonfinite="skip",
            store=ck.open_store() if ck is not None else None),
            device=device)
    else:
        engine.check_workloads(workloads, calib)
    if not isinstance(engine, EvalEngine):
        raise ValueError("run_pipeline needs a local EvalEngine — the fused "
                         "refinement cannot run over a remote client")
    if engine.backend != "exact":
        raise ValueError("run_pipeline requires backend='exact'; got "
                         f"{engine.backend!r}")
    if cluster is not None:
        cluster.check_workloads(workloads, calib)
        if cluster.context_key() != engine.context_key():
            raise ValueError(
                "cluster workers serve a different engine context than the "
                f"local pipeline engine (on {engine.device.type}) -- sweep "
                "rows would not replay bit for bit into its store; the "
                "workers' engines and the local one must share workloads, "
                "calibration, compile flags, fidelity and device type")
    if ck is not None:
        ck.open(run_digest(engine, seeds, brackets, samples_per_stratum,
                           cfg, islands, migrate_every, migrate_k))

    front_pts = np.zeros((0, 3))
    front_genomes = np.zeros((0, GENOME_LEN), np.int64)
    sweeps: Dict[int, SweepResult] = {}
    results: Dict[int, Dict[float, GAResult]] = {}
    evaluated = 0
    secs = {"sweep": 0.0, "refine": 0.0, "merge": 0.0}

    def emit(ev: Dict[str, Any]) -> None:
        if on_stage is not None:
            on_stage(ev)

    for s in seeds:
        skey = f"sweep:{s}"
        if ck is not None and ck.has(skey):
            rec = ck.load(skey)
            swp = _sweep_from_record(s, workloads, rec)
            dt = float(rec["seconds"])
            secs["sweep"] += dt
            sweeps[s] = swp
            _import_sweep(engine, swp)
            emit({"stage": "sweep", "seed": s, "configs": len(swp.genomes),
                  "seconds": dt, "resumed": True})
        else:
            t0 = time.perf_counter()
            swp = run_sweep(workloads, samples_per_stratum, seed=s,
                            calib=calib, brackets=brackets, verbose=verbose,
                            engine=engine if cluster is None else cluster)
            if cluster is not None:
                # the workers computed the rows; replay them into the
                # local engine's store so the fused refinements hit the
                # same warm store an all-local sweep would have left
                _import_sweep(engine, swp)
            dt = time.perf_counter() - t0
            secs["sweep"] += dt
            sweeps[s] = swp
            if ck is not None:
                ck.record(skey, seconds=np.float64(dt), **_sweep_arrays(swp))
            emit({"stage": "sweep", "seed": s, "configs": len(swp.genomes),
                  "seconds": dt})

        # seed boundary, host -> device: ONE memo load per seed, created
        # lazily before the first refinement that actually *runs* — so
        # on a resume every replayed stage has re-imported its rows into
        # the store by the time the preload walks it.  The per-bracket
        # refinements thread the table forward with store_sync=False: no
        # host sync between brackets (checkpointed runs additionally
        # drain each bracket's delta into the host store when recording).
        memo = None
        results[s] = {}
        drained = 0
        for b in brackets:
            rkey = f"refine:{s}:{float(b):g}"
            if ck is not None and ck.has(rkey):
                rec = ck.load(rkey)
                dt = float(rec["seconds"])
                secs["refine"] += dt
                if "skipped" in rec:
                    emit({"stage": "refine", "seed": s, "bracket": b,
                          "seconds": dt,
                          "skipped": "no homogeneous baseline",
                          "resumed": True})
                    continue
                res = _result_from_record(b, rec)
                results[s][b] = res
                evaluated += res.evaluated
                front_pts = rec["front_points"]
                front_genomes = rec["front_genomes"]
                engine.import_memo(rec["delta_canon"], rec["delta_rows"])
                drained += len(rec["delta_canon"])
                emit({"stage": "refine", "seed": s, "bracket": b,
                      "seconds": dt, "best_fitness": res.best_fitness,
                      "generations": int(rec["generations"]),
                      "front": {"points": front_pts.copy(),
                                "genomes": front_genomes.copy()},
                      "resumed": True})
                continue

            if memo is None:
                memo = memo_from_store(engine, memo_capacity)
            t0 = time.perf_counter()
            fused = run_ga_fused(swp, b, cfg, seed=s, calib=calib,
                                 verbose=verbose, engine=engine,
                                 islands=islands,
                                 migrate_every=migrate_every,
                                 migrate_k=migrate_k, memo=memo,
                                 store_sync=False, draws=draws)
            dt = time.perf_counter() - t0
            secs["refine"] += dt
            if fused is None:
                if ck is not None:
                    ck.record(rkey, skipped=np.int64(1),
                              seconds=np.float64(dt))
                emit({"stage": "refine", "seed": s, "bracket": b,
                      "seconds": dt, "skipped": "no homogeneous baseline"})
                continue
            memo = fused.memo
            results[s][b] = fused.result
            evaluated += fused.result.evaluated

            t0 = time.perf_counter()
            front_pts, front_genomes = _merge_front(
                front_pts, front_genomes, fused.population,
                fused.pop_metrics, engine.device)
            order = np.argsort(front_pts[:, 0])
            front_pts = front_pts[order]
            front_genomes = front_genomes[order]
            secs["merge"] += time.perf_counter() - t0
            if ck is not None:
                # drain this bracket's delta now (instead of once per
                # seed): the recorded stage then carries its own rows —
                # the unit a resume re-imports
                dcanon, drows = fresh_entries(memo)
                engine.import_memo(dcanon, drows)
                memo = clear_fresh(memo)
                drained += len(dcanon)
                ck.record(rkey, seconds=np.float64(dt),
                          **_refine_arrays(fused, front_pts, front_genomes,
                                           dcanon, drows))
            emit({"stage": "refine", "seed": s, "bracket": b, "seconds": dt,
                  "best_fitness": fused.result.best_fitness,
                  "generations": fused.generations_run,
                  "front": {"points": front_pts.copy(),
                            "genomes": front_genomes.copy()}})
            if verbose:
                print(f"[pipeline seed {s}] bracket {b:.0f}mm2: "
                      f"best={fused.result.best_fitness:+.4f}, "
                      f"front size {len(front_pts)}")

        # seed boundary, device -> host: drain the memo once (already
        # drained per bracket in checkpointed runs — only leftovers,
        # normally zero, export here)
        dkey = f"seed_done:{s}"
        if ck is not None and ck.has(dkey):
            rec = ck.load(dkey)
            emit({"stage": "seed_done", "seed": s,
                  "drained": int(rec["drained"]), "resumed": True})
        else:
            if ck is None:
                drained = drain_to_store(memo, engine) \
                    if memo is not None else 0
            elif memo is not None:
                dcanon, drows = fresh_entries(memo)
                engine.import_memo(dcanon, drows)
                drained += len(dcanon)
            if ck is not None:
                ck.record(dkey, drained=np.int64(drained))
            emit({"stage": "seed_done", "seed": s, "drained": drained})

    return PipelineResult(
        workloads=list(workloads), seeds=list(seeds),
        brackets=[float(b) for b in brackets], sweeps=sweeps,
        results=results, front_points=front_pts,
        front_genomes=front_genomes, evaluated=evaluated,
        stage_seconds=secs)
