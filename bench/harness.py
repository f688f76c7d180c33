"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the result line.

A cell of ``BENCHMARK.json`` names a configuration
(``bench/configs/<config>.json``: the workloads, the ``EngineConfig``, the
reference path, the sample and the limits of the check) and a traffic mix
(``bench/traffic/<mix>.json``, read by ``traffic/generator.py``).  Each
metric is read by ``bench/metrics/<metric>.py`` (``read(record)``: a
number, or ``None`` where the run has nothing to read) from the run's
record:

* ``calls``: one entry per whole call of the window, ``wall_s`` (host
  clock around ``EvalEngine.evaluate`` and a device synchronisation),
  ``start_s`` and ``end_s`` (its bounds, from the window's start),
  ``pairs`` (genomes x workloads), ``gc_s`` (seconds of Python's garbage
  collections inside the call), ``memo`` (the engine's memo entries after
  it) and, with ``--trace 1``, ``search_s`` and ``scan_s`` (spans around
  ``search_population`` and ``batch_evaluate``, the backend calls that
  ``evaluate`` makes);
* ``rows``: the active op rows of the configuration's workloads (one
  call walks each once);
* ``window_s`` (``--seconds``), ``setup_s``, ``peak_bytes``
  (``max_memory_allocated`` over the window);
* ``trace``, with ``--trace 1``: the profiler's reading of one more whole
  call after the window (``devtrace.py``).

The program under test is ``repro_torch``; nothing of it is edited.
Spans are installed only for ``--trace 1`` runs, by wrapping the two
backend functions in the engine module's namespace for the run.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot produce a result (no card, a cell or file that
    does not exist, a forbidden import)."""


def _json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, bench_json: Optional[str] = None) -> Dict:
    """The cell's entry with its configuration, mix and metrics, found by
    name from ``BENCHMARK.json``."""
    spec = _json(bench_json or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise BenchError(f"no cell {name!r} in BENCHMARK.json")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in spec["configs"]}
    cell["config_file"] = configs[cell["config"]]["file"]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    cell["end_to_end"] = [m for m in spec["end_to_end"] if applies(m)]
    cell["per_layer"] = [m for m in spec["per_layer"] if applies(m)]
    return cell


def load_config(cell: Dict) -> Dict:
    return _json(os.path.join(ROOT, cell["config_file"]))


_READERS: Dict[str, object] = {}


def reader(metric: str):
    """``bench/metrics/<metric>.py``, loaded by its path (a metric's name
    may hold dots)."""
    if metric not in _READERS:
        path = os.path.join(BENCH, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{len(_READERS)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _READERS[metric] = mod
    return _READERS[metric]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one that
    no run may load (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    base = os.path.join(ROOT, "build", "bench-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


class Spans:
    """Host spans around the engine's backend calls, installed for one
    run: ``search_population`` (the exact search) and ``batch_evaluate``
    (the scan), as ``repro_torch.core.dse.engine`` calls them.  Each adds
    its seconds to the current call's record and names its range in the
    profiler's trace."""

    NAMES = {"search_population": "search_s", "batch_evaluate": "scan_s"}

    def __init__(self):
        self.current: Optional[Dict] = None

    @contextlib.contextmanager
    def installed(self):
        import torch
        from repro_torch.core.dse import engine as eng

        saved = {n: getattr(eng, n) for n in self.NAMES}

        def wrap(name, fn):
            key = self.NAMES[name]

            def timed(*a, **kw):
                with torch.profiler.record_function(f"bench.{name}"):
                    t0 = time.perf_counter()
                    try:
                        return fn(*a, **kw)
                    finally:
                        if self.current is not None:
                            self.current[key] = self.current.get(key, 0.0) \
                                + time.perf_counter() - t0
            return timed

        for n, fn in saved.items():
            setattr(eng, n, wrap(n, fn))
        try:
            yield self
        finally:
            for n, fn in saved.items():
                setattr(eng, n, fn)


class GCClock:
    """Seconds that Python's garbage collector runs, read by the call."""

    def __init__(self):
        self.total, self._t0 = 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.total += time.perf_counter() - self._t0

    @contextlib.contextmanager
    def installed(self):
        gc.callbacks.append(self)
        try:
            yield self
        finally:
            gc.callbacks.remove(self)


def timed_call(engine, genomes, sync, spans: Optional[Spans],
               gc_clock: Optional[GCClock] = None) -> Dict:
    """One ``evaluate`` of ``genomes``, timed to the device's end."""
    import torch
    rec: Dict = {}
    if spans is not None:
        spans.current = rec
    gc0 = gc_clock.total if gc_clock is not None else 0.0
    with torch.profiler.record_function("bench.evaluate"):
        t0 = time.perf_counter()
        out = engine.evaluate(genomes)
        sync()
        rec["wall_s"] = time.perf_counter() - t0
    if spans is not None:
        spans.current = None
    if gc_clock is not None:
        rec["gc_s"] = gc_clock.total - gc0
    rec["memo"] = len(getattr(engine.store, "data", ()))
    rec["pairs"] = int(out["latency"].size)
    rec["nonfinite"] = int(out["meta"].get("nonfinite", 0))
    rec["out"] = out
    return rec


def keep_sample(kept: List, genomes, out, rng, per_call: int) -> None:
    """Keep ``per_call`` rows of one call, drawn from the run's seed, for
    the check after the window."""
    idx = np.sort(rng.choice(len(genomes), min(per_call, len(genomes)),
                             replace=False))
    kept.append({"genomes": genomes[idx],
                 **{k: np.asarray(out[k])[idx]
                    for k in ("latency", "energy", "tops_w", "area")}})


def compare(prog: Dict, ref: Dict, limits: Dict) -> Dict:
    """The numbers that decide ``correct``, each beside its limit.

    ``max_rel_err``: the widest relative gap between the program's and the
    reference's latency, energy, TOPS/W (pairs finite on both sides) and
    area; ``mask_mismatch``: pairs finite on one side only (an unmappable
    pair scores inf on both, a NaN counts as a mismatch)."""
    worst, mism = 0.0, 0
    for k in ("latency", "energy", "tops_w", "area"):
        a = np.asarray(prog[k], np.float64)
        b = np.asarray(ref[k], np.float64)
        fa, fb = np.isfinite(a), np.isfinite(b)
        mism += int((fa != fb).sum())
        both = fa & fb
        gap = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), 1e-300)
        worst = max(worst, float(gap.max(initial=0.0)))
    return {"max_rel_err": {"value": worst,
                            "limit": float(limits["max_rel_err"])},
            "mask_mismatch": {"value": mism,
                              "limit": int(limits["mask_mismatch"])}}


def passed(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def check_sample(kept: List, config: Dict, seed: int):
    """Draw the checked genomes from the kept rows (from the seed), score
    them through the configuration's reference path and compare."""
    from .reference import rows as ref_rows
    allrows = {k: np.concatenate([c[k] for c in kept]) for k in kept[0]}
    n = min(int(config["check"]["genomes"]), len(allrows["genomes"]))
    pick = np.sort(np.random.default_rng([int(seed), 1]).choice(
        len(allrows["genomes"]), n, replace=False))
    prog = {k: v[pick] for k, v in allrows.items()}
    ref = ref_rows.score(prog["genomes"], config["workloads"],
                         config["reference"])
    return compare(prog, ref, config["limits"])


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             mix_override: Optional[Dict] = None,
             config_override: Optional[Dict] = None,
             bench_json: Optional[str] = None) -> Dict:
    """One run; returns the result object (the line's keys).  ``device``
    other than ``cuda`` and the overrides are for the CPU tests."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(cell_name, bench_json)
    config = {**load_config(cell), **(config_override or {})}
    cache_dirs()
    import torch
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < int(cell["chips"])):
        raise BenchError(f"cell {cell_name} needs {cell['chips']} CUDA "
                         f"device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.engine import EvalEngine

    from .reference.rows import active_rows
    from .traffic.generator import GenomeStream, load_mix

    mix = {**load_mix(cell["traffic"]), **(mix_override or {})}
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    parts = {"imports": time.perf_counter() - t0}
    engine = EvalEngine(config["workloads"],
                        config=EngineConfig(**config["engine"]),
                        device=device)
    stream = GenomeStream(mix, seed)
    parts["pool"] = time.perf_counter() - t0 - parts["imports"]
    # the warm call: first-use costs at the cell's own size, in set-up
    parts["warm_call"] = timed_call(engine, stream.next_call(), sync,
                                    None)["wall_s"]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    spans = Spans() if trace else None
    sample_rng = np.random.default_rng([int(seed), 0])
    calls, kept = [], []
    with (spans.installed() if spans else contextlib.nullcontext()), \
            GCClock().installed() as gc_clock:
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            genomes = stream.next_call()
            at = time.perf_counter() - start
            rec = timed_call(engine, genomes, sync, spans, gc_clock)
            rec["start_s"], rec["end_s"] = at, at + rec["wall_s"]
            keep_sample(kept, genomes, rec.pop("out"), sample_rng,
                        int(config["check"]["per_call"]))
            calls.append(rec)
        peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
        traced = None
        if trace:
            from .devtrace import trace_call
            traced = trace_call(torch, lambda: timed_call(
                engine, stream.next_call(), sync, None), on_card)

    record = {"calls": calls, "window_s": float(seconds),
              "setup_s": setup_s, "peak_bytes": peak,
              "rows": sum(active_rows(w) for w in config["workloads"]),
              "genomes_per_call": stream.G, "trace": traced}
    del engine, stream
    if on_card:
        torch.cuda.empty_cache()
    checks = check_sample(kept, config, seed)

    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        v = reader(m["name"]).read(record)
        if v is None:
            if not trace:
                raise BenchError(f"end-to-end metric {m['name']} has "
                                 f"nothing to read")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": passed(checks),
              "attempted": sum(c["pairs"] for c in calls),
              "failed": sum(c["nonfinite"] for c in calls)
              * len(config["workloads"]),
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    # each call's seconds, garbage-collection seconds and memo size, and
    # set-up's parts, for reading a run's course (no metric)
    result["calls_s"] = [c["wall_s"] for c in calls]
    result["calls_gc_s"] = [c["gc_s"] for c in calls]
    result["calls_memo"] = [c["memo"] for c in calls]
    result["setup_parts_s"] = parts
    result["checks"] = checks
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                          t0=t0)
    except BenchError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded forbidden modules {bad}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
