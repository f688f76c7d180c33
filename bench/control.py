"""Readings that set the limits of the check, and its lower-precision
control.

    python3 bench/control.py --workload <cell> --seeds 11 12 13

For each seed: the cell's traffic draws its first measured call (the
genomes that a run's window starts with, at the cell's own size G); the
program scores them through its engine (``EvalEngine.evaluate``); the
check's sample is drawn from the call as a run draws it and scored by
the configuration's plain reference (``reference/rows.py``) in float64,
and by the control: the same reference, put in the program's place and
computed in float32, the nearest precision below the configuration's.
One JSON line per seed: ``program`` and ``control``, each the check's
numbers against the float64 reference.  A sound program reads below the
limits and the control above one of them.  The benchmark's own runs
never run this.

``readings`` is also what ``bench/test_bench_harness.py`` runs at a size
a CPU test can hold.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

import numpy as np

KEYS = ("latency", "energy", "tops_w", "area")


def readings(cell_name: str, seed: int, device: str = "cuda",
             mix_override=None, config_override=None) -> Dict:
    """The program's and the control's check numbers on one seed."""
    import torch

    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.engine import EvalEngine

    from . import harness
    from .reference import rows as ref_rows
    from .traffic.generator import GenomeStream, load_mix

    cell = harness.load_cell(cell_name)
    config = {**harness.load_config(cell), **(config_override or {})}
    mix = {**load_mix(cell["traffic"]), **(mix_override or {}),
           "pool_calls": 2}
    stream = GenomeStream(mix, seed)
    stream.next_call()                      # a run's warm call
    genomes = stream.next_call()            # its window's first call
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    engine = EvalEngine(config["workloads"],
                        config=EngineConfig(**config["engine"]),
                        device=device)
    prog = engine.evaluate(genomes)
    sync()
    t1 = time.perf_counter()
    rng = np.random.default_rng([int(seed), 0])
    n = min(int(config["check"]["genomes"]), len(genomes))
    idx = np.sort(rng.choice(len(genomes), n, replace=False))
    how, wl = config["reference"], config["workloads"]
    ref = ref_rows.score(genomes[idx], wl, how, "float64")
    t2 = time.perf_counter()
    ctrl = ref_rows.score(genomes[idx], wl, how, "float32")
    t3 = time.perf_counter()
    return {"cell": cell_name, "seed": seed, "genomes": len(genomes),
            "checked": n,
            "program": harness.compare(
                {k: np.asarray(prog[k])[idx] for k in KEYS}, ref,
                config["limits"]),
            "control": harness.compare(ctrl, ref, config["limits"]),
            "seconds": {"program": t1 - t0, "reference": t2 - t1,
                        "control": t3 - t2}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for s in a.seeds:
        print(json.dumps(readings(a.workload, s)), flush=True)
    return 0


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0:1] = [root, os.path.join(root, "src")]
    from bench.control import main as _main
    sys.exit(_main())
