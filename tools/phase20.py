#!/usr/bin/env python3
"""Run phase 20 of ``chip_smoke.py`` (the scan engine and the link
fidelity tier) alone on one NVIDIA GPU.

Run from the root of a checkout:

  python3 tools/phase20.py [--cpu] [--out PATH]

Phase 20 reads the rows of phases 4, 6 and 7 and the rates of phases 4
and 17.  This script computes those rows first, phase 4's and 6's with
the exact engine (bit for bit the batched one, phase 17), on the first
``SCAN_POPULATION`` and 256 genomes only; the rate it passes as phase
4's is that of this exact run, and phase 17's rates are not measured
(printed as nan).
Then it calls ``chip_smoke._scan_link_phase``; ``--out`` writes the
phase's record as JSON.  ``--cpu`` rehearses the same on the CPU
at 8 genomes on three workloads (``torch.cuda.synchronize``, the device
and the sizes patched); its times are not device numbers.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.core.dse import engine as E  # noqa: E402
from repro_torch.core.dse.api import EngineConfig  # noqa: E402
from repro_torch.core.dse.encoding import random_genomes  # noqa: E402
from repro_torch.core.workloads import workload_names  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at 8 genomes")
    ap.add_argument("--out", help="write the phase's record to this JSON")
    args = ap.parse_args(argv)
    if args.cpu:
        import repro_torch.core.workloads as W
        torch.cuda.synchronize = lambda *a: None
        cs.DEVICE = "cpu"
        real = E.resolve_device
        E.resolve_device = lambda d=None: real("cpu" if d is None else d)
        cs.SCAN_POPULATION, cs.SCAN_THROUGHPUT_POPULATION = 8, 8
        cs.LINK_POPULATION, cs.PARITY_POPULATION = 8, 8
        cs.ORACLE_RESCORE_POPULATION = 4
        names = ["kan", "snn_vgg9", "resnet50_int8"]
        W.workload_names = lambda: names
    else:
        if not torch.cuda.is_available():
            print("phase20: no CUDA device", file=sys.stderr)
            return 2
        print(cs._card_line(), flush=True)
        names = workload_names()
    dev = torch.device(cs.DEVICE)
    t0 = time.perf_counter()
    genomes = random_genomes(np.random.default_rng(0),
                             cs.POPULATION)[:cs.SCAN_POPULATION]
    res4 = E.EvalEngine(names, config=EngineConfig(
        backend="exact")).evaluate(genomes)
    wall4 = time.perf_counter() - t0
    g1 = random_genomes(np.random.default_rng(1), cs.THROUGHPUT_POPULATION)
    g1 = g1[:cs.SCAN_THROUGHPUT_POPULATION]
    rt = E.EvalEngine(cs.THROUGHPUT_WORKLOADS, config=EngineConfig(
        backend="exact", mode="throughput")).evaluate(g1)
    g2 = random_genomes(np.random.default_rng(2), cs.PARITY_POPULATION)
    card_rows = {m: E.EvalEngine(cs.PARITY_WORKLOADS, config=EngineConfig(
        backend="batched", mode=m)).evaluate(g2)
        for m in ("latency", "throughput")}
    print(f"inputs in {time.perf_counter() - t0:.1f} s", flush=True)
    record = {"main_path": {"evals_per_s": len(genomes) * len(names) / wall4},
              "exact": {"evals_per_s": float("nan"),
                        "throughput_evals_per_s": float("nan")}}
    t0 = time.perf_counter()
    out = cs._scan_link_phase(torch, np, dev, genomes, res4, g1, rt, g2,
                              card_rows, record)
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 20 in {out['phase_s']:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
