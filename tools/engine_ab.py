#!/usr/bin/env python3
"""Time the port's DSE engine (``chip_smoke.py`` phase 4's path) on one
NVIDIA GPU against another checkout.

Run from the root of a checkout:

  python3 tools/engine_ab.py --parent DIR [--genomes N] [--out PATH]
  python3 tools/engine_ab.py [--genomes N] [--out PATH]

Each checkout runs in a process of its own.  With ``--parent DIR`` (DIR:
another checkout, such as ``git archive`` of the parent commit unpacked
under ``build/``) DIR and this checkout run in turns (DIR, this, this,
DIR); without it, this checkout runs once.  A run builds an
``EvalEngine(workload_names(), EngineConfig(backend="batched",
mode="latency"))`` on the card from that checkout's sources, as phase 4
does, and scores 2 x N genomes from ``random_genomes(default_rng(0),
2 N)`` on the 20 workloads in two ``evaluate`` calls of N each (N =
1,024 by default, one micro-batch): the first cold (it also fills the
preparation cache), the second warm.  It reports each call's seconds and
candidate-workload evaluations/s, and a SHA-256 of the latency, energy
and TOPS/W arrays, so the turns show whether the two trees give the same
bits.  Each run prints one JSON line (``RESULT {...}``); ``--out``
writes them all.  Needs the card, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_checkout(root, label, n):
    """One turn: the engine of checkout ``root`` on 2 x ``n`` genomes."""
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch

    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.encoding import random_genomes
    from repro_torch.core.dse.engine import EvalEngine
    from repro_torch.core.workloads import workload_names

    names = workload_names()
    genomes = random_genomes(np.random.default_rng(0), 2 * n)
    eng = EvalEngine(names, config=EngineConfig(backend="batched",
                                                mode="latency"))
    if eng.device.type != "cuda":
        raise RuntimeError(f"engine on {eng.device}")
    out = {"label": label, "root": root, "genomes": n,
           "workloads": len(names)}
    digest = hashlib.sha256()
    for key, part in (("cold", genomes[:n]), ("warm", genomes[n:])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.evaluate(part)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[key] = {"wall_s": wall, "evals_per_s": n * len(names) / wall}
        for k in ("latency", "energy", "tops_w"):
            digest.update(np.ascontiguousarray(res[k]).tobytes())
    out["sha256"] = digest.hexdigest()
    print("RESULT " + json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout to run in turns")
    ap.add_argument("--genomes", type=int, default=1024,
                    help="genomes per evaluate call (default 1,024)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="write every result to this JSON")
    args = ap.parse_args(argv)
    if args.one:
        run_checkout(args.one, args.label, args.genomes)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("engine_ab: needs the GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.parent:
        from flash_ab import run_parent   # tools/ is this script's path
        runs = run_parent(args.parent, script=__file__,
                          extra=["--genomes", str(args.genomes)])
    else:
        runs = [run_checkout(ROOT, "this", args.genomes)]
    for key in ("cold", "warm"):
        print(key, [(r["label"], round(r[key]["evals_per_s"], 1))
                    for r in runs], flush=True)
    same = len({r["sha256"] for r in runs}) == 1
    print(f"results bit for bit equal across runs: {same}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "runs": runs, "bitwise_equal": same},
                      fh, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
