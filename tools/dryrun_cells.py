#!/usr/bin/env python3
"""Trace every architecture's ``reduced()`` config through the dry-run in
every input shape on three small fake meshes, (2, 2), (1, 1) and
(2, 2, 2), and count the cells that fail.  It checks a torch version's
DTensor against the port's dry-run route in a few minutes on one core,
without a device.

Run from the root of a checkout:

  python3 tools/dryrun_cells.py [--out PATH] [--against PATH]

The shapes are cut to 256 tokens and a batch of 32, as the tests cut
them.  ``--out`` writes each cell's record (its counts, without times or
tracebacks) as JSON; ``--against`` compares this run's records with
such a file and prints the cells whose counts differ.  Exits 1 if a
cell fails.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MESHES = [(2, 2), (1, 1), (2, 2, 2)]
COUNTS = ("flops_per_device", "bytes_per_device", "collectives", "memory")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write every cell's counts as JSON")
    ap.add_argument("--against", help="compare with an --out file")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.launch import shapes as S
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.registry import get_config, list_archs

    for k, c in list(S.SHAPES.items()):
        S.SHAPES[k] = S.ShapeCase(k, min(c.seq_len, 256),
                                  min(c.global_batch, 32), c.mode)
    recs, failed = {}, 0
    t0 = time.perf_counter()
    for arch in list_archs():
        for shape in S.SHAPES:
            for mesh in MESHES:
                r = run_cell(arch, shape, multi_pod=len(mesh) == 3,
                             cfg=get_config(arch).reduced(),
                             mesh_shape=mesh)
                key = f"{arch} {shape} {'x'.join(map(str, mesh))}"
                if "error" in r:
                    failed += 1
                    print(f"FAIL {key}: {r['error'][:300]}", flush=True)
                recs[key] = {k: r.get(k) for k in COUNTS + ("error",)}
    print(f"{len(recs)} cells, {failed} failed, in "
          f"{time.perf_counter() - t0:.1f} s (torch {torch.__version__})",
          flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(recs, fh, indent=1, sort_keys=True)
    if args.against:
        with open(args.against) as fh:
            old = json.load(fh)
        diff = [k for k in recs if recs[k] != old.get(k)]
        for k in diff:
            print(f"DIFFERS {k}: " + "; ".join(
                f"{c} {old.get(k, {}).get(c)} -> {recs[k][c]}"
                for c in COUNTS if recs[k][c] != old.get(k, {}).get(c)))
        print(f"{len(diff)} of {len(recs)} cells differ from "
              f"{args.against}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
