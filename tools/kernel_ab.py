#!/usr/bin/env python3
"""Time the port's ``dse_eval`` and ``horner`` kernels on one NVIDIA GPU
against another checkout, and show what the compiler made of them.

Run from the root of a checkout:

  python3 tools/kernel_ab.py --parent DIR [--out PATH]
  python3 tools/kernel_ab.py [--out PATH]

Each checkout runs in a process of its own.  With ``--parent DIR`` (DIR:
another checkout, such as ``git archive`` of the parent commit unpacked
under ``build/``) DIR and this checkout run in turns (DIR, this, this,
DIR); without it, this checkout runs once.  A run builds the two kernels
from that checkout's sources and measures:

* ``dse_eval`` over ``chip_smoke.py`` phase 3's launches (4,096 genomes
  from ``default_rng(0)``, the op groups of the 20 workloads as that
  checkout's ``pack_launches`` packs them): CUDA-event ms of the whole
  pass (mean of 20) and torch.profiler's device ms of the kernel per pass
  (5 passes), and whether the seconds and the energy equal the plain
  version's bit for bit;
* ``horner`` at phase 13's shape (25.7 M elements, degree 8) in float32
  and bfloat16: CUDA-event ms (mean of 20) and device ms;
* what ``ptxas -v`` reported for each kernel (registers, spill bytes),
  and the loops of ``dse_eval``'s SASS (``cuobjdump --dump-sass``: each
  backward branch and the instructions it spans, with the count of
  MUFU.RCP, the reciprocal of an IEEE division, among them).

The timing and the launches are this checkout's ``chip_smoke.py``
(``_time_ms``, ``_device_ms``, ``dse_launches``) in every turn; the
kernels, their wrappers and ``pack_launches`` are the checkout's own.
Each run prints one JSON line (``RESULT {...}``); ``--out`` writes them
all.  Needs the card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ptxas(log):
    """{kernel: {registers, spill_stores, spill_loads}} from ptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m[1]),
                                            spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m[1])
    return out


def _sass_loops(nvcc, lib):
    """The loops of each kernel in ``lib``'s SASS: for every backward
    branch, the instructions from its target to it."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    kernels, name, ins = {}, None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name, ins = m.group(1), []
            kernels[name] = ins
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            ins.append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, ins in kernels.items():
        loops = []
        for addr, text in ins:
            m = re.search(r"\bBRA(?:\.\w+)*\s+0x([0-9a-f]+)", text)
            if m is None:
                continue
            target = int(m.group(1), 16)
            if target < addr:
                body = [t for a, t in ins if target <= a <= addr]
                loops.append({"from": hex(target), "to": hex(addr),
                              "instructions": len(body),
                              "mufu_rcp": sum("MUFU.RCP" in t for t in body)})
        out[name] = {"instructions": len(ins), "loops": loops}
    return out


def run_checkout(root, label):
    """In this process: the two kernels of the checkout at ``root``."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs          # puts this checkout's src/ first
    sys.path.insert(0, os.path.join(root, "src"))
    os.chdir(root)
    import numpy as np
    import torch

    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda")
    build_s = _build.build_all(["dse_eval", "horner"])
    res = {"label": label, "root": root, "build_s": build_s}

    launches = cs.dse_launches(np, dev)[3]
    equal = {"seconds": True, "energy": True}
    for _, tiles, o in launches:
        got, want = ops.dse_eval(tiles, o), ref.dse_eval_ref(tiles, o)
        for i, key in enumerate(equal):
            equal[key] &= bool(torch.equal(got[..., i], want[..., i]))

    def run_dse():
        for _, tiles, o in launches:
            ops.dse_eval(tiles, o)

    def timed(fn, reps, match):
        names, dev_ms, sessions = cs._device_ms(torch, fn, reps, match)
        return {"ms": cs._time_ms(torch, fn, 20), "device_ms": dev_ms,
                "device_ms_by_name": names, "profiler_sessions": sessions}

    res["dse_eval"] = {"launches": len(launches),
                       **{f"{k}_bitwise": v for k, v in equal.items()},
                       **timed(run_dse, 5, "dse_eval")}
    g = torch.Generator(device=dev).manual_seed(13)
    cf = torch.randn((cs.KAN_DEGREE + 1,), generator=g, device=dev)
    x32 = torch.randn((cs.KAN_ELEMENTS,), generator=g, device=dev)
    for name, x in (("float32", x32), ("bfloat16", x32.to(torch.bfloat16))):
        res[f"horner_{name}"] = {
            "bitwise": bool(torch.equal(ops.horner(x, cf),
                                        ref.horner_ref(x, cf))),
            **timed(lambda: ops.horner(x, cf), 20, "horner")}
    res["ptxas"] = {n: _ptxas(_build.build_log(n))
                    for n in ("dse_eval", "horner")}
    res["dse_eval_sass"] = _sass_loops(_build._nvcc(),
                                       _build.library_path("dse_eval"))
    print("RESULT " + json.dumps(res), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout to run in turns")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="write every result to this JSON")
    args = ap.parse_args(argv)
    if args.one:
        run_checkout(args.one, args.label)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs the GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if args.parent:
        from flash_ab import run_parent   # tools/ is this script's path
        runs = run_parent(args.parent, script=__file__)
    else:
        runs = [run_checkout(ROOT, "this")]
    record = {"card": card, "runs": runs}
    for key in ("dse_eval", "horner_float32", "horner_bfloat16"):
        print(key, [(r["label"], r[key]["ms"], r[key]["device_ms"])
                    for r in runs], flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
