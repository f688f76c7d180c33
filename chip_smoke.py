#!/usr/bin/env python3
"""Drive the PyTorch port of MOSAIC on one NVIDIA GPU and check it.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases (each prints one ``[n name]`` line; any failure raises and the
script exits non-zero without printing a result):

1. card      -- the card's name and power limit from ``nvidia-smi``;
2. build     -- compiles the hand-written CUDA ``dse_eval`` kernel from
                ``src/repro_torch/csrc/dse_eval.cu`` (``nvcc``, ``sm_90a``);
3. kernel    -- the kernel against its plain PyTorch version on the card,
                at the main path's shapes (4,096 genomes x the op rows of
                all 20 workloads) and on the no-hostable-tile case, with
                tests/test_kernels.py's tolerances; times both with CUDA
                events and computes the kernel's bound;
4. main path -- ``EvalEngine(workload_names(), EngineConfig(
                backend="batched", mode="latency"))`` on ``cuda`` scores
                4,096 random genomes on the 20 workloads, then again
                (all memo hits);
5. prefilter -- ``roofline_bounds`` on the same 4,096 x 20 (the kernel's
                caller).  Phases 4 and 5 are the main path: the launch
                counters are zeroed just before phase 4 and read just
                after phase 5, and the kernel must have launched;
6. throughput-- the engine in throughput mode, 4 workloads x 1,024;
7. card vs CPU -- the same engine on ``cpu`` and on ``cuda`` for 64 genomes
                x 3 workloads in both modes (ok masks equal, metrics within
                rel 1e-9), and the port on ``hetero_bls()`` against the
                golden traces in tests/golden (rtol 1e-6).

Then one JSON line describing the kernel (times, launches, bound) and, as
the last line, ``{"ok": true, "device": {...}}``.  ``--out PATH`` also
writes every number to a JSON file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate.
# (Both assume the full 700 W power limit.)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

DEVICE = "cuda"
POPULATION = 4096
THROUGHPUT_POPULATION = 1024
PARITY_POPULATION = 64
THROUGHPUT_WORKLOADS = ["kan", "resnet50_int8", "hyena_1_3b",
                        "llama7b_int4"]
PARITY_WORKLOADS = ["kan", "resnet50_int8", "hyena_1_3b"]
GOLDEN_WORKLOADS = ["resnet50_int8", "vit_b16_fp16", "llama7b_int4",
                    "snn_vgg9", "hyena_1_3b", "kan"]

# fp32 operations the kernel's formula needs per (candidate, op, tile
# slot), by the op's class (src/repro_torch/csrc/dse_eval.cu):
#   common to every class: bw / clock, max(., 1e-9), bytes / that,
#     max(c_cmp, c_bw), / clock, exists > 0, the ok conjunction, the inf
#     select, the running-min compare                                  = 9
#   MAC: num_macs > 0, prec_ok > 0, and, num_macs * eta, max, divide,
#     select, mac_ok | dsp_ok, lanes > 0                               = 9
#   DSP: max(lanes, 1), divide, ceil, * sqrt-term, lanes > 0          = 5
#   SPECIAL: divide + floor (mask / kind), fmod, compare, max(par, 1),
#     divide, max(lanes, 1), divide, ceil, select, lanes > 0         = 11
# plus, per (candidate, op), the energy multiply-add (2).
_SLOT_OPS = {0: 9 + 9, 1: 9 + 5, 2: 9 + 11}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _phase(n, name, text):
    print(f"[{n} {name}] {text}", flush=True)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0].strip()


def _time_ms(torch, fn, reps):
    """Mean ms of ``fn()`` over ``reps`` runs, CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare_bounds(np, got, want):
    """tests/test_kernels.py::test_dse_eval's tolerances; returns (max rel
    err of finite seconds, max abs err over finite entries)."""
    fin = np.isfinite(want[..., 0])
    check(np.array_equal(fin, np.isfinite(got[..., 0])),
          "kernel and plain version disagree on which ops are hostable")
    gs, ws = got[..., 0][fin].astype(np.float64), \
        want[..., 0][fin].astype(np.float64)
    rel = np.abs(gs - ws) / np.maximum(np.abs(ws), 1e-30)
    check(rel.max(initial=0.0) <= 1e-5,
          f"kernel seconds off by rel {rel.max():.3e} (> 1e-5)")
    ge, we = got[..., 1].astype(np.float64), want[..., 1].astype(np.float64)
    check(np.all(np.abs(ge - we) <= 1.0 + 1e-4 * np.abs(we)),
          "kernel energy outside rtol 1e-4 / atol 1.0")
    abs_err = max(float(np.abs(gs - ws).max(initial=0.0)),
                  float(np.abs(ge - we).max(initial=0.0)))
    return float(rel.max(initial=0.0)), abs_err


def _profile_micro_batch(torch, np, genomes, dev):
    """Trace one engine micro-batch: ``map_and_simulate`` of resnet50_int8
    on 1,024 genomes.  Returns wall seconds with and without the profiler,
    the summed device time of the kernels, their count and the top five."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compiler.batched_mapper import map_and_simulate
    from repro_torch.core.dse.engine import genomes_to_configs, \
        prepared_workload
    from repro_torch.core.simulator.batched import place_configs

    ws = prepared_workload("resnet50_int8")
    cfgs = genomes_to_configs(genomes[:1024])
    placed = place_configs(cfgs, dev)

    def run():
        map_and_simulate(ws, cfgs, device=dev, placed=placed,
                         placements=False)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0
    dev_us, n_kernels, per_name = 0.0, 0, {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            us = float(e.time_range.elapsed_us())
            dev_us += us
            n_kernels += 1
            per_name[e.name] = per_name.get(e.name, 0.0) + us
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    out = {"wall_s": plain_wall, "profiled_wall_s": prof_wall,
           "device_busy_s": dev_us / 1e6, "device_kernels": n_kernels,
           "busy_share_of_profiled_wall": dev_us / 1e6 / prof_wall,
           "top_kernels_us": top}
    _phase("4b", "profile", json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one engine micro-batch (resnet50_int8, "
                         "1,024 genomes) with torch.profiler: device busy "
                         "share and the kernels that take the time")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "GPU", file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch.core.arch import hetero_bls
    from repro_torch.core.compiler.batched_mapper import map_and_simulate
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.encoding import random_genomes
    from repro_torch.core.dse.engine import (EvalEngine, genomes_to_configs,
                                             prepared_workload)
    from repro_torch.core.dse.prefilter import pack_launches, roofline_bounds
    from repro_torch.core.simulator.batched import (place_configs,
                                                    stack_chip_configs)
    from repro_torch.core.workloads import workload_names
    from repro_torch.kernels import dse_eval as kbuild
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    record = {}

    # ---- 1. card -----------------------------------------------------------
    card = _card_line()
    print(card, flush=True)
    record["card"] = card
    kind = torch.cuda.get_device_name(0)
    _phase(1, "card", f"{card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")

    # ---- 2. build ----------------------------------------------------------
    build_s = kbuild.build_seconds()
    record["build_s"] = build_s
    _phase(2, "build", f"dse_eval built and loaded in {build_s:.3f} s "
           f"({' '.join(kbuild.NVCC_FLAGS)})")

    # ---- 3. kernel against its plain version -------------------------------
    names = workload_names()
    genomes = random_genomes(np.random.default_rng(0), POPULATION)
    cfgs = genomes_to_configs(genomes)
    placed = place_configs(cfgs, dev)
    launches = []
    for w in names:
        launches += pack_launches(cfgs, prepared_workload(w), device=dev,
                                  placed=placed)
    max_rel, max_abs = 0.0, 0.0
    for _, tiles, ops in launches:
        got = kops.dse_eval(tiles, ops)
        want = kref.dse_eval_ref(tiles, ops)
        torch.cuda.synchronize()
        r, a = _compare_bounds(np, got.cpu().numpy(), want.cpu().numpy())
        max_rel, max_abs = max(max_rel, r), max(max_abs, a)
    # no tile can host the ops: inf seconds, energy from tile 0 (ref.py)
    nt = torch.zeros((2, 4, kref.TILE_FIELDS), dtype=torch.float32,
                     device=dev)
    nt[..., 3] = 1e9
    nt[..., 8] = torch.tensor([1.5, 2.0, 3.0, 4.0], device=dev)
    nt[1, :, 0] = 1.0
    no = torch.tensor([[0, 1000, 10, 100, 1, 1, 0], [1, 0, 50, 100, 1, 1, 0]],
                      dtype=torch.float32, device=dev)
    edge = kops.dse_eval(nt, no).cpu().numpy()
    check(np.isinf(edge[..., 0]).all(), "no-hostable case: seconds not inf")
    check(np.allclose(edge[..., 1], [[1505.0, 25.0]] * 2, rtol=1e-6),
          f"no-hostable case: energy {edge[..., 1].tolist()}")

    def run_kernel():
        for _, tiles, ops in launches:
            kops.dse_eval(tiles, ops)

    def run_plain():
        for _, tiles, ops in launches:
            kref.dse_eval_ref(tiles, ops)

    kernel_ms = _time_ms(torch, run_kernel, 20)
    plain_ms = _time_ms(torch, run_plain, 3)
    n_bytes = sum(t.numel() * 4 + o.numel() * 4 + t.shape[0] * o.shape[0] * 8
                  for _, t, o in launches)
    n_ops = 0
    for _, t, o in launches:
        B, T = t.shape[0], t.shape[1]
        cls = o[:, 0].long().cpu().numpy()
        n_ops += B * T * sum(_SLOT_OPS[int(c)] for c in cls) \
            + B * len(cls) * 2
    bytes_ms = n_bytes / PEAK_HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    record["kernel"] = {
        "launches_per_suite": len(launches), "max_rel_err_seconds": max_rel,
        "max_abs_err": max_abs, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
        "fp32_ops": n_ops}
    _phase(3, "kernel", f"{len(launches)} launches over 20 workloads x "
           f"{POPULATION} genomes: max rel err (seconds) {max_rel:.3e}, "
           f"max abs err {max_abs:.6g}; kernel {kernel_ms:.4f} ms, plain "
           f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
           f"{n_ops:.4g} fp32 ops at {PEAK_FP32_FLOPS:.3g}/s, "
           f"{n_bytes:.4g} B at {PEAK_HBM_BYTES_PER_S:.3g} B/s, H100 SXM "
           f"data sheet); library: none (no single PyTorch call computes "
           f"this function)")

    # ---- 4. main path: the engine ------------------------------------------
    kops.reset_launch_counts()
    eng = EvalEngine(names, config=EngineConfig(backend="batched",
                                                mode="latency"))
    check(eng.device.type == DEVICE, f"engine on {eng.device}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.evaluate(genomes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat = res["latency"]
    check(lat.shape == (POPULATION, len(names)), f"latency shape {lat.shape}")
    for k in ("latency", "energy", "tops_w", "area"):
        check(not np.isnan(res[k]).any(), f"NaN in {k}")
    fin = np.isfinite(lat)
    check(fin.mean() > 0.5, f"finite share {fin.mean():.3f}")
    check((lat[fin] > 0).all() and (res["energy"][fin] > 0).all(),
          "non-positive latency or energy")
    evals = POPULATION * len(names) / wall
    record["main_path"] = {"wall_s": wall, "evals_per_s": evals,
                           "finite_share": float(fin.mean()),
                           "meta": res["meta"]}
    _phase(4, "main path", f"EvalEngine batched/latency on {eng.device}: "
           f"{POPULATION} genomes x {len(names)} workloads in {wall:.3f} s = "
           f"{evals:.1f} candidate-workload evaluations/s; finite share "
           f"{fin.mean():.4f}; meta {json.dumps(res['meta'])}")

    if args.profile:
        record["profile"] = _profile_micro_batch(torch, np, genomes, dev)

    # ---- 5. prefilter (the kernel's caller), same candidates ---------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bounds = {w: roofline_bounds(cfgs, prepared_workload(w), device=dev,
                                 placed=placed) for w in names}
    torch.cuda.synchronize()
    pre_wall = time.perf_counter() - t0
    main_launches = dict(kops.launch_counts)       # read just after
    check(main_launches["dse_eval"] > 0,
          "the main path never launched the dse_eval kernel")
    check(main_launches["dse_eval"] == len(launches),
          f"{main_launches['dse_eval']} launches, expected {len(launches)}")
    above, pairs = 0, 0
    for j, w in enumerate(names):
        sb = bounds[w][..., 0].double().sum(dim=1).cpu().numpy()
        ok = np.isfinite(lat[:, j])
        above += int((sb[ok] > lat[ok, j]).sum())
        pairs += int(ok.sum())
    share_above = above / max(pairs, 1)
    record["prefilter"] = {"wall_s": pre_wall, "launches": main_launches,
                           "share_bound_above_latency": share_above}
    again = eng.evaluate(genomes)
    check(again["meta"]["hits"] == POPULATION and
          again["meta"]["misses"] == 0, f"second call meta {again['meta']}")
    check(np.array_equal(again["latency"], lat), "memo hit changed latency")
    _phase(5, "prefilter", f"roofline_bounds over {POPULATION} x "
           f"{len(names)}: {pre_wall:.3f} s wall incl. packing, "
           f"{main_launches['dse_eval']} dse_eval launches in the main-path "
           f"run (kernel time for these launches: {kernel_ms:.4f} ms, "
           f"phase 3); summed per-op bound > exact latency in "
           f"{share_above:.4f} of {pairs} finite pairs (information only); "
           f"second evaluate: {again['meta']['hits']} hits")

    # ---- 6. throughput mode ------------------------------------------------
    g1 = random_genomes(np.random.default_rng(1), THROUGHPUT_POPULATION)
    eng_t = EvalEngine(THROUGHPUT_WORKLOADS,
                       config=EngineConfig(backend="batched",
                                           mode="throughput"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt = eng_t.evaluate(g1)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    fin_t = np.isfinite(rt["latency"])
    check(not np.isnan(rt["latency"]).any() and fin_t.mean() > 0.5,
          f"throughput finite share {fin_t.mean():.3f}")
    evals_t = len(g1) * len(THROUGHPUT_WORKLOADS) / wall_t
    record["throughput"] = {"wall_s": wall_t, "evals_per_s": evals_t,
                            "finite_share": float(fin_t.mean())}
    _phase(6, "throughput", f"EvalEngine batched/throughput: {len(g1)} x "
           f"{len(THROUGHPUT_WORKLOADS)} in {wall_t:.3f} s = "
           f"{evals_t:.1f} evaluations/s; finite share "
           f"{fin_t.mean():.4f}; meta {json.dumps(rt['meta'])}")

    # ---- 7. card against CPU, and the golden traces ------------------------
    g2 = random_genomes(np.random.default_rng(2), PARITY_POPULATION)
    worst, rows_equal, rows = 0.0, 0, 0
    for mode in ("latency", "throughput"):
        cfg = EngineConfig(backend="batched", mode=mode)
        on_card = EvalEngine(PARITY_WORKLOADS, config=cfg).evaluate(g2)
        on_cpu = EvalEngine(PARITY_WORKLOADS, config=cfg,
                            device="cpu").evaluate(g2)
        check(np.array_equal(np.isfinite(on_card["latency"]),
                             np.isfinite(on_cpu["latency"])),
              f"{mode}: ok masks differ between card and CPU")
        same = np.ones(len(g2), bool)
        for k in ("latency", "energy", "tops_w"):
            a, b = on_card[k], on_cpu[k]
            f = np.isfinite(b)
            check(np.array_equal(f, np.isfinite(a)), f"{mode} {k} mask")
            err = np.abs(a[f] - b[f]) / np.maximum(np.abs(b[f]), 1e-300)
            worst = max(worst, float(err.max(initial=0.0)))
            same &= (a == b).all(axis=1)
        rows_equal += int(same.sum())
        rows += len(g2)
    check(worst <= 1e-9, f"card vs CPU rel err {worst:.3e} > 1e-9")
    golden_worst = 0.0
    chip = stack_chip_configs([hetero_bls()])
    for w in GOLDEN_WORKLOADS:
        r = map_and_simulate(prepared_workload(w), chip, device=dev)
        check(bool(r["ok"][0]), f"golden {w}: unmappable")
        for suffix in ("", "_throughput"):
            with open(os.path.join(ROOT, "tests", "golden",
                                   f"{w}{suffix}.json")) as fh:
                g = json.load(fh)
            pairs_g = [(r["latency_s"][0], g["latency_s"]),
                       (r["energy_pj"][0], g["energy_pj"]),
                       (r["area_mm2"][0], g["area_mm2"])]
            pairs_g += [(r[f"energy_{m}_pj"][0], v) for m, v in
                        g["energy_breakdown"].items() if m != "total"]
            pairs_g += [(r[k][0], v) for k, v in
                        (g.get("pipeline") or {}).items()]
            for got_v, want_v in pairs_g:
                check(np.isclose(got_v, want_v, rtol=1e-6, atol=1e-12),
                      f"golden {w}{suffix}: {got_v!r} vs {want_v!r}")
                golden_worst = max(golden_worst, abs(got_v - want_v)
                                   / max(abs(want_v), 1e-300))
    record["card_vs_cpu"] = {"max_rel_err": worst, "rows_bitwise": rows_equal,
                             "rows": rows, "golden_max_rel_err": golden_worst}
    _phase(7, "card vs CPU", f"{len(g2)} genomes x {len(PARITY_WORKLOADS)} "
           f"workloads x 2 modes: ok masks equal, max rel err {worst:.3e} "
           f"(limit 1e-9), {rows_equal}/{rows} rows bitwise; golden traces "
           f"({len(GOLDEN_WORKLOADS)} workloads x 2 modes on cuda) max rel "
           f"err {golden_worst:.3e} (limit 1e-6)")

    kernels = [{
        "name": "dse_eval", "route": "cuda",
        "source": "src/repro_torch/csrc/dse_eval.cu",
        "replaces": "src/repro/kernels/dse_eval.py:79",
        "launches": main_launches["dse_eval"], "max_abs_err": max_abs,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]
    record["total_s"] = time.perf_counter() - t_start
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1, default=float)
    print(f"total {record['total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
