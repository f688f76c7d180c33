"""Perf hillclimbs (port of ``repro/launch/hillclimb.py``).

Cell mode (the original): trace ONE LM cell under a knob setting
(``launch.dryrun.run_cell`` on the fake production mesh) and report its
roofline terms at the H100's rates and its peak memory
(``launch.roofline.analyze``).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch mamba2-780m \
      --shape train_4k --set ssd_chunk=64 --tag chunk64

DSE mode: greedy single-gene hillclimb over the 12-knob genome space,
scored through any ``Evaluator`` -- the cache-aware ``EvalEngine``, a
``DSEClient`` or a ``DSECluster``.  Hillclimbing revisits neighbouring
genomes constantly (every step re-proposes mutations of the same
incumbent), so the evaluator's genome memo does most of the work: only
never-seen neighbours are simulated.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --dse \\
      --workloads resnet50_int8 kan --budget 200 --steps 24 [--device cpu]
"""
import argparse
import json
import os


def dse_hillclimb(workloads, budget_mm2: float = 200.0, steps: int = 24,
                  neighbors: int = 32, seed: int = 0, engine=None,
                  verbose: bool = False, device=None) -> dict:
    """Greedy genome hillclimb under an area budget: minimize mean energy
    across workloads.  Returns the best genome, its metrics, and the
    evaluator's cache stats.  Without ``engine`` it builds the default
    (scan) ``EvalEngine`` on ``device`` (the card unless ``"cpu"`` is
    asked for); the walk itself is host numpy, so ``device`` plays no
    other part."""
    import numpy as np

    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.encoding import (GENOME_LEN, genome_bounds,
                                               random_genomes)
    from repro_torch.core.dse.engine import EvalEngine

    if not workloads:
        raise ValueError("dse_hillclimb needs at least one workload")
    engine = (engine.check_workloads(workloads) if engine is not None
              else EvalEngine(workloads, config=EngineConfig(),
                              device=device))
    rng = np.random.default_rng(seed)
    bounds = genome_bounds()

    def keep(areas):
        return areas <= budget_mm2

    def score(m):
        # mean energy over workloads; inf for unmappable / over-budget.
        # The explicit area guard matters with a shared engine: a genome
        # memoized by an earlier unfiltered search bypasses the keep
        # predicate and would otherwise return its real (finite) energy.
        e = m["energy"].mean(axis=1)
        return np.where(m["area"] <= budget_mm2, e, np.inf)

    starts = random_genomes(rng, max(neighbors, 8))
    m = engine.evaluate(starts, keep=keep)
    s = score(m)
    best_i = int(np.argmin(s))
    cur, cur_s = starts[best_i].copy(), float(s[best_i])

    for step in range(steps):
        cand = np.repeat(cur[None, :], neighbors, axis=0)
        genes = rng.integers(0, GENOME_LEN, neighbors)
        delta = rng.choice([-1, 1], neighbors)
        for r in range(neighbors):
            g = genes[r]
            cand[r, g] = np.clip(cand[r, g] + delta[r], 0, bounds[g] - 1)
        m = engine.evaluate(cand, keep=keep)
        s = score(m)
        i = int(np.argmin(s))
        if s[i] < cur_s:
            cur, cur_s = cand[i].copy(), float(s[i])
        if verbose:
            print(f"[dse-hillclimb] step {step}: best_energy={cur_s:.3e}pJ "
                  f"hit_rate={engine.stats.hit_rate():.0%}")
    if not np.isfinite(cur_s):
        raise ValueError(
            f"no mappable design found within budget {budget_mm2} mm^2 "
            f"after {steps} steps -- raise the budget or the step count")
    final = engine.evaluate(cur[None, :])
    return {
        "best_genome": cur.tolist(),
        "mean_energy_pj": cur_s,
        "area_mm2": float(final["area"][0]),
        "per_workload_latency_s": final["latency"][0].tolist(),
        "workloads": list(workloads),
        "cache_hit_rate": engine.stats.hit_rate(),
        "evaluator_throughput_cfg_wl_per_s": engine.stats.throughput(),
    }


def _parse_knobs(pairs):
    kw = {}
    for kv in pairs:
        k, v = kv.split("=")
        kw[k] = (v == "true") if v in ("true", "false") else \
            (int(v) if v.isdigit() else v)
    return kw


def _main_cell(args, cfg=None):
    """``cfg`` replaces ``get_config(args.arch)`` (the tests pass a
    ``reduced()`` config)."""
    from repro_torch.launch import tuning
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import analyze

    kw = _parse_knobs(args.set)
    tuning.set_knobs(**kw)
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, cfg=cfg)
    finally:
        tuning.set_knobs()
    rec["knobs"] = kw
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.arch}_{args.shape}_{args.tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if "error" in rec:
        print("FAIL:", rec["error"][:300])
        raise SystemExit(1)
    if "skipped" in rec:
        print("SKIPPED:", rec["skipped"])
        return rec
    a = analyze(rec)
    print(json.dumps({
        "tag": args.tag, "knobs": kw,
        "compute_ms": round(a["compute_s"] * 1e3, 2),
        "memory_ms": round(a["memory_s"] * 1e3, 2),
        "collective_ms": round(a["collective_s"] * 1e3, 2),
        "dominant": a["dominant"],
        "roofline_frac_pct": round(a["roofline_frac"] * 100, 2),
        "useful_ratio": round(a["useful_ratio"], 3),
        "peak_gib": round(a["peak_gib"], 2),
    }, indent=1))
    return rec


def _main_dse(args):
    out = dse_hillclimb(args.workloads, budget_mm2=args.budget,
                        steps=args.steps, seed=args.seed, verbose=True,
                        device=args.device)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"dse_hillclimb_{args.tag}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in
                      ("mean_energy_pj", "area_mm2", "cache_hit_rate",
                       "evaluator_throughput_cfg_wl_per_s")}, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dse", action="store_true",
                    help="genome hillclimb through the DSE EvalEngine")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", nargs="*", default=[],
                    help="knob=value pairs (act_mode, ssd_chunk, "
                         "moe_dispatch_bf16, microbatches)")
    ap.add_argument("--workloads", nargs="*",
                    default=["resnet50_int8", "kan"])
    ap.add_argument("--budget", type=float, default=200.0)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the engine's device (default: the card; 'cpu' "
                         "on a machine without one)")
    ap.add_argument("--tag", default="variant")
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args(argv)
    if args.dse:
        _main_dse(args)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required without --dse")
        _main_cell(args)


if __name__ == "__main__":
    main()
