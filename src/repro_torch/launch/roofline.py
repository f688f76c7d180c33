"""Roofline analysis (a port of ``repro/launch/roofline.py``): the three
roofline terms of each (arch x shape x mesh) cell from the dry-run's
records (``launch.dryrun``).

  compute term    = flops_per_device / peak_FLOP/s
  memory term     = bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / link_bw

The dry-run counts what one device runs, so per-device values divide by
per-device rates directly.  Hardware: one NVIDIA H100 SXM per device,
with the data sheet's rates (dense, no sparsity, at its 700 W limit).
The link rate is NVLink's, which joins the eight GPUs of one node; a mesh
axis that crosses nodes runs over InfiniBand, which is slower, so the
collective term of such a cell is a lower bound.  These are data-sheet
figures, not measurements.

  PYTHONPATH=src python -m repro_torch.launch.roofline [--dir results/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

from ..models.registry import get_config
from .shapes import SHAPES

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s, H100 SXM data sheet
HBM_BW = 3.35e12         # HBM3 B/s, H100 SXM data sheet
LINK_BW = 450e9          # NVLink 4 B/s per direction (900 GB/s both ways)

__all__ = ["analyze", "load_cells", "model_flops", "PEAK_FLOPS", "HBM_BW",
           "LINK_BW"]


def model_flops(arch: str, shape: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for training;
    2*N*D (fwd only) for prefill; 2*N_active per token for decode."""
    cfg = get_config(arch)
    case = SHAPES[shape]
    n_total = cfg.param_count()
    if cfg.n_experts:
        # active params: replace full expert banks by top_k (+shared)
        f = cfg.moe_d_ff or cfg.d_ff
        moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        inactive = moe_layers * (cfg.n_experts - cfg.top_k) * 3 \
            * cfg.d_model * f
        n_active = n_total - inactive
    else:
        n_active = n_total
    tokens = case.global_batch * (1 if case.mode == "decode"
                                  else case.seq_len)
    mult = 6.0 if case.mode == "train" else 2.0
    return mult * n_active * tokens


def load_cells(dirname: str) -> List[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def analyze(rec: dict) -> Optional[dict]:
    if "skipped" in rec or "error" in rec:
        return None
    chips = rec["n_devices"]
    fl = rec["flops_per_device"]
    by = rec["bytes_per_device"]
    coll = sum(v["bytes"] for v in rec.get("collectives", {}).values())
    t_c = fl / PEAK_FLOPS
    t_m = by / HBM_BW
    t_l = coll / LINK_BW
    dominant = max(("compute", t_c), ("memory", t_m), ("collective", t_l),
                   key=lambda kv: kv[1])[0]
    mf = model_flops(rec["arch"], rec["shape"])
    hlo_global = fl * chips
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_l,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": mf / hlo_global if hlo_global else 0.0,
        "bound_s": max(t_c, t_m, t_l),
        # roofline fraction: how much of the bound is useful compute
        "roofline_frac": (mf / chips / PEAK_FLOPS) / max(t_c, t_m, t_l)
        if max(t_c, t_m, t_l) > 0 else 0.0,
        "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
        "collectives": rec.get("collectives", {}),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--md", action="store_true", help="markdown table")
    args = ap.parse_args(argv)

    rows = []
    for rec in load_cells(args.dir):
        if rec.get("mesh") != args.mesh:
            continue
        if "skipped" in rec:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "skipped": rec["skipped"]})
            continue
        if "error" in rec:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "error": rec["error"][:80]})
            continue
        rows.append(analyze(rec))

    hdr = (f"{'arch':28s} {'shape':12s} {'cmp_ms':>8s} {'mem_ms':>8s} "
           f"{'coll_ms':>8s} {'dom':>10s} {'useful':>7s} {'roofl%':>7s} "
           f"{'GiB':>6s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if r is None:
            continue
        if "skipped" in r:
            print(f"{r['arch']:28s} {r['shape']:12s} -- skipped: full "
                  f"attention")
            continue
        if "error" in r:
            print(f"{r['arch']:28s} {r['shape']:12s} !! {r['error']}")
            continue
        print(f"{r['arch']:28s} {r['shape']:12s} {r['compute_s']*1e3:8.2f} "
              f"{r['memory_s']*1e3:8.2f} {r['collective_s']*1e3:8.2f} "
              f"{r['dominant']:>10s} {r['useful_ratio']:7.3f} "
              f"{r['roofline_frac']*100:6.1f}% {r['peak_gib']:6.2f}")


if __name__ == "__main__":
    main()
