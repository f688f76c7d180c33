"""Roofline lower bounds for the candidates and workloads the engine scores.

The one caller of the ``dse_eval`` kernel (``kernels.ops.dse_eval``).  The
reference package names that kernel as the sweep's pre-filter but never
calls it; here ``roofline_bounds`` computes the myopic bound -- Eq. 2 per
op in isolation on its best tile -- for the config stack the engine
builds (``engine.genomes_to_configs``) and a prepared workload.  It
computes and reports the bound; it prunes nothing and changes no engine
metric.  The bound is an optimistic model of its own, not guaranteed to
lie below ``costs.py``'s exact latency.

Field sources.  Tile row (per candidate, per tile slot), from the same
quantities ``CostModel`` reads:

* ``exists``, ``num_macs``, ``dsp_lanes``, ``clock_hz``, ``sfu_mask``,
  ``sfu_par`` (``sfu_parallel``): the config stack, as they are.
* ``eta``: ``CostModel.eta`` of the tile's sparsity mode at the group's
  activation / weight sparsity -- exact, because each launch covers ops
  of one (precision, act_sparsity, w_sparsity) group.
* ``prec_ok``: ``CostModel.supports_precision`` at the group's precision
  (asymmetric-MAC variants included) -- exact for the group.
* ``e_mac_pj``: ``CostModel.mac_energy_pj`` at the group's precision
  (datapath residual and engine multiplier included).
* ``bw_bytes_per_s``: the chip's whole DRAM bandwidth,
  ``dram_gbps * 1e9``.  The engine's mapper estimates with
  ``dram_gbps / n_tiles``; the whole bandwidth keeps the bound
  optimistic.

Op row (per active op: valid and not fused away; fused children run
inside their head's post-processing module and are not bounded apart):

* ``op_cls``, ``macs``, ``elems``, ``seq_len``: the op table.
* ``bytes_total``: ``bytes_in + bytes_w + bytes_out``.
* ``sfu_kind``: ``costs.SFU_NEED[op_type]``, the SFU-mask bit the op
  needs.
* ``sfu_n``: ``fft_n`` (0 for ops other than FFT).  The kernel's native
  SFU cost is ``elems * log2(max(sfu_n, 2)) / sfu_par``; for LIF and
  polynomial ops (timesteps, degree >= 1) that lies below the cost model's
  native cost, which keeps the bound optimistic.

Rows the kernel does not see (padding, fused) are 0 in the result.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...device import F64, resolve_device
from ...kernels import ops as kops
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..simulator.batched import place_configs
from ..simulator.costs import SFU_NEED, cost_model

__all__ = ["roofline_bounds", "pack_launches"]

F32 = torch.float32


def _active_rows(ws: Dict[str, np.ndarray]) -> np.ndarray:
    return np.flatnonzero((ws["valid"] > 0) & (ws["fused"] == 0))


def pack_launches(cfgs: Dict[str, Dict[str, np.ndarray]],
                  ws: Dict[str, np.ndarray],
                  calib: CalibrationTable = DEFAULT_CALIB,
                  device=None, placed=None
                  ) -> List[Tuple[np.ndarray, torch.Tensor, torch.Tensor]]:
    """The kernel inputs for one workload: one ``(rows, tiles, ops)``
    triple per distinct (precision, act_sparsity, w_sparsity) group of
    active ops, ``tiles`` (B, MAX_TILES, 10) and ``ops`` (len(rows), 7)
    float32 on ``device``; ``rows`` indexes the op table.  A group's rows
    are ordered by op class (stable), so that the kernel's warps, which
    take consecutive ops, rarely mix classes; every output lands at its
    row, so the order changes no result."""
    device = resolve_device(device)
    cm = cost_model(calib, device)
    T, chip = placed if placed is not None else place_configs(cfgs, device)
    rows = _active_rows(ws)
    keys = np.stack([ws["precision"][rows].astype(np.float64),
                     ws["act_sparsity"][rows], ws["w_sparsity"][rows]],
                    axis=1)
    groups, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    bw = chip["dram_gbps"] * 1e9                          # (B, 1)
    out = []
    for g, (prec, act_sp, w_sp) in enumerate(groups):
        sel = rows[inverse == g]
        sel = sel[np.argsort(ws["op_cls"][sel], kind="stable")]
        prec = float(prec)
        tile_cols = [
            T["exists"], T["num_macs"], T["dsp_lanes"], T["clock_hz"],
            cm.eta(T["sparsity"], float(act_sp), float(w_sp)),
            T["sfu_mask"], T["sfu_parallel"],
            cm.supports_precision(T, prec).to(F64),
            cm.mac_energy_pj(T, prec),
            bw.expand_as(T["exists"]),
        ]
        tiles = torch.stack([c.to(F64) for c in tile_cols], dim=-1) \
            .to(F32).contiguous()
        op_cols = np.stack([
            ws["op_cls"][sel].astype(np.float64), ws["macs"][sel],
            ws["elems"][sel],
            ws["bytes_in"][sel] + ws["bytes_w"][sel] + ws["bytes_out"][sel],
            ws["seq_len"][sel],
            SFU_NEED[ws["op_type"][sel].astype(np.int64)],
            ws["fft_n"][sel]], axis=1)
        ops = torch.as_tensor(op_cols, dtype=F32).to(device).contiguous()
        out.append((sel, tiles, ops))
    return out


def roofline_bounds(cfgs: Dict[str, Dict[str, np.ndarray]],
                    prepared: Dict[str, np.ndarray],
                    calib: CalibrationTable = DEFAULT_CALIB,
                    device=None, placed=None) -> torch.Tensor:
    """(B, max_ops, 2) float32 on ``device``: per candidate and op, the
    best-tile seconds and the energy at that tile (0 on rows the kernel
    does not see).  One ``kernels.ops.dse_eval`` call per op group."""
    device = resolve_device(device)
    B = len(cfgs["chip"]["chip_area"])
    out = torch.zeros((B, len(prepared["op_type"]), 2), dtype=F32,
                      device=device)
    for sel, tiles, ops in pack_launches(cfgs, prepared, calib, device,
                                         placed):
        idx = torch.as_tensor(sel, dtype=torch.long, device=device)
        out[:, idx, :] = kops.dse_eval(tiles, ops)
    return out
