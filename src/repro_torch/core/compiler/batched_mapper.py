"""Exact batched Eq. 1-3 mapper, and the fused map + execute path.

Port of ``repro/core/compiler/batched_mapper.py`` (``batched_map`` and
``map_and_simulate``; the class-specialized single-scan
``search_population`` / ``search_and_simulate`` come in a later slice).

The reference re-derives ``map_graph``'s placement sequence as one
``lax.scan`` over ops, ``vmap``-ed over candidates.  Here the scan is a
Python loop over the workload's active op rows (``simulator.batched
.op_rows``) and the candidate axis is written out as dim 0.  The
decision sequence is the reference's: compatibility filtering,
SPECIAL->SFU routing, earliest start with NoC-crossing dependency delays
(Eq. 1), the roofline completion-time argmin with the mapper's
*sequential* 1e-15 tie band (an unrolled fold in ascending tile order,
because a tie-break win moves the incumbent), and the OC/B/IC split
decision with the explicit Eq. 3 reduce cost.

Workload-static predicates (``op_cls``, ``splittable``, ``macs > 0``,
the predecessor list) are Python branches, so each row evaluates only
its own class's cost sub-models (``CostModel.*_cls``), which are term
for term the full model's selected branch.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ..arch import MAX_TILES
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..ir import OpClass
from ..simulator.batched import (OpRow, execute_plan, op_rows,
                                 place_configs)
from ..simulator.costs import (F64, FIDELITIES, _div, cost_model,
                               noc_transfer_seconds, split_op_fields)
from ..simulator.orchestrator import SCHEDULE_MODES

__all__ = ["batched_map", "map_and_simulate", "place_configs",
           "map_placements"]

# map_graph's tie band: completion times within 1e-15 s prefer the
# smaller MAC array.
_TIE = 1e-15


def map_placements(cm, T: Dict[str, torch.Tensor],
                   chip: Dict[str, torch.Tensor], rows: Sequence[OpRow],
                   max_ops: int, n_slots: int = MAX_TILES,
                   enable_split: bool = True) -> Dict[str, torch.Tensor]:
    """Map ONE workload onto B candidate chips.

    ``T``/``chip`` come from ``place_configs``; ``n_slots`` bounds the
    tile slots any candidate occupies (slots past it hold no tile, so the
    argmin fold can stop there).  Returns ``owner`` / ``n_split`` /
    ``split_axis`` (B, max_ops) int64, ``split_mask`` (B, max_ops,
    MAX_TILES) bool and ``ok`` (B,) bool.
    """
    B = T["exists"].shape[0]
    dev = T["exists"].device
    T = dict(T, _cache={})    # tile x precision / sparsity terms, per call
    tidx = torch.arange(MAX_TILES, device=dev)
    num_macs = T["num_macs"]
    nm_cols = num_macs.unbind(dim=1)
    n_tiles = T["exists"].sum(dim=1, keepdim=True)
    # static per-tile bandwidth share for the estimate domain (§3.2)
    bw_share = _div(chip["dram_gbps"], n_tiles)

    def noc_s(nbytes):
        return noc_transfer_seconds(nbytes, chip["noc_bpc"], chip["hops"],
                                    chip["noc_base_cycles"],
                                    chip["ref_clock_hz"])

    tile_finish = torch.zeros((B, MAX_TILES), dtype=F64, device=dev)
    op_finish = torch.zeros((B, max_ops), dtype=F64, device=dev)
    op_tile = torch.full((B, max_ops), -1, dtype=torch.long, device=dev)
    ok = torch.ones((B, 1), dtype=torch.bool, device=dev)
    out_owner = torch.full((B, max_ops), -1, dtype=torch.long, device=dev)
    out_nsplit = torch.zeros((B, max_ops), dtype=torch.long, device=dev)
    out_axis = torch.full((B, max_ops), -1, dtype=torch.long, device=dev)
    out_mask = torch.zeros((B, max_ops, MAX_TILES), dtype=torch.bool,
                           device=dev)

    for r in rows:
        op, idx = r.op, r.index

        # ---- compatibility + SPECIAL->SFU routing (§3.2) -----------------
        compat = cm.supports_cls(T, op, r.cls)
        if r.cls == int(OpClass.SPECIAL):
            native = cm.sfu_native(T, op) & compat
            compat = torch.where(native.any(dim=1, keepdim=True), native,
                                 compat)
        any_compat = compat.any(dim=1, keepdim=True)

        # ---- Eq. 1 earliest start per tile -------------------------------
        # fused / absent preds (op_tile == -1) count as local, exactly like
        # map_graph's op_tile.get(p, t)
        dep = torch.zeros((B, MAX_TILES), dtype=F64, device=dev)
        if r.preds:
            ns = noc_s(r.per_pred_bytes)
        for p in r.preds:
            ptile = op_tile[:, p:p + 1]
            cross = (ptile >= 0) & (ptile != tidx)
            dep = torch.maximum(
                dep, op_finish[:, p:p + 1] + torch.where(cross, ns, 0.0))
        t_start = torch.maximum(tile_finish, dep)

        # ---- single-tile candidates (Eq. 2) ------------------------------
        c_hat_s = _div(cm.roofline_cycles_cls(T, op, bw_share, r.cls),
                       T["clock_hz"])
        fins = t_start + c_hat_s
        # map_graph's argmin is a sequential fold whose 1e-15 tie band
        # chains (a tie-break win replaces the incumbent best_fin too)
        # (the reference also tests best_t >= 0 in the tie arm; that holds
        # exactly when best_fin is finite, and |fin - inf| <= TIE is never
        # true, so the term is dropped)
        best_t = torch.full((B,), -1, dtype=torch.long, device=dev)
        best_fin = torch.full((B,), torch.inf, dtype=F64, device=dev)
        best_nm = torch.zeros((B,), dtype=F64, device=dev)
        fin_cols, ok_cols = fins.unbind(dim=1), compat.unbind(dim=1)
        for t in range(n_slots):
            fin, nm = fin_cols[t], nm_cols[t]
            better = fin < best_fin - _TIE
            tie = ((fin - best_fin).abs() <= _TIE) & (nm < best_nm)
            upd = ok_cols[t] & (better | tie)
            best_t = torch.where(upd, t, best_t)
            best_fin = torch.where(upd, fin, best_fin)
            best_nm = torch.where(upd, nm, best_nm)
        best_t, best_fin = best_t[:, None], best_fin[:, None]

        # ---- split candidates (Eq. 3) ------------------------------------
        mac_mask = compat & (num_macs > 0)
        owner, choice_fin, do_split = best_t, best_fin, None
        if enable_split and r.may_split:
            ksplit = mac_mask.sum(dim=1, keepdim=True)
            kf = torch.clamp(ksplit.to(F64), min=1.0)
            fins3 = []
            for axis in (0, 1, 2):
                sub = split_op_fields(op, axis, kf)
                ch_s = _div(cm.roofline_cycles_mac(T, sub,
                                                   _div(bw_share, kf)),
                            T["clock_hz"])
                fins_s = torch.where(mac_mask, t_start + ch_s, -torch.inf)
                fins3.append(fins_s.max(dim=1, keepdim=True).values
                             + noc_s(_div(op["bytes_out"], kf)))
            fins3 = torch.cat(fins3, dim=1)
            # sequential strict-< axis loop == first occurrence of the min
            best_axis = fins3.argmin(dim=1, keepdim=True)
            fin_axis = torch.gather(fins3, 1, best_axis)
            do_split = (ksplit > 1) & (fin_axis < best_fin)
            first_mac = mac_mask.to(torch.int8).argmax(dim=1, keepdim=True)
            owner = torch.where(do_split, first_mac, best_t)
            choice_fin = torch.where(do_split, fin_axis, best_fin)

        # ---- state update (map_graph's finish bookkeeping) ---------------
        placed = any_compat
        onehot = tidx == owner
        new_tf = torch.where(onehot, choice_fin, tile_finish)
        if do_split is not None:
            tf_split = torch.where(mac_mask,
                                   torch.maximum(tile_finish, choice_fin),
                                   tile_finish)
            new_tf = torch.where(do_split, tf_split, new_tf)
        tile_finish = torch.where(placed, new_tf, tile_finish)
        op_finish[:, idx:idx + 1] = torch.where(placed, choice_fin, 0.0)
        owner_out = torch.where(placed, owner, -1)
        op_tile[:, idx:idx + 1] = owner_out
        ok &= any_compat

        out_owner[:, idx:idx + 1] = owner_out
        if do_split is None:
            out_nsplit[:, idx:idx + 1] = placed.long()
            out_mask[:, idx, :] = placed & onehot
        else:
            out_nsplit[:, idx:idx + 1] = torch.where(
                placed, torch.where(do_split, ksplit, 1), 0)
            out_axis[:, idx:idx + 1] = torch.where(placed & do_split,
                                                   best_axis, -1)
            out_mask[:, idx, :] = placed & torch.where(do_split, mac_mask,
                                                       onehot)
    return {"owner": out_owner, "n_split": out_nsplit,
            "split_axis": out_axis, "split_mask": out_mask,
            "ok": ok.reshape(-1)}


def _n_slots(cfgs) -> int:
    """Highest occupied tile slot + 1 over the batch (host arrays)."""
    occupied = np.flatnonzero(np.asarray(cfgs["tile"]["exists"]).any(axis=0))
    return int(occupied[-1]) + 1 if len(occupied) else 0


def _prepare(ws, cfgs, calib, device, placed):
    device = resolve_device(device)
    cm = cost_model(calib, device)
    T, chip = placed if placed is not None else place_configs(cfgs, device)
    return cm, T, chip, op_rows(ws), len(ws["op_type"])


def batched_map(ws: Dict[str, np.ndarray],
                cfgs: Dict[str, Dict[str, np.ndarray]],
                calib: CalibrationTable = DEFAULT_CALIB,
                enable_split: bool = True, device=None,
                placed=None) -> Dict[str, np.ndarray]:
    """Exact Eq. 1-3 mapping of one workload onto B candidate chips.

    ``ws`` is a prepared-workload dict (``dse.batch_eval
    .prepare_workload``), ``cfgs`` a stacked config dict.  Returns the
    reference's arrays: ``owner`` / ``n_split`` / ``split_axis``
    (B, max_ops) int32, ``split_mask`` (B, max_ops, MAX_TILES) int8 and
    ``ok`` (B,) bool (False where ``map_graph`` would raise
    ``UnmappableError``).  ``device`` is where the tensors live (default
    the card; raises without one unless ``"cpu"`` is asked for);
    ``placed`` reuses a ``place_configs`` result.
    """
    cm, T, chip, rows, max_ops = _prepare(ws, cfgs, calib, device, placed)
    out = map_placements(cm, T, chip, rows, max_ops, _n_slots(cfgs),
                         enable_split)
    return {
        "owner": out["owner"].cpu().numpy().astype(np.int32),
        "n_split": out["n_split"].cpu().numpy().astype(np.int32),
        "split_axis": out["split_axis"].cpu().numpy().astype(np.int32),
        "split_mask": out["split_mask"].cpu().numpy().astype(np.int8),
        "ok": out["ok"].cpu().numpy(),
    }


def map_and_simulate(ws: Dict[str, np.ndarray],
                     cfgs: Dict[str, Dict[str, np.ndarray]],
                     calib: CalibrationTable = DEFAULT_CALIB,
                     mode: str = "latency", fidelity: str = "aggregate",
                     device=None, placed=None,
                     placements: bool = True) -> Dict[str, np.ndarray]:
    """The compile-free exact path: the batched Eq. 1-3 mapping followed
    by the batched plan executor, on one device.

    Returns the executor's metric surface as numpy (B,) arrays (both
    schedule modes are always evaluated; ``mode`` validates and tags),
    ``ok`` (B,) and, with ``placements=True``, the placement arrays.  Rows
    with ``ok == False`` carry garbage metrics, as in the reference.
    """
    if mode not in SCHEDULE_MODES:
        raise ValueError(
            f"batched mapper+executor cannot model schedule mode {mode!r}; "
            f"supported modes: {SCHEDULE_MODES}")
    if fidelity not in FIDELITIES:
        raise ValueError(f"fidelity must be one of {FIDELITIES}, "
                         f"got {fidelity!r}")
    if fidelity != "aggregate":
        raise NotImplementedError(
            "fidelity='link' is not ported yet (ROADMAP A: the link tier)")
    cm, T, chip, rows, max_ops = _prepare(ws, cfgs, calib, device, placed)
    pl = map_placements(cm, T, chip, rows, max_ops, _n_slots(cfgs))
    place = {"owner": torch.clamp(pl["owner"], min=0),
             "n_split": pl["n_split"].to(F64),
             "split_axis": pl["split_axis"],
             "split_mask": pl["split_mask"]}
    out = execute_plan(cm, T, chip, rows, max_ops, float(ws["total_macs"]),
                       place)
    out["ok"] = pl["ok"]
    if placements:
        for f in ("owner", "n_split", "split_axis", "split_mask"):
            out[f] = pl[f]
    res = {k: v.cpu().numpy() for k, v in out.items()}
    res["area_mm2"] = cfgs["chip"]["chip_area"]
    res["peak_tops"] = cfgs["chip"]["peak_tops"]
    res["mode"] = mode
    return res
