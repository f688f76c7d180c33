"""Exact batched Eq. 1-3 mapper, and the fused map + execute path.

Port of ``repro/core/compiler/batched_mapper.py``: ``batched_map``,
``map_and_simulate`` (the mapping pass, then the plan executor) and the
exact search, ``search_population`` / ``search_and_simulate`` (one pass
that maps and executes each row in the same step).

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

``map_and_simulate`` and the search run one loop, ``_search_one``: per
row, ``RowMapper.step`` (the mapping) and then
``simulator.batched.PlanExecutor.step`` (the execution), so the formulas
exist once and the search's metrics are ``map_and_simulate``'s bit for
bit, as the reference pins its own pair.  ``batched_map`` runs the
mapping alone (``map_placements``).  ``fidelity="link"`` runs the
executor's link-tier occupancy in the same pass, so the search surface
gains ``ii_chan_bound_s`` and ``ii_link_bound_s``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ..arch import MAX_TILES
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..ir import OpClass
from ..simulator.batched import OpRow, PlanExecutor, op_rows, place_configs
from ..simulator.costs import (F64, _div, cost_model, noc_transfer_seconds,
                               split_op_fields)
from ..simulator.orchestrator import SCHEDULE_MODES, check_fidelity

__all__ = ["batched_map", "map_and_simulate", "search_population",
           "search_and_simulate", "place_configs", "map_placements",
           "RowMapper", "Choice", "SEARCH_KEYS", "LINK_KEYS"]

# map_graph's tie band: completion times within 1e-15 s prefer the
# smaller MAC array.
_TIE = 1e-15


@dataclasses.dataclass
class Choice:
    """One row's placement for B candidates, as the mapper made it.

    ``owner`` (B, 1) int64 is -1 where the row found no compatible tile
    (``placed`` False); ``onehot`` (B, MAX_TILES) marks the owner.  Rows
    that took the Eq. 3 probe carry ``split`` = (ksplit, do_split,
    best_axis, mac_mask); the placement-array fields below are derived on
    demand, so the search derives only what it executes."""

    owner: torch.Tensor
    placed: torch.Tensor
    onehot: torch.Tensor
    split: Optional[Tuple[torch.Tensor, ...]] = None

    @property
    def n_split(self) -> torch.Tensor:
        if self.split is None:
            return self.placed.long()
        ksplit, do_split = self.split[:2]
        return torch.where(self.placed, torch.where(do_split, ksplit, 1), 0)

    @property
    def split_axis(self) -> torch.Tensor:
        if self.split is None:
            return torch.full_like(self.owner, -1)
        _, do_split, best_axis, _ = self.split
        return torch.where(self.placed & do_split, best_axis, -1)

    @property
    def split_mask(self) -> torch.Tensor:
        if self.split is None:
            return self.placed & self.onehot
        _, do_split, _, mac_mask = self.split
        return self.placed & torch.where(do_split, mac_mask, self.onehot)


class RowMapper:
    """``map_graph``'s state for B candidates, advanced one op row at a
    time by :meth:`step`.  ``T``/``chip`` come from ``place_configs``;
    ``n_slots`` bounds the tile slots any candidate occupies (slots past
    it hold no tile, so the argmin fold can stop there).  ``ok`` (B, 1)
    is False where some row found no compatible tile."""

    def __init__(self, cm, T: Dict[str, torch.Tensor],
                 chip: Dict[str, torch.Tensor], max_ops: int,
                 n_slots: int = MAX_TILES, enable_split: bool = True):
        B = T["exists"].shape[0]
        dev = T["exists"].device
        self.cm, self.chip = cm, chip
        # tile x precision / sparsity terms, per evaluation
        self.T = T if "_cache" in T else dict(T, _cache={})
        self.n_slots, self.enable_split = n_slots, enable_split
        self.tidx = torch.arange(MAX_TILES, device=dev)
        self.num_macs = T["num_macs"]
        self.nm_cols = self.num_macs.unbind(dim=1)
        n_tiles = T["exists"].sum(dim=1, keepdim=True)
        # static per-tile bandwidth share for the estimate domain (§3.2)
        self.bw_share = _div(chip["dram_gbps"], n_tiles)
        self.tile_finish = torch.zeros((B, MAX_TILES), dtype=F64, device=dev)
        self.op_finish = torch.zeros((B, max_ops), dtype=F64, device=dev)
        self.op_tile = torch.full((B, max_ops), -1, dtype=torch.long,
                                  device=dev)
        self.ok = torch.ones((B, 1), dtype=torch.bool, device=dev)

    def _noc_s(self, nbytes):
        chip = self.chip
        return noc_transfer_seconds(nbytes, chip["noc_bpc"], chip["hops"],
                                    chip["noc_base_cycles"],
                                    chip["ref_clock_hz"])

    def step(self, r: OpRow) -> Choice:
        """Place row ``r`` on every candidate and record it."""
        cm, T = self.cm, self.T
        B = T["exists"].shape[0]
        dev = T["exists"].device
        tidx, num_macs, bw_share = self.tidx, self.num_macs, self.bw_share
        tile_finish, op_finish, op_tile = (self.tile_finish, self.op_finish,
                                           self.op_tile)
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
            ns = self._noc_s(r.per_pred_bytes)
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
        for t in range(self.n_slots):
            fin, nm = fin_cols[t], self.nm_cols[t]
            better = fin < best_fin - _TIE
            tie = ((fin - best_fin).abs() <= _TIE) & (nm < best_nm)
            upd = ok_cols[t] & (better | tie)
            best_t = torch.where(upd, t, best_t)
            best_fin = torch.where(upd, fin, best_fin)
            best_nm = torch.where(upd, nm, best_nm)
        best_t, best_fin = best_t[:, None], best_fin[:, None]

        # ---- split candidates (Eq. 3) ------------------------------------
        mac_mask = compat & (num_macs > 0)
        owner, choice_fin, split = best_t, best_fin, None
        if self.enable_split and r.may_split:
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
                             + self._noc_s(_div(op["bytes_out"], kf)))
            fins3 = torch.cat(fins3, dim=1)
            # sequential strict-< axis loop == first occurrence of the min
            best_axis = fins3.argmin(dim=1, keepdim=True)
            fin_axis = torch.gather(fins3, 1, best_axis)
            do_split = (ksplit > 1) & (fin_axis < best_fin)
            first_mac = mac_mask.to(torch.int8).argmax(dim=1, keepdim=True)
            owner = torch.where(do_split, first_mac, best_t)
            choice_fin = torch.where(do_split, fin_axis, best_fin)
            split = (ksplit, do_split, best_axis, mac_mask)

        # ---- state update (map_graph's finish bookkeeping) ---------------
        placed = any_compat
        onehot = tidx == owner
        new_tf = torch.where(onehot, choice_fin, tile_finish)
        if split is not None:
            tf_split = torch.where(mac_mask,
                                   torch.maximum(tile_finish, choice_fin),
                                   tile_finish)
            new_tf = torch.where(do_split, tf_split, new_tf)
        self.tile_finish = torch.where(placed, new_tf, tile_finish)
        op_finish[:, idx:idx + 1] = torch.where(placed, choice_fin, 0.0)
        owner_out = torch.where(placed, owner, -1)
        op_tile[:, idx:idx + 1] = owner_out
        self.ok &= any_compat
        return Choice(owner_out, placed, onehot, split)


def _placement_arrays(B: int, max_ops: int, dev) -> Dict[str, torch.Tensor]:
    """Empty ``owner`` / ``n_split`` / ``split_axis`` (B, max_ops) int64
    and ``split_mask`` (B, max_ops, MAX_TILES) bool, as unmapped rows
    leave them."""
    return {"owner": torch.full((B, max_ops), -1, dtype=torch.long,
                                device=dev),
            "n_split": torch.zeros((B, max_ops), dtype=torch.long,
                                   device=dev),
            "split_axis": torch.full((B, max_ops), -1, dtype=torch.long,
                                     device=dev),
            "split_mask": torch.zeros((B, max_ops, MAX_TILES),
                                      dtype=torch.bool, device=dev)}


def _record(pl: Dict[str, torch.Tensor], idx: int, ch: Choice) -> None:
    """Store row ``idx``'s choice in the placement arrays."""
    pl["owner"][:, idx:idx + 1] = ch.owner
    pl["n_split"][:, idx:idx + 1] = ch.n_split
    if ch.split is not None:
        pl["split_axis"][:, idx:idx + 1] = ch.split_axis
    pl["split_mask"][:, idx, :] = ch.split_mask


def map_placements(cm, T: Dict[str, torch.Tensor],
                   chip: Dict[str, torch.Tensor], rows: Sequence[OpRow],
                   max_ops: int, n_slots: int = MAX_TILES,
                   enable_split: bool = True) -> Dict[str, torch.Tensor]:
    """Map ONE workload onto B candidate chips (``RowMapper`` over its
    rows), the mapping alone.  Returns the placement arrays
    (``_placement_arrays``) and ``ok`` (B,) bool.
    """
    mapper = RowMapper(cm, T, chip, max_ops, n_slots, enable_split)
    pl = _placement_arrays(T["exists"].shape[0], max_ops,
                           T["exists"].device)
    for r in rows:
        _record(pl, r.index, mapper.step(r))
    pl["ok"] = mapper.ok.reshape(-1)
    return pl


def _n_slots(cfgs) -> int:
    """Highest occupied tile slot + 1 over the batch (host arrays)."""
    occupied = np.flatnonzero(np.asarray(cfgs["tile"]["exists"]).any(axis=0))
    return int(occupied[-1]) + 1 if len(occupied) else 0


def _check_mode_fidelity(what: str, mode: str, fidelity: str) -> None:
    """The reference's refusals of an unknown mode or fidelity."""
    if mode not in SCHEDULE_MODES:
        raise ValueError(f"{what} cannot model schedule mode {mode!r}; "
                         f"supported modes: {SCHEDULE_MODES}")
    check_fidelity(fidelity)


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
    """The compile-free exact path: the batched Eq. 1-3 mapping and the
    batched plan executor, on one device (``_search_one``'s pass).

    Returns the executor's metric surface as numpy (B,) arrays (both
    schedule modes are always evaluated; ``mode`` validates and tags),
    ``ok`` (B,) and, with ``placements=True``, the placement arrays.  Rows
    with ``ok == False`` carry garbage metrics, as in the reference.
    """
    _check_mode_fidelity("batched mapper+executor", mode, fidelity)
    cm, T, chip, rows, max_ops = _prepare(ws, cfgs, calib, device, placed)
    out = _search_one(cm, T, chip, rows, max_ops, _n_slots(cfgs),
                      float(ws["total_macs"]), placements, fidelity)
    res = {k: v.cpu().numpy() for k, v in out.items()}
    res["area_mm2"] = cfgs["chip"]["chip_area"]
    res["peak_tops"] = cfgs["chip"]["peak_tops"]
    res["mode"] = mode
    return res


# the search's (B,) scoring surface: the reference's ``_build_search``
# keys (both schedule modes; ``ok`` comes beside them)
SEARCH_KEYS = ("latency_s", "energy_pj", "achieved_tops", "ii_tile_bound_s",
               "ii_dram_bound_s", "ii_noc_bound_s", "ii_s", "fill_latency_s",
               "dram_bytes_per_batch", "energy_ss_pj", "achieved_tops_ss",
               "pipeline_depth")
# the link tier's two bounds, beside SEARCH_KEYS on that tier
LINK_KEYS = ("ii_chan_bound_s", "ii_link_bound_s")


def _search_one(cm, T, chip, rows, max_ops: int, n_slots: int,
                total_macs: float, placements: bool = False,
                fidelity: str = "aggregate") -> Dict[str, torch.Tensor]:
    """One pass over a workload's rows that maps each row and executes it
    in the same step: ``RowMapper`` and ``PlanExecutor`` side by side,
    sharing their per-evaluation term cache.  Returns the executor's
    surface and ``ok``; the placement arrays only with ``placements``
    (the search materialises none)."""
    T = dict(T, _cache={})
    mapper = RowMapper(cm, T, chip, max_ops, n_slots)
    ex = PlanExecutor(cm, T, chip, max_ops, fidelity)
    pl = (_placement_arrays(T["exists"].shape[0], max_ops,
                            T["exists"].device) if placements else None)
    for r in rows:
        ch = mapper.step(r)
        if pl is not None:
            _record(pl, r.index, ch)
        # unmappable rows carry owner -1: clamp for the executor's gathers
        # (their candidates are discarded through ``ok``)
        owner = torch.clamp(ch.owner, min=0)
        if r.may_split:
            ex.step(r, owner, ch.n_split.to(F64), ch.split_axis,
                    ch.split_mask)
        else:
            ex.step(r, owner)
    out = ex.finish(total_macs)
    out["ok"] = mapper.ok.reshape(-1)
    if pl is not None:
        out.update(pl)
    return out


def search_population(ws_list: Sequence[Dict[str, np.ndarray]],
                      cfgs: Optional[Dict[str, Dict[str, np.ndarray]]],
                      calib: CalibrationTable = DEFAULT_CALIB,
                      mode: str = "latency",
                      out_keys: Optional[Tuple[str, ...]] = None,
                      fidelity: str = "aggregate", device=None,
                      placed=None, as_tensors: bool = False
                      ) -> List[Dict[str, np.ndarray]]:
    """Exact search scoring of one candidate batch on a list of prepared
    workloads: per workload, one pass that maps and executes each active
    op row (``_search_one``).  Returns one result dict per workload: the
    (B,) search surface (``SEARCH_KEYS``, and ``LINK_KEYS`` on the link
    tier), or only ``out_keys``, plus
    ``ok``, ``area_mm2``, ``peak_tops`` and ``mode`` (which validates and
    tags: both schedule surfaces ride in the one pass).  Rows with ``ok ==
    False`` carry garbage metrics.  This is what ``EvalEngine(backend=
    "exact")`` runs per miss batch.  ``device``/``placed`` as in
    ``map_and_simulate``.

    The fused GA loop builds its configs on the device: it passes
    ``cfgs=None`` with ``placed``, and ``as_tensors=True`` to keep the
    metric columns and ``ok`` on the device.  With no host configs every
    tile slot is walked (slots past a candidate's tiles hold none, so the
    results are the same) and ``area_mm2``/``peak_tops`` are left out."""
    _check_mode_fidelity("exact search", mode, fidelity)
    if cfgs is None and placed is None:
        raise ValueError("search_population needs cfgs or placed configs")
    device = resolve_device(device)
    cm = cost_model(calib, device)
    T, chip = placed if placed is not None else place_configs(cfgs, device)
    if out_keys is not None:
        keys = tuple(out_keys)
    else:
        keys = SEARCH_KEYS + (LINK_KEYS if fidelity == "link" else ())
    n_slots = _n_slots(cfgs) if cfgs is not None else MAX_TILES
    results = []
    for ws in ws_list:
        out = _search_one(cm, T, chip, op_rows(ws), len(ws["op_type"]),
                          n_slots, float(ws["total_macs"]),
                          fidelity=fidelity)
        if as_tensors:
            res = {k: out[k] for k in keys + ("ok",)}
        else:
            res = {k: out[k].cpu().numpy() for k in keys + ("ok",)}
        if cfgs is not None:
            res["area_mm2"] = cfgs["chip"]["chip_area"]
            res["peak_tops"] = cfgs["chip"]["peak_tops"]
        res["mode"] = mode
        results.append(res)
    return results


def search_and_simulate(ws: Dict[str, np.ndarray],
                        cfgs: Dict[str, Dict[str, np.ndarray]],
                        calib: CalibrationTable = DEFAULT_CALIB,
                        mode: str = "latency", fidelity: str = "aggregate",
                        device=None, placed=None) -> Dict[str, np.ndarray]:
    """The exact search on one workload: ``search_population([ws], ...)``'s
    one result, the whole search surface."""
    return search_population([ws], cfgs, calib, mode=mode,
                             fidelity=fidelity, device=device,
                             placed=placed)[0]
