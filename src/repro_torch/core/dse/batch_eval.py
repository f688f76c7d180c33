"""The scan evaluator behind ``backend="scan"``: the MOSAIC compile +
simulate cost model as one pass over a workload's operators, for B
candidate chips at once, and the host-side preparation of workloads and
configs that every batched backend shares.

Port of ``repro/core/dse/batch_eval.py``.  ``prepare_workload`` and
``prepare_configs`` are numpy host code and give the reference's arrays
exactly.  ``batch_evaluate`` is the reference's ``lax.scan`` over
operators ``vmap``-ed over candidates, written as the port writes the
exact search: a host loop over the workload's active op rows
(``simulator.batched.op_rows``) with the B candidates on the leading
axis of every state tensor.

It is the reference's *approximation*, ported as the same approximation
(its Eq. 1-3 placement is re-derived in the scan with an epsilon
tie-break, and its Eq. 3 split slices floor every byte count), not the
exact mapper: it shares the cost model (``simulator.costs``), the FIFO
activation cache (``simulator.batched.fifo_insert``) and the link tier's
occupancy (``simulator.batched.LinkOccupancy``) with the exact backends,
but not their placement.  Searches that rank on it re-score finalists
through an exact backend (``EvalEngine.rescore``).
"""
from __future__ import annotations

import copy
from typing import Dict, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ..arch import MAX_TILES, ChipConfig
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..compiler.fusion import fuse
from ..compiler.precision import assign_precision
from ..ir import OpClass, WorkloadGraph, bucket_ops
from ..simulator.batched import (LinkOccupancy, OpRow, fifo_insert, op_rows,
                                 place_configs, stack_chip_configs)
from ..simulator.costs import (ACT_CACHE_SLOTS, F64, _div, _floor,
                               _maximum, _where, cost_model,
                               noc_transfer_energy_pj, noc_transfer_seconds,
                               pipeline_bounds, steady_state_energy)
from ..simulator.orchestrator import check_fidelity

__all__ = ["prepare_workload", "prepare_configs", "batch_evaluate"]

# the scan's tie-break: completion times carry num_macs * 1e-18 s, so a
# tie prefers the smaller MAC array
_EPS_TIE = 1e-18

# the seven metric keys of the scan's surface
SCAN_KEYS = ("latency_s", "energy_pj", "achieved_tops", "ii_s",
             "energy_ss_pj", "achieved_tops_ss", "fill_latency_s")


def prepare_workload(g: WorkloadGraph, aggressive_int4: bool = False,
                     enable_fusion: bool = True) -> Dict[str, np.ndarray]:
    """Run the config-independent compiler passes 1-2 and emit SoA arrays."""
    g = copy.deepcopy(g)
    g = assign_precision(g, aggressive_int4=aggressive_int4)
    if enable_fusion:
        g = fuse(g)
    t = g.to_tensor(max_ops=bucket_ops(len(g.nodes)))
    a = dict(t.arrays)
    a["preds"] = t.preds
    num_preds = (t.preds >= 0).sum(axis=1).astype(np.float64)
    a["num_preds"] = num_preds
    a["per_pred_bytes"] = a["bytes_in"] / np.maximum(num_preds, 1.0)
    # PPM energy + Eq. 6 refund for fused children, credited to the head
    fused_lane_ops = np.zeros(t.max_ops)
    fused_refund_b = np.zeros(t.max_ops)
    for nd in g.nodes:
        if nd.fused_into >= 0:
            fused_lane_ops[nd.fused_into] += nd.elems * 2.0
            fused_refund_b[nd.fused_into] += 2.0 * nd.bytes_out
    a["fused_lane_ops"] = fused_lane_ops
    a["fused_refund_bytes"] = fused_refund_b
    a["total_macs"] = np.float64(g.total_macs)
    return a


def prepare_configs(chips: Sequence[ChipConfig],
                    calib: CalibrationTable = DEFAULT_CALIB
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """Stack a list of chips into (B, MAX_TILES) / (B,) arrays."""
    return stack_chip_configs(chips, calib)


# =============================================================================
# the scan: greedy Eq. 1-3 mapping + orchestrator replay, one op per step
# =============================================================================

def _split_sub(op: Dict[str, float], axis: int, kf: torch.Tensor):
    """The scan's Eq. 3 slice along OC (0), B (1) or IC (2), as the
    reference writes it: every byte count is floored (the unsplit axes'
    by 1.0), and ``macs`` is ``m * n * k`` without a guard.  This is not
    ``costs.split_op_fields``."""
    sub = dict(op)
    sm = _maximum(_floor(_div(op["m"], kf)), 1.0) if axis == 1 else op["m"]
    sn = _maximum(_floor(_div(op["n"], kf)), 1.0) if axis == 0 else op["n"]
    sk = _maximum(_floor(_div(op["k"], kf)), 1.0) if axis == 2 else op["k"]
    sub["m"], sub["n"], sub["k"] = sm, sn, sk
    sub["macs"] = sm * sn * sk
    sub["bytes_in"] = _floor(_div(op["bytes_in"], kf if axis == 1 else 1.0))
    sub["bytes_w"] = _floor(_div(op["bytes_w"], kf if axis != 1 else 1.0))
    sub["bytes_out"] = _floor(_div(op["bytes_out"],
                                   kf if axis != 2 else 1.0))
    return sub


class _Scan:
    """The reference's scan carry for B candidates, advanced one active op
    row at a time by :meth:`step` and reduced by :meth:`finish`.  Fused
    and padding rows write the carry's initial values (``opf_est`` 0,
    ``op_tile`` -1), so they are skipped."""

    def __init__(self, cm, T: Dict[str, torch.Tensor],
                 chip: Dict[str, torch.Tensor], max_ops: int,
                 fidelity: str):
        B = T["exists"].shape[0]
        dev = T["exists"].device
        self.cm, self.chip = cm, chip
        # tile x precision / sparsity terms, per evaluation
        self.T = dict(T, _cache={})
        self.tidx = torch.arange(MAX_TILES, device=dev)
        self.exists = T["exists"] > 0
        self.nm_eps = T["num_macs"] * _EPS_TIE
        self.bw_static = _div(chip["dram_gbps"],
                              T["exists"].sum(dim=1, keepdim=True))
        zt = lambda: torch.zeros((B, MAX_TILES), dtype=F64, device=dev)
        self.fin_est, self.fin_act = zt(), zt()
        self.tile_ops, self.tile_busy = zt(), zt()
        self.opf_est = torch.zeros((B, max_ops), dtype=F64, device=dev)
        self.opf_act = torch.zeros((B, max_ops), dtype=F64, device=dev)
        self.op_tile = torch.full((B, max_ops), -1, dtype=torch.long,
                                  device=dev)
        self.cached_at = torch.full((B, max_ops + 1), -1, dtype=torch.long,
                                    device=dev)
        self.fifo_ops = torch.full((B, MAX_TILES, ACT_CACHE_SLOTS), -1,
                                   dtype=torch.long, device=dev)
        self.fifo_bytes = torch.zeros((B, MAX_TILES, ACT_CACHE_SLOTS),
                                      dtype=F64, device=dev)
        z1 = lambda: torch.zeros((B, 1), dtype=F64, device=dev)
        self.energy, self.dram_occ, self.noc_occ = z1(), z1(), z1()
        self.link = LinkOccupancy(chip) if fidelity == "link" else None

    def _noc_seconds(self, nbytes):
        chip = self.chip
        return noc_transfer_seconds(nbytes, chip["noc_bpc"], chip["hops"],
                                    chip["noc_base_cycles"],
                                    chip["ref_clock_hz"])

    def _noc_energy(self, nbytes):
        return noc_transfer_energy_pj(nbytes, self.cm.c.e_noc_pj_per_byte_hop,
                                      self.chip["hops"])

    def step(self, r: OpRow) -> None:
        cm, T, c = self.cm, self.T, self.cm.c
        op, idx = r.op, r.index
        tidx, num_macs = self.tidx, T["num_macs"]
        fin_est, fin_act = self.fin_est, self.fin_act

        compat = cm.supports_cls(T, op, r.cls)
        # special ops route to native-SFU tiles when one exists (§3.2)
        if r.cls == int(OpClass.SPECIAL):
            native = cm.sfu_native(T, op) & compat
            compat = torch.where(native.any(dim=1, keepdim=True), native,
                                 compat)
        ns_pred = self._noc_seconds(r.per_pred_bytes) if r.preds else None

        # ---------- estimate domain (mapper, Eq. 1-2) ----------
        # fused / absent preds (op_tile == -1) count as local
        dep = torch.zeros_like(fin_est)
        for p in r.preds:
            ptile = self.op_tile[:, p:p + 1]
            cross = (ptile != tidx) & (ptile >= 0)
            dep = torch.maximum(dep, self.opf_est[:, p:p + 1]
                                + torch.where(cross, ns_pred, 0.0))
        t_start_est = torch.maximum(fin_est, dep)
        c_hat = _div(cm.roofline_cycles_cls(T, op, self.bw_static, r.cls),
                     T["clock_hz"])
        completion = t_start_est + c_hat + self.nm_eps
        completion = torch.where(compat, completion, torch.inf)
        best_single = completion.argmin(dim=1, keepdim=True)
        best_single_fin = torch.gather(completion, 1, best_single) \
            - torch.gather(self.nm_eps, 1, best_single)

        # ---------- split candidates (Eq. 3) ----------
        # (the split arm is read only under do_split, which needs a
        # splittable MAC op with MACs: other rows skip it)
        if r.may_split:
            mac_mask = compat & (num_macs > 0)
            ksplit = mac_mask.sum(dim=1, keepdim=True)
            kf = torch.clamp(ksplit.to(F64), min=1.0)
            bw_split = _div(self.bw_static, kf)
            ns_out = self._noc_seconds(_div(op["bytes_out"], kf))
            subs, fins3 = [], []
            for axis in (0, 1, 2):
                sub = _split_sub(op, axis, kf)
                ch = _div(cm.roofline_cycles_mac(T, sub, bw_split),
                          T["clock_hz"])
                fins = torch.where(mac_mask, t_start_est + ch, -torch.inf)
                fins3.append(fins.max(dim=1, keepdim=True).values + ns_out)
                subs.append(sub)
            fins3 = torch.cat(fins3, dim=1)
            best_axis = fins3.argmin(dim=1, keepdim=True)
            best_split_fin = torch.gather(fins3, 1, best_axis)
            do_split = (ksplit >= 2) & (best_split_fin < best_single_fin)
            # the reference's select: OC, then B, then IC
            sub = dict(op)
            for k in ("m", "n", "k", "macs", "bytes_in", "bytes_w",
                      "bytes_out"):
                sub[k] = _where(best_axis == 0, subs[0][k],
                                _where(best_axis == 1, subs[1][k],
                                       subs[2][k]))
            first_mac = mac_mask.to(torch.int8).argmax(dim=1, keepdim=True)
            owner = torch.where(do_split, first_mac, best_single)
            choice_fin_est = torch.where(do_split, best_split_fin,
                                         best_single_fin)
        else:
            owner, choice_fin_est = best_single, best_single_fin

        # ---------- actual domain (orchestrator §3.3.4) ----------
        t_dep_act = torch.zeros_like(choice_fin_est)
        dram_miss = torch.zeros_like(choice_fin_est)
        extra_noc_s = torch.zeros_like(choice_fin_est)
        e_noc = torch.zeros_like(choice_fin_est)
        link = self.link
        if r.preds:
            ne_pred = self._noc_energy(r.per_pred_bytes)
            if link is not None:
                acq_s = link.link_seconds(r.per_pred_bytes)
        for p in r.preds:
            t_dep_act = torch.maximum(t_dep_act, self.opf_act[:, p:p + 1])
            src = self.cached_at[:, p:p + 1]
            via_noc = (src >= 0) & (src != owner)
            miss = src < 0
            dram_miss = dram_miss + torch.where(miss, r.per_pred_bytes, 0.0)
            extra_noc_s = extra_noc_s + torch.where(via_noc, ns_pred, 0.0)
            e_noc = e_noc + torch.where(via_noc, ne_pred, 0.0)
            if link is not None:
                link.acquire(src, owner, via_noc, acq_s)
        dram_rd = op["bytes_w"] + dram_miss \
            + (op["bytes_in"] if not r.preds else 0.0)
        # write-back: outputs fitting the owner's cache skip DRAM
        cap_owner = torch.gather(T["cache_cap"], 1, owner)
        dram_wr = _where(cap_owner < op["bytes_out"], op["bytes_out"], 0.0)

        t_start0 = torch.maximum(torch.gather(fin_act, 1, owner), t_dep_act)
        n_active = torch.clamp(
            (self.exists & (fin_act > t_start0)).sum(
                dim=1, keepdim=True).to(F64), min=1.0)
        bw_share = _div(self.chip["dram_gbps"], n_active)

        # single-tile execution on ALL tiles, select owner
        ex = cm.execute_dynamic(cm.execute_static_cls(T, op, r.cls), T,
                                bw_share, dram_rd, dram_wr)
        sec_owner = torch.gather(ex["seconds"], 1, owner)
        fin_single = t_start0 + extra_noc_s + sec_owner
        onehot = tidx == owner
        onehot_f = onehot.to(F64)
        e_single = torch.gather(ex["energy_total"], 1, owner)

        if r.may_split:
            # split execution (mirrors orchestrator._run_split)
            ex_sub = cm.execute_dynamic(cm.execute_static_mac(T, sub), T,
                                        bw_share, _div(dram_rd, kf),
                                        _div(dram_wr, kf))
            starts_sub = torch.maximum(fin_act, t_dep_act) + extra_noc_s
            fins_sub = torch.where(mac_mask, starts_sub + ex_sub["seconds"],
                                   -torch.inf)
            slice_out = _div(op["bytes_out"], kf)
            reduce_s = self._noc_seconds(slice_out)
            fin_split = fins_sub.max(dim=1, keepdim=True).values + reduce_s
            e_split = torch.where(mac_mask, ex_sub["energy_total"], 0.0).sum(
                dim=1, keepdim=True) \
                + (kf - 1.0) * self._noc_energy(slice_out)
            fin_op = torch.where(do_split, fin_split, fin_single)
            e_op = torch.where(do_split, e_split, e_single) + e_noc
        else:
            fin_op = fin_single
            e_op = e_single + e_noc
        # unmappable op (the oracle raises UnmappableError) -> inf latency
        fin_op = torch.where(compat.any(dim=1, keepdim=True), fin_op,
                             torch.inf)
        # PPM energy of fused children + Eq. 6 refund
        e_op = e_op + r.fused_lane_ops * c.e_dsp_pj_per_lane_op \
            - r.fused_refund_bytes * c.e_sram_pj_per_byte

        # ---------- state update ----------
        new_fin_act = torch.where(onehot, fin_single, fin_act)
        new_fin_est = torch.where(onehot, choice_fin_est, fin_est)
        busy_op = onehot_f * sec_owner
        if r.may_split:
            split_mask = do_split & mac_mask
            new_fin_act = torch.where(split_mask, fins_sub, new_fin_act)
            new_fin_act = torch.where(do_split & onehot,
                                      torch.maximum(new_fin_act, fin_split),
                                      new_fin_act)
            new_fin_est = torch.where(
                split_mask, torch.maximum(fin_est, choice_fin_est),
                new_fin_est)
            self.tile_ops = self.tile_ops + torch.where(
                do_split, mac_mask.to(F64), onehot_f)
            busy_op = torch.where(
                do_split, torch.where(mac_mask, ex_sub["seconds"], 0.0),
                busy_op)
            dram_b_op = torch.where(
                do_split, torch.where(mac_mask, ex_sub["dram_bytes"],
                                      0.0).sum(dim=1, keepdim=True),
                ex["dram_bytes"])
            noc_s_op = extra_noc_s + torch.where(do_split, reduce_s, 0.0)
        else:
            self.tile_ops = self.tile_ops + onehot_f
            dram_b_op = ex["dram_bytes"]
            noc_s_op = extra_noc_s
        self.fin_act, self.fin_est = new_fin_act, new_fin_est
        self.opf_est[:, idx:idx + 1] = choice_fin_est
        self.opf_act[:, idx:idx + 1] = fin_op
        self.op_tile[:, idx:idx + 1] = owner
        self.energy = self.energy + e_op
        # throughput-mode II state: per-tile busy time plus shared
        # DRAM-byte / NoC-second occupancy on this scan's placements
        self.tile_busy = self.tile_busy + busy_op
        self.dram_occ = self.dram_occ + dram_b_op
        self.noc_occ = self.noc_occ + noc_s_op
        if link is not None:
            if r.may_split:
                link.reduce(split_mask, owner, link.link_seconds(slice_out))
                link.dram_tiles(torch.where(
                    do_split, torch.where(mac_mask, ex_sub["dram_bytes"], 0.0),
                    torch.where(onehot, ex["dram_bytes"], 0.0)))
            else:
                link.dram_owner(owner, ex["dram_bytes"])

        fifo_insert(self.fifo_ops, self.fifo_bytes, self.cached_at, owner,
                    idx, op["bytes_out"], cap_owner)

    def finish(self, total_macs: float) -> Dict[str, torch.Tensor]:
        c, T, chip = self.cm.c, self.T, self.chip
        exists = self.exists
        makespan = self.fin_act.max(dim=1, keepdim=True).values
        resid = _where(self.tile_ops <= 0, c.power_gate_residual, 1.0)
        leak = torch.where(exists, c.leak_mw_per_mm2 * T["area_mm2"]
                           * makespan * resid * 1e9, 0.0).sum(
                               dim=1, keepdim=True)
        energy = self.energy + leak
        achieved = torch.where(makespan > 0,
                               _div(_div(total_macs, makespan), 1e12), 0.0)
        # throughput-mode steady state (the exact backends' composition,
        # over this scan's placements); unmappable candidates keep inf
        leak_rate = torch.where(exists, c.leak_mw_per_mm2 * T["area_mm2"]
                                * resid * 1e9, 0.0).sum(dim=1, keepdim=True)
        bounds = pipeline_bounds(
            makespan, self.tile_busy.max(dim=1, keepdim=True).values,
            self.dram_occ, chip["dram_gbps"], self.noc_occ,
            **(self.link.bounds() if self.link is not None else {}))
        finite = torch.isfinite(makespan)
        ii = torch.where(finite, bounds["ii_s"], torch.inf)
        energy_ss = torch.where(
            finite, steady_state_energy(energy, leak, leak_rate, ii),
            torch.inf)
        tops_ss = torch.where(torch.isfinite(ii) & (ii > 0),
                              _div(_div(total_macs, ii), 1e12), 0.0)
        out = {"latency_s": makespan, "energy_pj": energy,
               "achieved_tops": achieved, "ii_s": ii,
               "energy_ss_pj": energy_ss, "achieved_tops_ss": tops_ss,
               "fill_latency_s": makespan}
        return {k: v.reshape(-1) for k, v in out.items()}


def batch_evaluate(ws: Dict[str, np.ndarray],
                   cfgs: Dict[str, Dict[str, np.ndarray]],
                   calib: CalibrationTable = DEFAULT_CALIB,
                   fidelity: str = "aggregate", device=None,
                   placed=None) -> Dict[str, np.ndarray]:
    """Evaluate every config in ``cfgs`` against workload ``ws`` with the
    scan's in-scan mapping.

    Returns (B,) numpy arrays: ``latency_s``, ``energy_pj``,
    ``achieved_tops``, ``ii_s``, ``energy_ss_pj``, ``achieved_tops_ss``,
    ``fill_latency_s`` (an unmappable candidate scores inf latency, II and
    energy), and ``area_mm2`` / ``peak_tops`` passed through from
    ``cfgs``.  ``device`` is where the candidates are evaluated (default:
    the card; raises without one unless ``"cpu"`` is asked for);
    ``placed`` reuses a ``simulator.batched.place_configs`` result.
    """
    check_fidelity(fidelity)
    device = resolve_device(device)
    T, chip = placed if placed is not None else place_configs(cfgs, device)
    scan = _Scan(cost_model(calib, device), T, chip, len(ws["op_type"]),
                 fidelity)
    for r in op_rows(ws):
        scan.step(r)
    res = {k: v.cpu().numpy()
           for k, v in scan.finish(float(ws["total_macs"])).items()}
    res["area_mm2"] = cfgs["chip"]["chip_area"]
    res["peak_tops"] = cfgs["chip"]["peak_tops"]
    return res
