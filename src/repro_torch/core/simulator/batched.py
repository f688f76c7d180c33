"""Candidate-batched plan executor: ``ChipSim.run`` on (B, MAX_TILES) tensors.

Port of ``repro/core/simulator/batched.py``.  The reference runs one
``lax.scan`` over operators, ``vmap``-ed over candidates.  Here the scan
is a Python loop over the workload's op rows, and the candidate axis is
written out: per-tile state is a ``(B, MAX_TILES)`` tensor, per-candidate
scalars are ``(B, 1)`` tensors.

The op table is shared by every candidate (the reference's
``vmap in_axes=None`` for the workload arrays), so each row's fields are
host floats, and every predicate that depends only on the workload --
``valid``, ``fused``, ``op_cls``, the predecessor list, whether the row
can be split at all -- is a Python branch instead of a ``where`` over
every class.  The taken branch gives the same bits at a fraction of the
kernel launches; padding and fused rows launch nothing.

Semantics are the exact orchestrator rules: dynamic DRAM bandwidth
sharing, the byte- and slot-bounded FIFO activation cache
(``fifo_insert``), power gating at the 5 % residual and Eq. 3 split
execution with the explicit NoC reduce.  On the link fidelity tier the
executor also accumulates the per-link XY-routed NoC and per-channel
DRAM occupancy (``LinkOccupancy``), which the scan evaluator
(``dse.batch_eval``) shares.

State tensors are updated in place (the reference's carry is
immutable); nothing outside the ``PlanExecutor`` holds them.

Two kinds of caller feed the executor.  The batched mappers
(``compiler.batched_mapper``) place each row as they go.  The plan-table
surface (``stack_plan_tables``, ``batch_simulate``, ``simulate_plans``)
executes plans compiled on the host (``compiler.pipeline.lower_plan``):
candidates whose op tables are equal share one executor, and each
group's placement arrays are uploaded once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ..arch import MAX_TILES, ChipConfig
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..ir import OpClass, PlanTensor
from .area import chip_area, tile_area
from .costs import (ACT_CACHE_SLOTS, CACHE_FRAC, F64, MAX_DRAM_CHANNELS,
                    MAX_LINKS, OP_COST_KEYS, CostModel, _div, _where,
                    cost_model, dram_channel_one_hot, grid_dims,
                    noc_transfer_energy_pj, noc_transfer_seconds,
                    pipeline_bounds, split_op_fields, steady_state_energy,
                    xy_route_link_mask)
from .orchestrator import SCHEDULE_MODES, check_fidelity, noc_hops

__all__ = ["stack_chip_configs", "stack_plan_tables", "batch_simulate",
           "simulate_plans", "place_configs", "fifo_insert",
           "PlanExecutor", "LinkOccupancy", "op_rows", "OpRow", "TILE_KEYS",
           "CHIP_KEYS"]

TILE_KEYS = ("exists", "num_macs", "rows", "cols", "engine", "prec_mask",
             "asym_mac", "sparsity", "dataflow", "sram_kb", "dsp_lanes",
             "dsp_count", "sfu_mask", "sfu_parallel", "double_buffer",
             "pipeline_depth", "clock_hz", "cache_cap", "sram_bpc",
             "area_mm2", "max_prec")
CHIP_KEYS = ("dram_gbps", "hops", "noc_bpc", "noc_base_cycles",
             "ref_clock_hz", "grid_w", "grid_h", "torus", "dram_channels")

# the per-op fields of a stacked plan table (the reference's, and
# ``splittable``, which the executor's split test reads)
_OP_TABLE_KEYS = OP_COST_KEYS + (
    "valid", "fused", "num_preds", "per_pred_bytes", "fused_lane_ops",
    "fused_refund_bytes", "splittable")

_ENERGY_KEYS = (("compute", "e_compute"), ("dram", "e_dram"),
                ("sram", "e_sram"), ("irf", "e_irf"), ("orf", "e_orf"),
                ("dsp", "e_dsp"), ("special", "e_special"))


# =============================================================================
# host-side stacking
# =============================================================================

def stack_chip_configs(chips: Sequence[ChipConfig],
                       calib: CalibrationTable = DEFAULT_CALIB
                       ) -> Dict[str, Dict[str, np.ndarray]]:
    """Stack chips into (B, MAX_TILES) tile / (B,) chip numpy arrays (the
    layout ``dse.engine.genomes_to_configs`` also emits)."""
    B = len(chips)
    tile_f = {f: np.zeros((B, MAX_TILES)) for f in TILE_KEYS}
    chip_f = {f: np.zeros(B) for f in CHIP_KEYS + ("peak_tops", "chip_area")}
    for b, chip in enumerate(chips):
        inst = chip.instances()
        for i, t in enumerate(inst):
            tile_f["exists"][b, i] = 1.0
            tile_f["num_macs"][b, i] = t.num_macs
            tile_f["rows"][b, i] = t.rows
            tile_f["cols"][b, i] = t.cols
            tile_f["engine"][b, i] = int(t.engine)
            tile_f["prec_mask"][b, i] = t.precision_mask
            tile_f["asym_mac"][b, i] = int(t.asym_mac)
            tile_f["sparsity"][b, i] = int(t.sparsity)
            tile_f["dataflow"][b, i] = int(t.dataflow)
            tile_f["sram_kb"][b, i] = t.sram_kb
            tile_f["dsp_lanes"][b, i] = t.dsp_count * t.dsp_simd
            tile_f["dsp_count"][b, i] = t.dsp_count
            tile_f["sfu_mask"][b, i] = t.sfu_mask
            tile_f["sfu_parallel"][b, i] = t.sfu_parallel
            tile_f["double_buffer"][b, i] = float(t.double_buffer)
            tile_f["pipeline_depth"][b, i] = t.pipeline_depth
            tile_f["clock_hz"][b, i] = t.clock_mhz * 1e6
            tile_f["cache_cap"][b, i] = t.sram_kb * 1024.0 * CACHE_FRAC
            tile_f["sram_bpc"][b, i] = max(t.sram_banks, 1) * 16.0
            tile_f["area_mm2"][b, i] = tile_area(t, calib)
            tile_f["max_prec"][b, i] = int(t.max_precision)
        chip_f["dram_gbps"][b] = chip.dram_gbps
        chip_f["hops"][b] = noc_hops(chip.interconnect, len(inst))
        chip_f["noc_bpc"][b] = chip.noc_bytes_per_cycle
        chip_f["noc_base_cycles"][b] = chip.noc_base_cycles
        chip_f["ref_clock_hz"][b] = chip.ref_clock_mhz * 1e6
        gw, gh = grid_dims(float(len(inst)), chip.grid_aspect)
        chip_f["grid_w"][b] = gw
        chip_f["grid_h"][b] = gh
        chip_f["torus"][b] = float(chip.torus)
        chip_f["dram_channels"][b] = chip.dram_channels
        chip_f["peak_tops"][b] = sum(t.num_macs * t.clock_mhz * 1e6
                                     for t in inst) / 1e12
        chip_f["chip_area"][b] = chip_area(chip, calib)
    return {"tile": tile_f, "chip": chip_f}


def stack_plan_tables(tables: Sequence[PlanTensor]) -> Dict[str, np.ndarray]:
    """Stack per-candidate plan tables into (B, max_ops, ...) arrays.

    All tables must share ``max_ops`` (lower them with the same bucket)
    and schedule mode; they may come from different workloads.  Split
    masks are padded from each chip's ``num_tiles`` to MAX_TILES.
    """
    if not tables:
        raise ValueError("stack_plan_tables needs at least one plan table")
    caps = {t.max_ops for t in tables}
    if len(caps) != 1:
        raise ValueError(f"plan tables disagree on max_ops: {sorted(caps)}")
    (cap,) = caps
    modes = {t.mode for t in tables}
    if len(modes) != 1:
        raise ValueError(f"plan tables disagree on schedule mode: "
                         f"{sorted(modes)}")
    B = len(tables)
    out: Dict[str, np.ndarray] = {}
    for f in _OP_TABLE_KEYS:
        src = [t.aux[f] if f in t.aux else t.ops.arrays[f] for t in tables]
        out[f] = np.stack([np.asarray(a, np.float64) for a in src])
    out["preds"] = np.stack([t.ops.preds for t in tables]).astype(np.int32)
    out["owner"] = np.stack([t.owner for t in tables]).astype(np.int32)
    out["n_split"] = np.stack([t.n_split for t in tables]).astype(np.float64)
    out["split_axis"] = np.stack([t.split_axis
                                  for t in tables]).astype(np.int32)
    mask = np.zeros((B, cap, MAX_TILES), np.float64)
    for b, t in enumerate(tables):
        mask[b, :, :t.split_mask.shape[1]] = t.split_mask
    out["split_mask"] = mask
    out["total_macs"] = np.asarray([t.aux["total_macs"] for t in tables],
                                   np.float64)
    out["mode"] = modes.pop()
    return out


def place_configs(cfgs: Dict[str, Dict[str, np.ndarray]],
                  device: torch.device) -> Tuple[Dict[str, torch.Tensor],
                                                 Dict[str, torch.Tensor]]:
    """Upload a stacked config dict once: tile fields as (B, MAX_TILES)
    float64 tensors, chip fields as (B, 1)."""
    tile = {k: torch.as_tensor(np.ascontiguousarray(cfgs["tile"][k]),
                               dtype=F64).to(device) for k in TILE_KEYS}
    chip = {k: torch.as_tensor(np.ascontiguousarray(cfgs["chip"][k]),
                               dtype=F64).reshape(-1, 1).to(device)
            for k in CHIP_KEYS}
    return tile, chip


# =============================================================================
# the workload's op rows as host records
# =============================================================================

@dataclasses.dataclass(frozen=True)
class OpRow:
    """One active (valid, not fused away) row of a prepared workload."""

    index: int
    cls: int
    op: Dict[str, float]          # OP_COST_KEYS as host floats
    preds: Tuple[int, ...]        # valid predecessor indices, slot order
    per_pred_bytes: float
    fused_lane_ops: float
    fused_refund_bytes: float
    splittable: bool

    @property
    def may_split(self) -> bool:
        """The workload-static half of the mapper's Eq. 3 split test."""
        return self.cls == int(OpClass.MAC) and self.splittable \
            and self.op["macs"] > 0


def op_rows(ws: Dict[str, np.ndarray]) -> List[OpRow]:
    """Active rows of a prepared workload (``dse.batch_eval
    .prepare_workload``), in op order.  Padding and fused rows are left
    out: the reference's scans leave every piece of state untouched on
    them."""
    rows = []
    for i in range(len(ws["op_type"])):
        if not (ws["valid"][i] > 0 and ws["fused"][i] == 0):
            continue
        rows.append(OpRow(
            index=i, cls=int(ws["op_cls"][i]),
            op={f: float(ws[f][i]) for f in OP_COST_KEYS},
            preds=tuple(int(p) for p in ws["preds"][i] if p >= 0),
            per_pred_bytes=float(ws["per_pred_bytes"][i]),
            fused_lane_ops=float(ws["fused_lane_ops"][i]),
            fused_refund_bytes=float(ws["fused_refund_bytes"][i]),
            splittable=bool(ws["splittable"][i] > 0)))
    return rows


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for (B, S) x and (B, 1) idx -> (B, 1)."""
    return torch.gather(x, 1, idx)


# =============================================================================
# FIFO activation cache
# =============================================================================

def fifo_insert(fifo_ops: torch.Tensor, fifo_bytes: torch.Tensor,
                cached_at: torch.Tensor, tile: torch.Tensor, op_idx: int,
                nbytes: float, cap: torch.Tensor) -> None:
    """Insert op ``op_idx``'s output (``nbytes``) into each candidate's
    ``tile`` FIFO row, evicting oldest-first until it fits in bytes
    (``cap``, (B, 1)) and slots.  In place.

    ``fifo_ops`` / ``fifo_bytes`` are (B, MAX_TILES, ACT_CACHE_SLOTS),
    right-packed (newest at the last slot, -1 / 0.0 padding on the left);
    ``cached_at`` is (B, max_ops + 1) op -> holding tile (-1 when absent),
    whose last column absorbs the scatter of non-evicted slots.  Mirrors
    the reference's ``fifo_insert`` (itself the array form of
    ``costs.ActivationCache.insert``).
    """
    B, _, S = fifo_ops.shape
    dev = fifo_ops.device
    rows = torch.arange(B, device=dev)
    t = tile.reshape(-1)
    row_ops = fifo_ops[rows, t]                    # (B, S)
    row_b = fifo_bytes[rows, t]
    count = (row_ops >= 0).sum(dim=1, keepdim=True)
    # rem[j] = bytes kept when slots [j:] survive; monotone nonincreasing
    rem = torch.cat([row_b.flip(1).cumsum(1).flip(1),
                     torch.zeros((B, 1), dtype=F64, device=dev)], dim=1)
    fits = rem + nbytes <= cap
    a = torch.maximum(fits.to(torch.int8).argmax(dim=1, keepdim=True),
                      S - count)                   # first surviving slot
    a = torch.maximum(a, (count == S).long())      # full row: evict >= 1
    do = cap >= nbytes                             # (B, 1)

    shifted_ops = torch.cat(
        [row_ops[:, 1:], torch.full((B, 1), op_idx, dtype=row_ops.dtype,
                                    device=dev)], dim=1)
    shifted_b = torch.cat(
        [row_b[:, 1:], torch.full((B, 1), nbytes, dtype=F64, device=dev)],
        dim=1)
    pos = torch.arange(S, device=dev)
    keep_pos = pos >= a - 1
    new_ops = torch.where(keep_pos, shifted_ops, -1)
    new_b = torch.where(keep_pos, shifted_b, 0.0)

    evicted = (pos >= S - count) & (pos < a) & do
    drop = cached_at.shape[1] - 1
    cached_at.scatter_(1, torch.where(evicted, row_ops, drop), -1)
    cached_at[:, op_idx] = torch.where(do.reshape(-1), t,
                                       cached_at[:, op_idx])
    fifo_ops[rows, t] = torch.where(do, new_ops, row_ops)
    fifo_bytes[rows, t] = torch.where(do, new_b, row_b)


# =============================================================================
# link-fidelity occupancy (mirrors the oracle walk's link_occ / chan_occ)
# =============================================================================

class LinkOccupancy:
    """The link tier's per-batch occupancy of B candidates: ``link``
    (B, MAX_LINKS) XY-routed NoC seconds and ``chan`` (B,
    MAX_DRAM_CHANNELS) DRAM bytes.  Each candidate's routes (src, dst)
    and channel selectors are tabulated once, so a row only gathers.

    The reference adds a route for every predecessor slot and every tile
    of a split; hit, miss and padding slots and the owner's own route are
    empty and add exact zeros, so skipping them keeps the bits, and the
    additions that remain run in the reference's order."""

    def __init__(self, chip: Dict[str, torch.Tensor]):
        B = chip["grid_w"].shape[0]
        dev = chip["grid_w"].device
        t = torch.arange(MAX_TILES, dtype=F64, device=dev)
        grid = [chip[k][:, :, None] for k in ("grid_w", "grid_h", "torus")]
        # (B, src * MAX_TILES + dst, MAX_LINKS)
        self.routes = xy_route_link_mask(t[None, :, None], t[None, None, :],
                                         *grid).reshape(B, -1, MAX_LINKS)
        # (B, tile, MAX_DRAM_CHANNELS)
        self.chan_onehot = dram_channel_one_hot(t[None, :],
                                                chip["dram_channels"])
        self.chip = chip
        self.link = torch.zeros((B, MAX_LINKS), dtype=F64, device=dev)
        self.chan = torch.zeros((B, MAX_DRAM_CHANNELS), dtype=F64,
                                device=dev)

    def link_seconds(self, nbytes):
        """One grid link's store-and-forward occupancy (hops = 1)."""
        chip = self.chip
        return noc_transfer_seconds(nbytes, chip["noc_bpc"], 1.0,
                                    chip["noc_base_cycles"],
                                    chip["ref_clock_hz"])

    def _route(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """(B, MAX_LINKS) route of each candidate's (src, dst), both
        (B, 1) int64 >= 0."""
        idx = (src * MAX_TILES + dst)[:, :, None].expand(-1, 1, MAX_LINKS)
        return torch.gather(self.routes, 1, idx)[:, 0, :]

    def acquire(self, src: torch.Tensor, owner: torch.Tensor,
                via_noc: torch.Tensor, seconds: torch.Tensor) -> None:
        """One predecessor's cross-tile fetch from ``src`` to ``owner``
        where ``via_noc``, each link of the route busy ``seconds``."""
        rt = self._route(torch.clamp(src, min=0), owner)
        self.link = self.link + torch.where(via_noc, rt * seconds, 0.0)

    def reduce(self, split_mask: torch.Tensor, owner: torch.Tensor,
               seconds: torch.Tensor) -> None:
        """A split's reduce: every tile of ``split_mask`` (B, MAX_TILES)
        sends its output slice to ``owner``, in tile order."""
        B = owner.shape[0]
        idx = owner[:, :, None, None].expand(-1, MAX_TILES, 1, MAX_LINKS)
        red = torch.gather(self.routes.reshape(B, MAX_TILES, MAX_TILES,
                                               MAX_LINKS), 2, idx)[:, :, 0]
        red = red * seconds[:, :, None]
        for t in range(MAX_TILES):
            self.link = self.link + torch.where(split_mask[:, t:t + 1],
                                                red[:, t], 0.0)

    def dram_owner(self, owner: torch.Tensor,
                   dram_bytes: torch.Tensor) -> None:
        """One tile's DRAM bytes on its channel (the other tiles of the
        reference's per-tile loop add zeros)."""
        idx = owner[:, :, None].expand(-1, 1, MAX_DRAM_CHANNELS)
        oh = torch.gather(self.chan_onehot, 1, idx)[:, 0, :]
        self.chan = self.chan + dram_bytes * oh

    def dram_tiles(self, dram_each: torch.Tensor) -> None:
        """Per-tile DRAM bytes (B, MAX_TILES) on their channels, in tile
        order."""
        for t in range(MAX_TILES):
            self.chan = self.chan + dram_each[:, t:t + 1] \
                * self.chan_onehot[:, t]

    def bounds(self) -> Dict[str, torch.Tensor]:
        """``pipeline_bounds``' link-tier arguments."""
        return {"chan_bytes": self.chan,
                "dram_channels": self.chip["dram_channels"],
                "link_busy_s": self.link}


# =============================================================================
# the plan-execution loop (mirrors ChipSim.run op for op)
# =============================================================================

class PlanExecutor:
    """``ChipSim.run``'s state for B candidates, advanced one op row at a
    time by :meth:`step` and reduced to the result surface by
    :meth:`finish`.  ``compiler.batched_mapper._search_one`` feeds it
    each row's placement as the mapper makes it.  ``T`` may carry a
    ``_cache`` dict shared with the mapper (the cached terms are functions
    of the tiles alone).  ``fidelity="link"`` adds the link tier's
    occupancy (``self.link``, a ``LinkOccupancy``; None on the aggregate
    tier, which allocates and launches nothing for it)."""

    def __init__(self, cm: CostModel, T: Dict[str, torch.Tensor],
                 chip: Dict[str, torch.Tensor], max_ops: int,
                 fidelity: str = "aggregate"):
        self.cm, self.chip = cm, chip
        self.link = LinkOccupancy(chip) if fidelity == "link" else None
        B = T["exists"].shape[0]
        dev = self.dev = T["exists"].device
        # tile x precision / sparsity terms, per evaluation
        self.T = T if "_cache" in T else dict(T, _cache={})
        self.B = B
        self.tidx = torch.arange(MAX_TILES, device=dev)
        self.exists = T["exists"] > 0
        zt = self._zt
        self.tile_finish = zt()
        self.op_finish = torch.zeros((B, max_ops), dtype=F64, device=dev)
        self.cached_at = torch.full((B, max_ops + 1), -1, dtype=torch.long,
                                    device=dev)
        self.fifo_ops = torch.full((B, MAX_TILES, ACT_CACHE_SLOTS), -1,
                                   dtype=torch.long, device=dev)
        self.fifo_bytes = torch.zeros((B, MAX_TILES, ACT_CACHE_SLOTS),
                                      dtype=F64, device=dev)
        self.tile_ops, self.tile_active, self.tile_macs = zt(), zt(), zt()
        self.e_mod = {m: self._z1() for m in (
            "compute", "dram", "sram", "irf", "orf", "dsp", "special", "noc",
            "fuse_savings")}
        self.ev_hit, self.ev_noc, self.ev_miss = self._z1(), self._z1(), \
            self._z1()
        self.dram_occ, self.noc_occ = self._z1(), self._z1()

    def _z1(self):
        return torch.zeros((self.B, 1), dtype=F64, device=self.dev)

    def _zt(self):
        return torch.zeros((self.B, MAX_TILES), dtype=F64, device=self.dev)

    def _noc_seconds(self, nbytes):
        chip = self.chip
        return noc_transfer_seconds(nbytes, chip["noc_bpc"], chip["hops"],
                                    chip["noc_base_cycles"],
                                    chip["ref_clock_hz"])

    def _noc_energy(self, nbytes):
        return noc_transfer_energy_pj(nbytes, self.cm.c.e_noc_pj_per_byte_hop,
                                      self.chip["hops"])

    def step(self, r: OpRow, owner: torch.Tensor,
             n_split: torch.Tensor = None, split_axis: torch.Tensor = None,
             split_mask: torch.Tensor = None) -> None:
        """Execute row ``r`` placed on ``owner`` ((B, 1) int64, >= 0).
        Rows whose ``may_split`` is True also take the Eq. 3 placement:
        ``n_split`` (B, 1) float64, ``split_axis`` (B, 1) int64 and
        ``split_mask`` (B, MAX_TILES) bool; the others were placed on one
        tile by construction, so their split arm is not evaluated."""
        cm, T, chip = self.cm, self.T, self.chip
        c = cm.c
        z1 = self._z1
        op, idx = r.op, r.index
        onehot = self.tidx == owner
        tile_finish = self.tile_finish

        # ---- dependency-ready time + input acquisition ------------------
        t_dep = z1()
        dram_miss = z1()
        extra_noc_s = z1()
        e_noc_in = z1()
        ns_pred = self._noc_seconds(r.per_pred_bytes) if r.preds else None
        ne_pred = self._noc_energy(r.per_pred_bytes) if r.preds else None
        link = self.link
        if link is not None and r.preds:
            acq_s = link.link_seconds(r.per_pred_bytes)
        for p in r.preds:
            t_dep = torch.maximum(t_dep, self.op_finish[:, p:p + 1])
            src = self.cached_at[:, p:p + 1]
            hit = src == owner
            via_noc = (src >= 0) & (src != owner)
            miss = src < 0
            dram_miss = dram_miss + _where(miss, r.per_pred_bytes, 0.0)
            extra_noc_s = extra_noc_s + torch.where(via_noc, ns_pred, 0.0)
            e_noc_in = e_noc_in + torch.where(via_noc, ne_pred, 0.0)
            if link is not None:
                link.acquire(src, owner, via_noc, acq_s)
            self.ev_hit += hit
            self.ev_noc += via_noc
            self.ev_miss += miss
        dram_rd = op["bytes_w"] + dram_miss \
            + (op["bytes_in"] if not r.preds else 0.0)
        # write-back: outputs fitting the owner's cache partition skip
        # the DRAM round-trip; oversized outputs spill (§3.3.4)
        cap_owner = _gather(T["cache_cap"], owner)
        dram_wr = _where(cap_owner < op["bytes_out"], op["bytes_out"], 0.0)

        # ---- dynamic DRAM bandwidth share --------------------------------
        t_start0 = torch.maximum(_gather(tile_finish, owner), t_dep)
        n_active = torch.clamp(
            (self.exists & (tile_finish > t_start0)).sum(
                dim=1, keepdim=True).to(F64), min=1.0)
        bw_share = _div(chip["dram_gbps"], n_active)

        # ---- single-tile execution (on all tiles; owner selected) --------
        ex = cm.execute_dynamic(cm.execute_static_cls(T, op, r.cls), T,
                                bw_share, dram_rd, dram_wr)
        sec_owner = _gather(ex["seconds"], owner)
        fin_single = t_start0 + extra_noc_s + sec_owner

        if r.may_split:
            # ---- Eq. 3 split execution (slice_op semantics) -------------
            k = n_split
            mask = split_mask
            is_split = k > 1.0
            kf = torch.clamp(k, min=1.0)
            sub = split_op_fields(op, split_axis, kf)
            ex_sub = cm.execute_dynamic(cm.execute_static_mac(T, sub), T,
                                        bw_share, _div(dram_rd, kf),
                                        _div(dram_wr, kf))
            starts_sub = torch.maximum(tile_finish, t_dep) + extra_noc_s
            fins_sub = torch.where(mask, starts_sub + ex_sub["seconds"],
                                   -torch.inf)
            slice_out = _div(op["bytes_out"], kf)
            reduce_s = self._noc_seconds(slice_out)
            fin_split = fins_sub.max(dim=1, keepdim=True).values + reduce_s
            e_noc_split = (kf - 1.0) * self._noc_energy(slice_out)
            fin_op = torch.where(is_split, fin_split, fin_single)

            tf_single = torch.where(onehot, fin_single, tile_finish)
            tf_split = torch.where(mask, fins_sub, tile_finish)
            tf_split = torch.where(onehot,
                                   torch.maximum(tf_split, fin_split),
                                   tf_split)
            self.tile_finish = torch.where(is_split, tf_split, tf_single)
            exec_mask = torch.where(is_split, mask, onehot)
            sec_each = torch.where(is_split, ex_sub["seconds"],
                                   ex["seconds"])
            macs_each = _where(is_split, sub["macs"], op["macs"])
        else:
            fin_op = fin_single
            self.tile_finish = torch.where(onehot, fin_single, tile_finish)
            exec_mask = onehot
            sec_each = ex["seconds"]
            macs_each = op["macs"]
        self.tile_ops += exec_mask
        self.tile_active += torch.where(exec_mask, sec_each, 0.0)
        self.tile_macs += _where(exec_mask, macs_each, 0.0)

        # ---- per-module chip energy --------------------------------------
        e_mod = self.e_mod
        for mod, key in _ENERGY_KEYS:
            single_v = ex[key] if key == "e_dram" else _gather(ex[key], owner)
            if r.may_split:
                split_v = torch.where(mask, ex_sub[key], 0.0).sum(
                    dim=1, keepdim=True)
                single_v = torch.where(is_split, split_v, single_v)
            e_mod[mod] = e_mod[mod] + single_v
        if r.may_split:
            e_noc_in = e_noc_in + torch.where(is_split, e_noc_split, 0.0)
        e_mod["noc"] = e_mod["noc"] + e_noc_in
        # PPM energy of fused children + Eq. 6 refund, credited to the head
        e_mod["dsp"] = e_mod["dsp"] + r.fused_lane_ops * c.e_dsp_pj_per_lane_op
        e_mod["fuse_savings"] = e_mod["fuse_savings"] \
            + r.fused_refund_bytes * c.e_sram_pj_per_byte

        # ---- shared-resource occupancy (throughput-mode II inputs) ------
        dram_b_op = ex["dram_bytes"]
        noc_s_op = extra_noc_s
        if r.may_split:
            split_b = torch.where(mask, ex_sub["dram_bytes"], 0.0).sum(
                dim=1, keepdim=True)
            dram_b_op = torch.where(is_split, split_b, dram_b_op)
            noc_s_op = noc_s_op + torch.where(is_split, reduce_s, 0.0)
        self.dram_occ = self.dram_occ + dram_b_op
        self.noc_occ = self.noc_occ + noc_s_op
        if link is not None:
            if r.may_split:
                link.reduce(is_split & mask, owner,
                            link.link_seconds(slice_out))
                link.dram_tiles(torch.where(
                    is_split, torch.where(mask, ex_sub["dram_bytes"], 0.0),
                    torch.where(onehot, ex["dram_bytes"], 0.0)))
            else:
                link.dram_owner(owner, ex["dram_bytes"])

        self.op_finish[:, idx:idx + 1] = fin_op
        fifo_insert(self.fifo_ops, self.fifo_bytes, self.cached_at, owner,
                    idx, op["bytes_out"], cap_owner)

    def finish(self, total_macs: float) -> Dict[str, torch.Tensor]:
        """The result surface after the last row: (B,) tensors, and
        ``(B, MAX_TILES)`` / ``(B, max_ops)`` for the per-tile and per-op
        stats (the reference's ``batch_simulate`` surface)."""
        c, T, chip, e_mod = self.cm.c, self.T, self.chip, self.e_mod
        exists = self.exists
        tile_ops, tile_active = self.tile_ops, self.tile_active
        makespan = self.tile_finish.max(dim=1, keepdim=True).values
        gated = tile_ops <= 0
        resid = _where(gated, c.power_gate_residual, 1.0)
        leak_t = torch.where(exists, c.leak_mw_per_mm2 * T["area_mm2"]
                             * makespan * resid * 1e9, 0.0)
        leakage = leak_t.sum(dim=1, keepdim=True)
        energy = (e_mod["compute"] + e_mod["dram"] + e_mod["sram"]
                  + e_mod["irf"] + e_mod["orf"] + e_mod["dsp"]
                  + e_mod["special"] + e_mod["noc"] + leakage
                  - e_mod["fuse_savings"])
        achieved = torch.where(makespan > 0,
                               _div(_div(total_macs, makespan), 1e12), 0.0)
        out = {"latency_s": makespan, "energy_pj": energy,
               "achieved_tops": achieved, "cache_hits": self.ev_hit,
               "cache_noc": self.ev_noc, "cache_misses": self.ev_miss,
               "energy_leakage_pj": leakage}
        for m in e_mod:
            out[f"energy_{m}_pj"] = e_mod[m]

        # ---- throughput-mode steady state (§3.2) ---------------------------
        leak_rate = torch.where(exists, c.leak_mw_per_mm2 * T["area_mm2"]
                                * resid * 1e9, 0.0).sum(dim=1, keepdim=True)
        out.update(pipeline_bounds(
            makespan, tile_active.max(dim=1, keepdim=True).values,
            self.dram_occ, chip["dram_gbps"], self.noc_occ,
            **(self.link.bounds() if self.link is not None else {})))
        ii = out["ii_s"]
        out["fill_latency_s"] = makespan
        out["dram_bytes_per_batch"] = self.dram_occ
        out["energy_ss_pj"] = steady_state_energy(energy, leakage, leak_rate,
                                                  ii)
        out["achieved_tops_ss"] = torch.where(
            ii > 0, _div(_div(total_macs, ii), 1e12), 0.0)
        out["pipeline_depth"] = torch.where(ii > 0,
                                            torch.ceil(_div(makespan, ii)),
                                            1.0)
        out = {k: v.reshape(-1) for k, v in out.items()}
        out.update({"op_finish": self.op_finish, "tile_ops": tile_ops,
                    "tile_active_s": tile_active,
                    "tile_macs": self.tile_macs, "power_gated": gated,
                    "tile_leakage_pj": leak_t})
        return out


# =============================================================================
# the plan-table surface: host-compiled plans on the executor
# =============================================================================

def _plan_groups(plans: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """Candidate indices grouped by equal op tables (workload fields,
    predecessors and total MACs), in order of first appearance."""
    B = plans["op_type"].shape[0]
    keys: Dict[bytes, List[int]] = {}
    fields = [plans[f] for f in _OP_TABLE_KEYS + ("preds", "total_macs")]
    for b in range(B):
        key = b"".join(np.ascontiguousarray(a[b]).tobytes() for a in fields)
        keys.setdefault(key, []).append(b)
    return [np.asarray(v, np.int64) for v in keys.values()]


def _group_rows(plans: Dict[str, np.ndarray], b: int) -> List[OpRow]:
    """The active op rows of candidate ``b``'s table (``op_rows`` on its
    fields)."""
    ws = {f: plans[f][b] for f in _OP_TABLE_KEYS}
    ws["preds"] = plans["preds"][b]
    return op_rows(ws)


def _check_placements(plans: Dict[str, np.ndarray], idx: np.ndarray,
                      rows: Sequence[OpRow]) -> None:
    """Every active row has an owner, and only rows the executor can split
    (``OpRow.may_split``, ``map_graph``'s own split test) are split."""
    owner, n_split = plans["owner"][idx], plans["n_split"][idx]
    for r in rows:
        if (owner[:, r.index] < 0).any():
            raise ValueError(f"op {r.index} has no owner tile in some plan")
        if not r.may_split and (n_split[:, r.index] > 1).any():
            raise ValueError(
                f"op {r.index} is split, but only a splittable MAC op with "
                f"MACs can be (map_graph's Eq. 3 test)")


def batch_simulate(plans: Dict[str, np.ndarray],
                   cfgs: Dict[str, Dict[str, np.ndarray]],
                   calib: CalibrationTable = DEFAULT_CALIB,
                   mode: Optional[str] = None,
                   fidelity: str = "aggregate",
                   device=None) -> Dict[str, np.ndarray]:
    """Execute stacked plan tables against stacked chip configs.

    ``plans`` comes from ``stack_plan_tables`` (candidate b's plan must
    target candidate b's chip); ``cfgs`` from ``stack_chip_configs`` (or
    the DSE engine's vectorized genome stack).  Candidates whose op tables
    are equal run through one ``PlanExecutor`` (one ``step`` per active
    row, then ``finish``) on ``device`` (default: the card), with their
    placement arrays uploaded once; the rows are scattered back in order.
    Returns the reference's surface as numpy: (B,) ``latency_s``,
    ``energy_pj``, ``achieved_tops``, per-module ``energy_*_pj``, cache
    event counts, the throughput-mode keys (``ii_s``, ``energy_ss_pj``,
    ...), (B, MAX_TILES) per-tile stats, (B, max_ops) ``op_finish``,
    ``area_mm2``, ``peak_tops`` and ``mode``.

    ``mode`` defaults to the tables' stamped mode; a mode outside
    ``SCHEDULE_MODES`` raises.  ``fidelity="link"`` adds the link tier's
    ``ii_chan_bound_s`` and ``ii_link_bound_s`` and max's them into
    ``ii_s``.
    """
    mode = mode if mode is not None else plans.get("mode", "latency")
    if mode not in SCHEDULE_MODES:
        raise ValueError(
            f"batched executor cannot model schedule mode {mode!r}; "
            f"supported modes: {SCHEDULE_MODES}")
    check_fidelity(fidelity)
    device = resolve_device(device)
    cm = cost_model(calib, device)
    B, max_ops = plans["op_type"].shape
    res: Dict[str, np.ndarray] = {}
    for idx in _plan_groups(plans):
        rows = _group_rows(plans, int(idx[0]))
        _check_placements(plans, idx, rows)
        T, chip = place_configs(
            {"tile": {k: cfgs["tile"][k][idx] for k in TILE_KEYS},
             "chip": {k: cfgs["chip"][k][idx] for k in CHIP_KEYS}}, device)
        owner, n_split, axis, mask = (
            torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(device)
            for a, dt in ((plans["owner"][idx], torch.long),
                          (plans["n_split"][idx], F64),
                          (plans["split_axis"][idx], torch.long),
                          (plans["split_mask"][idx] > 0, torch.bool)))
        ex = PlanExecutor(cm, T, chip, max_ops, fidelity)
        for r in rows:
            i = r.index
            if r.may_split:
                ex.step(r, owner[:, i:i + 1], n_split[:, i:i + 1],
                        axis[:, i:i + 1], mask[:, i, :])
            else:
                ex.step(r, owner[:, i:i + 1])
        out = ex.finish(float(plans["total_macs"][idx[0]]))
        for k, v in out.items():
            v = v.cpu().numpy()
            if k not in res:
                res[k] = np.zeros((B,) + v.shape[1:], v.dtype)
            res[k][idx] = v
    res["area_mm2"] = cfgs["chip"]["chip_area"]
    res["peak_tops"] = cfgs["chip"]["peak_tops"]
    res["mode"] = mode
    return res


def simulate_plans(chips: Sequence[ChipConfig], tables: Sequence[PlanTensor],
                   calib: CalibrationTable = DEFAULT_CALIB,
                   fidelity: str = "aggregate",
                   device=None) -> Dict[str, np.ndarray]:
    """Stack ``chips`` and their ``tables`` and execute them on
    ``device`` (default: the card)."""
    if len(chips) != len(tables):
        raise ValueError("one plan table per chip required")
    return batch_simulate(stack_plan_tables(tables),
                          stack_chip_configs(chips, calib), calib,
                          fidelity=fidelity, device=device)
