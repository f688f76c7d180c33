"""Chip-level orchestrator (paper §3.3.4): executes a compiled plan over a
heterogeneous tile mix with

* dynamic DRAM bandwidth sharing -- only tiles whose previous operator has
  not finished count as active; per-tile bandwidth is BW_total / N_active;
* cross-tile activation caching -- each tile's SRAM splits into a working
  set and a FIFO-evicted activation cache (byte- and slot-bounded, see
  ``costs.ActivationCache``); consumers see a local hit (no DRAM read), a
  cross-tile NoC DMA, or a full DRAM miss;
* clock gating (idle modules draw no dynamic energy -- implicit in the
  per-module accounting) and power gating (tiles with no scheduled work
  leak at a 5 % residual);
* NoC transfer costs and split-op reductions (Eq. 3).

Port of ``repro/core/simulator/orchestrator.py``.  ``ChipSim`` is the
*reference oracle*, and it is host code by design: a per-operator Python
walk over numpy float64 scalars, through a ``CostModel`` built on
``"cpu"``, so it runs without a card and gives the reference oracle's
bits.  What runs on the card is the batched executor fed from the same
plans (``simulator.batched.batch_simulate`` / ``simulate_plans``) and the
engine's ``exact_mapper="python"`` path.  Both fidelity tiers run: the
link tier adds per-link XY-routed NoC and per-channel DRAM occupancy to
the throughput-mode II.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from ..arch import ChipConfig, Interconnect
from ..calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..ir import OpNode, WorkloadGraph, slice_op
from .area import chip_area, tile_area
from .costs import (CACHE_FRAC, FIDELITIES, MAX_DRAM_CHANNELS, MAX_LINKS,
                    OP_COST_KEYS, TILE_COST_KEYS, ActivationCache,
                    cost_model, dram_channel_one_hot, grid_dims,
                    noc_transfer_energy_pj, noc_transfer_seconds,
                    pipeline_bounds, steady_state_energy,
                    xy_route_link_mask)
from .modules import HOST, tile_cost_dict
from .outputs import EnergyBreakdown, OpResult, SimResult, TileBreakdown
from .tile import _PATH_NAME, _ROOFLINE_NAME, OpExec, TileSim, op_cost_dict

__all__ = ["Placement", "ExecutionPlan", "ChipSim", "simulate", "noc_hops",
           "CACHE_FRAC", "SCHEDULE_MODES"]

# The two §3.2 execution modes (re-exported by compiler.schedule).  Lives
# here so the simulators can validate plans without importing the compiler
# package (schedule imports us).
SCHEDULE_MODES = ("latency", "throughput")


@dataclasses.dataclass
class Placement:
    tiles: List[int]
    axis: str = ""  # 'OC' | 'B' | 'IC' when split across len(tiles) > 1


@dataclasses.dataclass
class ExecutionPlan:
    """Compiler output: graph after passes 1-2 plus pass-3 placements."""

    graph: WorkloadGraph
    placements: Dict[int, Placement]
    mode: str = "latency"


def noc_hops(interconnect: Interconnect, num_tiles: int) -> int:
    """Average hop count by interconnect topology."""
    if interconnect == Interconnect.BUS:
        return 1
    if interconnect == Interconnect.RING:
        return max(num_tiles // 4, 1)
    if interconnect == Interconnect.NOC:
        return 2
    return max(int(math.ceil(math.sqrt(num_tiles))), 1)  # mesh


def check_fidelity(fidelity: str) -> None:
    """Refuse an unknown fidelity tier."""
    if fidelity not in FIDELITIES:
        raise ValueError(
            f"unknown fidelity {fidelity!r}; supported: {FIDELITIES}")


class ChipSim:
    """Event-free single-pass orchestrator.

    Ops are visited in topological order (the schedule emitted by compiler
    pass 4 preserves this); per-tile finish times provide the parallelism
    model: distinct-tile assignments overlap, same-tile ops serialize.
    """

    def __init__(self, chip: ChipConfig, calib: CalibrationTable = DEFAULT_CALIB,
                 fidelity: str = "aggregate"):
        check_fidelity(fidelity)
        self.chip = chip
        self.calib = calib
        self.fidelity = fidelity
        self.templates = chip.instances()
        self.tiles = [TileSim(t, calib, CACHE_FRAC) for t in self.templates]
        self.hops = noc_hops(chip.interconnect, len(self.tiles))
        self.ref_clock_hz = chip.ref_clock_mhz * 1e6
        # link-fidelity topology: row-major tile grid + per-tile DRAM
        # channel interleave (precomputed -- the walk only gathers)
        n = len(self.tiles)
        gw, gh = grid_dims(float(n), chip.grid_aspect)
        self.grid_w, self.grid_h = float(gw), float(gh)
        tidx = np.arange(n, dtype=np.float64)
        self._link_mask = xy_route_link_mask(
            tidx[:, None], tidx[None, :], self.grid_w, self.grid_h,
            float(chip.torus))  # (src, dst, MAX_LINKS)
        self._chan_onehot = dram_channel_one_hot(
            tidx, float(chip.dram_channels))  # (tile, MAX_DRAM_CHANNELS)
        # (n_tiles,) tile-field arrays for the vectorized static-cost
        # pre-pass (one CostModel query per plan instead of one scalar
        # query per op -- the per-op walk only runs the DRAM combine)
        self._cm = cost_model(calib, HOST)
        dicts = [tile_cost_dict(t) for t in self.templates]
        self._T = {k: np.asarray([d[k] for d in dicts], np.float64)
                   for k in TILE_COST_KEYS}

    # ------------------------------------------------- vectorized static costs
    def _static_pass(self, plan: ExecutionPlan) -> Tuple[Dict[int, int], dict]:
        """Evaluate ``CostModel.execute_static`` for every (op, tile)
        execution of the plan in one vectorized numpy call.

        Returns ``(rec_of, static)``: ``rec_of[i]`` is the first record
        index of op ``i`` (single placements own one record; a k-way split
        owns k consecutive records, one per placement tile in order), and
        ``static`` the dict of per-record arrays.  Values are bitwise
        identical to per-op scalar ``TileSim.execute`` internals.
        """
        g = plan.graph
        rec_tiles: List[int] = []
        rec_ops: List[Dict[str, float]] = []
        rec_of: Dict[int, int] = {}
        for i, op in enumerate(g.nodes):
            if op.fused_into >= 0:
                continue
            pl = plan.placements[i]
            rec_of[i] = len(rec_tiles)
            if len(pl.tiles) == 1:
                rec_tiles.append(pl.tiles[0])
                rec_ops.append(op_cost_dict(op))
            else:
                sd = op_cost_dict(slice_op(op, pl.axis, len(pl.tiles)))
                for t in pl.tiles:
                    rec_tiles.append(t)
                    rec_ops.append(sd)
        if not rec_tiles:
            return rec_of, {}
        tsel = np.asarray(rec_tiles, np.int64)
        T_rec = {k: self._T[k][tsel] for k in TILE_COST_KEYS}
        op_rec = {k: np.asarray([d[k] for d in rec_ops], np.float64)
                  for k in OP_COST_KEYS}
        static = self._cm.execute_static(T_rec, op_rec, CACHE_FRAC)
        static["clock_hz"] = T_rec["clock_hz"]
        static["double_buffer"] = T_rec["double_buffer"]
        return rec_of, static

    def _exec_rec(self, static: dict, r: int, bw_gbps: float,
                  dram_rd: float, dram_wr: float) -> OpExec:
        """Scalar DRAM/Eq. 5 combine on pre-computed static record ``r``
        (the fast-path twin of ``TileSim.execute``)."""
        st = {k: static[k][r] for k in ("c_cmp", "c_mem", "e_compute",
                                        "e_dsp", "e_special", "e_sram",
                                        "e_irf", "e_orf", "e_static",
                                        "path")}
        T_row = {"clock_hz": static["clock_hz"][r],
                 "double_buffer": static["double_buffer"][r]}
        out = self._cm.execute_dynamic(st, T_row, float(bw_gbps),
                                       float(dram_rd), float(dram_wr))
        e = EnergyBreakdown(
            compute=float(out["e_compute"]),
            dram=float(out["e_dram"]),
            sram=float(out["e_sram"]),
            irf=float(out["e_irf"]),
            orf=float(out["e_orf"]),
            dsp=float(out["e_dsp"]),
            special=float(out["e_special"]),
        )
        return OpExec(cycles=float(out["cycles"]),
                      seconds=float(out["seconds"]), energy=e,
                      path=_PATH_NAME[int(out["path"])],
                      roofline=_ROOFLINE_NAME[int(out["roofline"])],
                      dram_rd=dram_rd, dram_wr=dram_wr,
                      dram_bytes=float(out["dram_bytes"]))

    # -------------------------------------------------------------- helpers
    def noc_seconds(self, bytes_: float) -> float:
        return float(noc_transfer_seconds(
            bytes_, self.chip.noc_bytes_per_cycle, self.hops,
            self.chip.noc_base_cycles, self.ref_clock_hz))

    def noc_energy_pj(self, bytes_: float) -> float:
        return float(noc_transfer_energy_pj(
            bytes_, self.calib.e_noc_pj_per_byte_hop, self.hops))

    def link_seconds(self, bytes_: float) -> float:
        """Store-and-forward occupancy of ONE grid link by a transfer of
        ``bytes_`` (hop count is per-link by construction)."""
        return float(noc_transfer_seconds(
            bytes_, self.chip.noc_bytes_per_cycle, 1.0,
            self.chip.noc_base_cycles, self.ref_clock_hz))

    # ------------------------------------------------------------------ run
    def run(self, plan: ExecutionPlan) -> SimResult:
        if plan.mode not in SCHEDULE_MODES:
            raise ValueError(
                f"ChipSim cannot model schedule mode {plan.mode!r}; "
                f"supported modes: {SCHEDULE_MODES}")
        g = plan.graph
        n_tiles = len(self.tiles)
        # one batched CostModel query for the whole plan (tile/op-only
        # costs); the walk below only runs the per-op DRAM combine
        rec_of, static = self._static_pass(plan)
        tile_finish = [0.0] * n_tiles
        op_finish: Dict[int, float] = {}
        # Activation cache (§3.3.4): each tile's cache partition is a FIFO
        # bounded in bytes (CACHE_FRAC of SRAM) and entries
        # (ACT_CACHE_SLOTS); inserting a new output evicts oldest-first
        # until it fits, and outputs larger than the partition spill.
        # Eviction re-writes are not charged (uniform-optimism
        # simplification shared with the batched backends).
        cache_cap = [t.sram_kb * 1024.0 * CACHE_FRAC for t in self.templates]
        caches = [ActivationCache(i, cap) for i, cap in enumerate(cache_cap)]
        cached_at: Dict[int, int] = {}  # op idx -> tile holding its output

        breakdowns = [TileBreakdown(i, self.templates[i].name)
                      for i in range(n_tiles)]
        op_results: List[OpResult] = []
        chip_energy = EnergyBreakdown()
        total_macs = 0.0
        # per-batch shared-resource occupancy (throughput-mode II inputs):
        # burst-aligned DRAM bytes and NoC transfer seconds of one batch
        dram_bytes_total = 0.0
        noc_busy_s = 0.0
        # link-fidelity occupancy vectors: per-link XY-routed NoC seconds
        # and per-channel (tile-interleaved) DRAM bytes of one batch
        link = self.fidelity == "link"
        link_occ = np.zeros(MAX_LINKS, np.float64)
        chan_occ = np.zeros(MAX_DRAM_CHANNELS, np.float64)

        fused_map: Dict[int, List[int]] = {}
        for j, nd in enumerate(g.nodes):
            if nd.fused_into >= 0:
                fused_map.setdefault(nd.fused_into, []).append(j)

        for i, op in enumerate(g.nodes):
            if op.fused_into >= 0:
                # folded into the head's PPM: its vector energy rides along,
                # the SRAM round-trip is refunded via E_fuse (Eq. 6)
                continue
            pl = plan.placements[i]
            total_macs += op.macs

            # --- dependency-ready time + input acquisition -----------------
            t_dep = 0.0
            extra_noc_s = 0.0
            dram_rd = float(op.bytes_w)  # weights always stream from DRAM
            per_pred = op.bytes_in / max(len(op.preds), 1)
            cache_kind = "miss"
            tidx0 = pl.tiles[0]
            for p in op.preds:
                t_dep = max(t_dep, op_finish.get(p, 0.0))
                src = cached_at.get(p, -1)
                if src == -1:
                    dram_rd += per_pred            # miss: full DRAM load
                elif src == tidx0:
                    cache_kind = "hit"             # local hit: free
                else:
                    cache_kind = "noc"             # cross-tile DMA
                    extra_noc_s += self.noc_seconds(per_pred)
                    chip_energy.noc += self.noc_energy_pj(per_pred)
                    if link:
                        link_occ = link_occ + self._link_mask[src, tidx0] \
                            * self.link_seconds(per_pred)
            if not op.preds:
                dram_rd += float(op.bytes_in)      # graph input

            # write-back: outputs that fit the producer's activation cache
            # skip the DRAM round-trip entirely (§3.3.4); oversized outputs
            # spill.  Eviction re-writes are not charged.
            dram_wr = float(op.bytes_out) if op.bytes_out > cache_cap[tidx0] \
                else 0.0

            # --- dynamic DRAM bandwidth share ------------------------------
            t_start0 = max(tile_finish[tidx0], t_dep)
            n_active = sum(1 for f in tile_finish if f > t_start0)
            n_active = max(n_active, 1)
            bw_share = self.chip.dram_gbps / n_active

            noc_busy_s += extra_noc_s
            if len(pl.tiles) == 1:
                ex = self._exec_rec(static, rec_of[i], bw_share, dram_rd,
                                    dram_wr)
                t_start = t_start0 + extra_noc_s
                t_fin = t_start + ex.seconds
                tile_finish[tidx0] = t_fin
                dram_bytes_total += ex.dram_bytes
                if link:
                    chan_occ = chan_occ + self._chan_onehot[tidx0] \
                        * ex.dram_bytes
                self._account(breakdowns[tidx0], op, ex, chip_energy)
                op_results.append(OpResult(i, tidx0, ex.path, t_start, t_fin,
                                           ex.cycles, ex.energy, ex.roofline,
                                           1, cache_kind))
            else:
                t_fin, split_dram_b, reduce_s, link_occ, chan_occ = \
                    self._run_split(
                        i, op, pl, tile_finish, t_dep, extra_noc_s, dram_rd,
                        dram_wr, bw_share, breakdowns, chip_energy,
                        op_results, cache_kind, static, rec_of[i],
                        link, link_occ, chan_occ)
                dram_bytes_total += split_dram_b
                noc_busy_s += reduce_s

            op_finish[i] = t_fin
            caches[tidx0].insert(i, float(op.bytes_out), cached_at)

            # PPM energy for ops fused into this head + Eq. 6 refund
            for j in fused_map.get(i, ()):
                nd = g.nodes[j]
                lane_ops = nd.elems * 2.0
                pe = lane_ops * self.calib.e_dsp_pj_per_lane_op
                breakdowns[tidx0].energy.dsp += pe
                chip_energy.dsp += pe
                refund = 2.0 * nd.bytes_out * self.calib.e_sram_pj_per_byte
                breakdowns[tidx0].energy.fuse_savings += refund
                chip_energy.fuse_savings += refund

        makespan = max(tile_finish) if any(tile_finish) else 0.0

        # --- leakage: active tiles leak fully, idle tiles are power-gated ---
        leak_rate_pj_per_s = 0.0
        for b, tmpl in zip(breakdowns, self.templates):
            area = tile_area(tmpl, self.calib)
            gated = b.ops == 0
            resid = self.calib.power_gate_residual if gated else 1.0
            leak_pj = self.calib.leak_mw_per_mm2 * area * makespan * resid * 1e9
            leak_rate_pj_per_s += self.calib.leak_mw_per_mm2 * area * resid \
                * 1e9
            b.power_gated = gated
            b.energy.leakage += leak_pj
            chip_energy.leakage += leak_pj

        area = chip_area(self.chip, self.calib)
        peak_tops = sum(t.num_macs * t.clock_mhz * 1e6
                        for t in self.templates) / 1e12
        achieved = total_macs / makespan / 1e12 if makespan > 0 else 0.0
        pipeline = None
        if plan.mode == "throughput":
            pipeline = self._steady_state(
                makespan, breakdowns, dram_bytes_total, noc_busy_s,
                chip_energy, leak_rate_pj_per_s, total_macs,
                chan_occ if link else None, link_occ if link else None)
        return SimResult(
            workload=g.name, arch=self.chip.name, latency_s=makespan,
            energy_pj=chip_energy.total_pj, area_mm2=area, peak_tops=peak_tops,
            achieved_tops=achieved, energy_breakdown=chip_energy,
            tiles=breakdowns, ops=op_results, total_macs=total_macs,
            arithmetic_intensity=g.arithmetic_intensity(),
            mode=plan.mode, pipeline=pipeline)

    # ---------------------------------------------- throughput steady state
    def _steady_state(self, makespan, breakdowns, dram_bytes_total,
                      noc_busy_s, chip_energy, leak_rate_pj_per_s,
                      total_macs, chan_occ=None,
                      link_occ=None) -> Dict[str, float]:
        """Throughput-mode steady state (§3.2): replay successive batches
        with a per-batch offset of II -- the bottleneck-resource occupancy
        from ``costs.pipeline_bounds``, the same composition the batched
        executor evaluates.  Reports the initiation interval, the
        pipeline-fill latency (= the one-batch makespan), the per-resource
        bounds, and the steady-state per-inference energy (leakage
        re-charged over II).  The link tier passes its per-channel DRAM and
        per-link NoC occupancy vectors through to the II max."""
        tile_busy_max = max((b.active_s for b in breakdowns), default=0.0)
        pipe = {k: float(v) for k, v in pipeline_bounds(
            makespan, tile_busy_max, dram_bytes_total, self.chip.dram_gbps,
            noc_busy_s, chan_bytes=chan_occ,
            dram_channels=float(self.chip.dram_channels)
            if chan_occ is not None else None,
            link_busy_s=link_occ).items()}
        ii = pipe["ii_s"]
        pipe["fill_latency_s"] = makespan
        pipe["dram_bytes_per_batch"] = dram_bytes_total
        pipe["energy_ss_pj"] = float(steady_state_energy(
            chip_energy.total_pj, chip_energy.leakage, leak_rate_pj_per_s,
            ii))
        pipe["achieved_tops_ss"] = total_macs / ii / 1e12 if ii > 0 else 0.0
        # batches in flight once the pipeline is full (the replay depth
        # after which batch k's finish times advance by exactly II)
        pipe["pipeline_depth"] = float(math.ceil(makespan / ii)) \
            if ii > 0 else 1.0
        return pipe

    # ----------------------------------------------------------- split path
    def _run_split(self, i, op, pl, tile_finish, t_dep, extra_noc_s,
                   dram_rd, dram_wr, bw_share, breakdowns, chip_energy,
                   op_results, cache_kind, static, rec0, link, link_occ,
                   chan_occ):
        """Even split along OC / B / IC with explicit reduce cost (Eq. 3).
        Returns ``(t_fin, dram_bytes, reduce_s, link_occ, chan_occ)`` --
        the finish time plus the split's aligned DRAM traffic and NoC
        reduce occupancy for the throughput-mode resource accounting
        (the per-channel / per-link vectors updated on the link tier)."""
        k = len(pl.tiles)
        finishes = []
        slice_out = op.bytes_out / k
        sub = slice_op(op, pl.axis, k)
        dram_bytes = 0.0
        for j, tidx in enumerate(pl.tiles):
            ex = self._exec_rec(static, rec0 + j, bw_share, dram_rd / k,
                                dram_wr / k)
            t_start = max(tile_finish[tidx], t_dep) + extra_noc_s
            t_fin = t_start + ex.seconds
            tile_finish[tidx] = t_fin
            finishes.append(t_fin)
            dram_bytes += ex.dram_bytes
            if link:
                chan_occ = chan_occ + self._chan_onehot[tidx] * ex.dram_bytes
            self._account(breakdowns[tidx], sub, ex, chip_energy)
            op_results.append(OpResult(i, tidx, ex.path, t_start, t_fin,
                                       ex.cycles, ex.energy, ex.roofline,
                                       k, cache_kind))
        # Eq. 3: C_reduce = max_i( ceil(B_out_i / B_NoC) + Delta_NoC )
        reduce_s = self.noc_seconds(slice_out)
        for tidx in pl.tiles[1:]:
            chip_energy.noc += self.noc_energy_pj(slice_out)
            if link:
                link_occ = link_occ + self._link_mask[tidx, pl.tiles[0]] \
                    * self.link_seconds(slice_out)
        t_fin = max(finishes) + reduce_s
        tile_finish[pl.tiles[0]] = max(tile_finish[pl.tiles[0]], t_fin)
        return t_fin, dram_bytes, reduce_s, link_occ, chan_occ

    @staticmethod
    def _account(b: TileBreakdown, op: OpNode, ex,
                 chip_energy: EnergyBreakdown) -> None:
        b.ops += 1
        b.macs += op.macs
        b.active_s += ex.seconds
        b.energy.add(ex.energy)
        chip_energy.add(ex.energy)


def simulate(chip: ChipConfig, plan: ExecutionPlan,
             calib: CalibrationTable = DEFAULT_CALIB,
             fidelity: str = "aggregate") -> SimResult:
    return ChipSim(chip, calib, fidelity).run(plan)
