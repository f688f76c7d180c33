"""One chip on one workload, walked operator by operator in plain
Python: the exact mapping with the chip orchestrator (``exact``), and the
scan's approximate in-scan mapping (``scan``).  Both return
``(latency_s, energy_pj, achieved_tops)``, in latency mode on the
aggregate fidelity tier.

Shared by both (paper §3.2-§3.3.4):

* the compatibility filter, with special operators sent to a tile that
  has their unit whenever the chip has one;
* the start time of an operator on a tile: the later of the tile's last
  finish and its inputs' finish times, with an input made on another
  tile paying its NoC transfer (Eq. 1);
* the DRAM bandwidth shared among the tiles still busy at the start
  (the mapper's estimates use an even share);
* the activation cache: each tile keeps the outputs it made in a FIFO
  bounded in bytes and in slots; an input found in the consumer's own
  cache is free, one in another tile's cache crosses the NoC, and any
  other input is read from DRAM; an output that fits the producer's
  cache is never written to DRAM;
* leakage over the makespan, at a residual for power-gated idle tiles;
  fused operators' vector energy on their head, less the SRAM round trip
  that fusion saves (Eq. 6).

``exact`` places each operator on the tile that finishes it first by
the Eq. 2 estimate (ties to the smaller MAC array, within 1e-15 s), or
splits a MAC operator evenly over every MAC tile along the axis that
finishes first with its Eq. 3 reduction, when that beats one tile; then
it replays the placements with the Eq. 5 costs.

``scan`` decides placement and replays in one pass per operator, as the
scan backend does: the estimate's tie-break adds 1e-18 s per MAC to each
tile's finish, the split's slices are floored in every byte count, the
split is taken where its estimate beats the best single tile, and the
split's tiles and its owner (the first MAC tile) update as the scan's
state does.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, List, Tuple

from .core.arch import ChipConfig, Interconnect
from .core.ir import OpClass, WorkloadGraph
from .model import (ACT_CACHE_SLOTS, Model, Num, Op, Tile, make_op,
                    make_tile, split_op)

INF = math.inf


def noc_hops(interconnect: Interconnect, n: int) -> int:
    """Mean hop count of a transfer on the chip's interconnect."""
    if interconnect == Interconnect.BUS:
        return 1
    if interconnect == Interconnect.RING:
        return max(n // 4, 1)
    if interconnect == Interconnect.NOC:
        return 2
    return max(math.ceil(math.sqrt(n)), 1)          # mesh


class Chip:
    """A chip's tiles and NoC under one model."""

    def __init__(self, chip: ChipConfig, model: Model, calib):
        num = model.num
        f = num.f
        self.model, self.num = model, num
        by_tmpl: Dict[int, Tile] = {}
        self.tiles: List[Tile] = []
        for t in chip.instances():
            if id(t) not in by_tmpl:
                by_tmpl[id(t)] = make_tile(t, calib, num)
            self.tiles.append(by_tmpl[id(t)])
        self.n = len(self.tiles)
        self.dram = f(chip.dram_gbps)
        self.hops = f(noc_hops(chip.interconnect, self.n))
        self.noc_bpc = f(chip.noc_bytes_per_cycle)
        self.noc_base = f(chip.noc_base_cycles)
        self.ref_hz = f(chip.ref_clock_mhz) * f(1e6)

    def noc_s(self, nbytes):
        """Eq. 3's transfer: ceil(B / B_NoC) + hops x the per-hop base
        cycles, at the chip's reference clock."""
        return (self.num.ceil(nbytes / self.noc_bpc)
                + self.hops * self.noc_base) / self.ref_hz

    def noc_pj(self, nbytes):
        return nbytes * self.model.e_noc * self.hops

    def per_tile(self, fn):
        """``fn(tile)`` for every instance, computed once per template."""
        memo: Dict[int, object] = {}
        out = []
        for t in self.tiles:
            if id(t) not in memo:
                memo[id(t)] = fn(t)
            out.append(memo[id(t)])
        return out

    def compatible(self, op: Op) -> List[bool]:
        m = self.model
        ok = self.per_tile(lambda t: m.supports(t, op))
        if op.cls == OpClass.SPECIAL:
            native = [o and h for o, h in
                      zip(ok, self.per_tile(lambda t: m.has_sfu(t, op)))]
            if any(native):
                return native
        return ok

    def estimate_s(self, op: Op, bw):
        """The Eq. 2 estimate on every tile, in seconds."""
        m = self.model
        return self.per_tile(lambda t: m.roofline(t, op, bw) / t.clock_hz)


class Cache:
    """The tiles' activation caches: FIFOs bounded in bytes and slots."""

    def __init__(self, tiles: List[Tile]):
        self.cap = [t.cache_cap for t in tiles]
        self.fifo = [collections.deque() for _ in tiles]
        self.used = [0.0 for _ in tiles]
        self.where: Dict[int, int] = {}      # op -> tile holding its output

    def insert(self, tile: int, op: int, nbytes) -> None:
        if nbytes > self.cap[tile]:
            return                            # too large: spills
        fifo = self.fifo[tile]
        while fifo and (self.used[tile] + nbytes > self.cap[tile]
                        or len(fifo) == ACT_CACHE_SLOTS):
            old, old_b = fifo.popleft()
            self.used[tile] -= old_b
            self.where.pop(old, None)
        fifo.append((op, nbytes))
        self.used[tile] += nbytes
        self.where[op] = tile


def _fused_extras(g: WorkloadGraph, num: Num):
    """Vector lane-ops and SRAM bytes saved of each head's fused ops."""
    lanes = collections.defaultdict(float)
    saved = collections.defaultdict(float)
    for nd in g.nodes:
        if nd.fused_into >= 0:
            lanes[nd.fused_into] += num.f(nd.elems) * 2.0
            saved[nd.fused_into] += 2.0 * num.f(nd.bytes_out)
    return lanes, saved


def _finish(c: Chip, tile_fin, busy, energy, total_macs):
    makespan = max(tile_fin)
    energy = energy + c.model.leakage(c.tiles, busy, makespan)
    tops = total_macs / makespan / 1e12 if makespan > 0 else 0.0
    return makespan, energy, tops


# =============================================================================
# the exact mapping and the orchestrator's replay
# =============================================================================

def _place(c: Chip, g: WorkloadGraph, ops: Dict[int, Op]):
    """Eqs. 1-3: ``{op: (tiles, axis)}``, or None if some operator has no
    compatible tile."""
    n, num = c.n, c.num
    bw = c.dram / n
    tile_fin = [0.0] * n
    op_fin: Dict[int, float] = {}
    op_tile: Dict[int, int] = {}
    placed = {}
    for i, op in ops.items():
        nd = g.nodes[i]
        ok = c.compatible(op)
        compat = [t for t in range(n) if ok[t]]
        if not compat:
            return None
        per_pred = op.b_in / max(len(nd.preds), 1)

        def start(t):
            dep = 0.0
            for p in nd.preds:
                f = op_fin.get(p, 0.0)
                if op_tile.get(p, t) != t:
                    f = f + c.noc_s(per_pred)
                dep = max(dep, f)
            return max(tile_fin[t], dep)

        est = c.estimate_s(op, bw)
        best, best_fin = -1, INF
        for t in compat:
            fin = start(t) + est[t]
            if fin < best_fin - 1e-15 or (
                    abs(fin - best_fin) <= 1e-15 and best >= 0
                    and c.tiles[t].nm < c.tiles[best].nm):
                best, best_fin = t, fin
        choice, fin_c = ([best], None), best_fin
        if op.cls == OpClass.MAC and nd.splittable and op.macs > 0:
            mac = [t for t in compat if c.tiles[t].nm > 0]
            k = len(mac)
            if k > 1:
                for axis in (0, 1, 2):
                    sub = split_op(op, axis, num.f(k), num)
                    est_sub = c.estimate_s(sub, bw / k)
                    fin = max(start(t) + est_sub[t] for t in mac) \
                        + c.noc_s(op.b_out / k)
                    if fin < fin_c:
                        choice, fin_c = (mac, axis), fin
        placed[i] = choice
        tiles = choice[0]
        if len(tiles) == 1:
            tile_fin[tiles[0]] = fin_c
        else:
            for t in tiles:
                tile_fin[t] = max(tile_fin[t], fin_c)
        op_fin[i] = fin_c
        op_tile[i] = tiles[0]
    return placed


def exact(chip: ChipConfig, g: WorkloadGraph, model: Model, calib
          ) -> Tuple[float, float, float]:
    c = Chip(chip, model, calib)
    num, m = model.num, model
    ops = {i: make_op(nd, num) for i, nd in enumerate(g.nodes)
           if nd.fused_into < 0}
    placed = _place(c, g, ops)
    if placed is None:
        return INF, INF, 0.0
    lanes, saved = _fused_extras(g, num)
    cache = Cache(c.tiles)
    tile_fin = [0.0] * c.n
    busy = [False] * c.n
    op_fin: Dict[int, float] = {}
    energy, total_macs = 0.0, 0.0
    for i, op in ops.items():
        nd = g.nodes[i]
        tiles, axis = placed[i]
        owner = tiles[0]
        total_macs = total_macs + op.macs
        per_pred = op.b_in / max(len(nd.preds), 1)
        t_dep, extra, rd = 0.0, 0.0, op.b_w
        for p in nd.preds:
            t_dep = max(t_dep, op_fin.get(p, 0.0))
            src = cache.where.get(p, -1)
            if src < 0:
                rd = rd + per_pred
            elif src != owner:
                extra = extra + c.noc_s(per_pred)
                energy = energy + c.noc_pj(per_pred)
        if not nd.preds:
            rd = rd + op.b_in
        wr = op.b_out if op.b_out > c.tiles[owner].cache_cap else 0.0
        t0 = max(tile_fin[owner], t_dep)
        bw = c.dram / max(sum(1 for f in tile_fin if f > t0), 1)
        if len(tiles) == 1:
            sec, e, _ = m.execute(c.tiles[owner], op, bw, rd, wr)
            t_fin = t0 + extra + sec
            tile_fin[owner] = t_fin
            busy[owner] = True
            energy = energy + e
        else:
            k = len(tiles)
            sub = split_op(op, axis, num.f(k), num)
            fins = []
            for t in tiles:
                sec, e, _ = m.execute(c.tiles[t], sub, bw, rd / k, wr / k)
                fin = max(tile_fin[t], t_dep) + extra + sec
                tile_fin[t] = fin
                fins.append(fin)
                busy[t] = True
                energy = energy + e
            part = op.b_out / k
            for _ in tiles[1:]:
                energy = energy + c.noc_pj(part)
            t_fin = max(fins) + c.noc_s(part)
            tile_fin[owner] = max(tile_fin[owner], t_fin)
        op_fin[i] = t_fin
        cache.insert(owner, i, op.b_out)
        energy = energy + lanes[i] * m.e_dsp - saved[i] * m.e_sram
    return _finish(c, tile_fin, busy, energy, total_macs)


# =============================================================================
# the scan's in-scan mapping
# =============================================================================

EPS_TIE = 1e-18


def scan(chip: ChipConfig, g: WorkloadGraph, model: Model, calib
         ) -> Tuple[float, float, float]:
    c = Chip(chip, model, calib)
    num, m, n = model.num, model, c.n
    bw_est = c.dram / n
    eps = [t.nm * EPS_TIE for t in c.tiles]
    lanes, saved = _fused_extras(g, num)
    cache = Cache(c.tiles)
    fin_est, fin_act = [0.0] * n, [0.0] * n
    ops_on = [0] * n
    op_est: Dict[int, float] = {}
    op_act: Dict[int, float] = {}
    op_tile: Dict[int, int] = {}
    energy = 0.0
    for i, nd in enumerate(g.nodes):
        if nd.fused_into >= 0:
            continue
        op = make_op(nd, num)
        preds = nd.preds
        per_pred = op.b_in / max(len(preds), 1)
        ns_pred = c.noc_s(per_pred) if preds else 0.0
        ok = c.compatible(op)

        # estimate: the best single tile, then an even split
        start = []
        for t in range(n):
            dep = 0.0
            for p in preds:
                pt = op_tile.get(p, -1)
                dep = max(dep, op_est.get(p, 0.0)
                          + (ns_pred if 0 <= pt != t else 0.0))
            start.append(max(fin_est[t], dep))
        est = c.estimate_s(op, bw_est)
        best, best_c = 0, INF
        for t in range(n):
            if ok[t]:
                comp = start[t] + est[t] + eps[t]
                if comp < best_c:
                    best, best_c = t, comp
        best_fin = best_c - eps[best]
        owner, choice, split = best, best_fin, False
        if op.cls == OpClass.MAC and nd.splittable and op.macs > 0:
            mac = [t for t in range(n) if ok[t] and c.tiles[t].nm > 0]
            kf = num.f(max(len(mac), 1))
            ns_out = c.noc_s(op.b_out / kf)
            axis_fin = []
            for axis in (0, 1, 2):
                est_sub = c.estimate_s(split_op(op, axis, kf, num),
                                       bw_est / kf)
                axis_fin.append(max((start[t] + est_sub[t] for t in mac),
                                    default=-INF) + ns_out)
            axis = axis_fin.index(min(axis_fin))
            if len(mac) >= 2 and axis_fin[axis] < best_fin:
                split, owner, choice = True, mac[0], axis_fin[axis]
                sub = split_op(op, axis, kf, num)

        # replay on the chosen tiles
        t_dep, miss, extra, e_noc = 0.0, 0.0, 0.0, 0.0
        for p in preds:
            t_dep = max(t_dep, op_act.get(p, 0.0))
            src = cache.where.get(p, -1)
            if src < 0:
                miss = miss + per_pred
            elif src != owner:
                extra = extra + ns_pred
                e_noc = e_noc + c.noc_pj(per_pred)
        rd = op.b_w + miss + (0.0 if preds else op.b_in)
        cap = c.tiles[owner].cache_cap
        wr = op.b_out if cap < op.b_out else 0.0
        t0 = max(fin_act[owner], t_dep)
        bw = c.dram / max(sum(1 for f in fin_act if f > t0), 1)
        sec, e_one, _ = m.execute(c.tiles[owner], op, bw, rd, wr)
        fin_one = t0 + extra + sec
        new_act, new_est = list(fin_act), list(fin_est)
        new_act[owner], new_est[owner] = fin_one, choice
        if split:
            part = op.b_out / kf
            e_op, fins = 0.0, {}
            for t in mac:
                s, e, _ = m.execute(c.tiles[t], sub, bw, rd / kf, wr / kf)
                fins[t] = max(fin_act[t], t_dep) + extra + s
                e_op = e_op + e
            fin_op = max(fins.values()) + c.noc_s(part)
            e_op = e_op + (kf - 1.0) * c.noc_pj(part) + e_noc
            for t in mac:
                new_act[t] = fins[t]
                new_est[t] = max(fin_est[t], choice)
                ops_on[t] += 1
            new_act[owner] = max(new_act[owner], fin_op)
        else:
            fin_op, e_op = fin_one, e_one + e_noc
            ops_on[owner] += 1
        if not any(ok):
            fin_op = INF
        e_op = e_op + lanes[i] * m.e_dsp - saved[i] * m.e_sram
        fin_act, fin_est = new_act, new_est
        op_est[i], op_act[i], op_tile[i] = choice, fin_op, owner
        energy = energy + e_op
        cache.insert(owner, i, op.b_out)
    total_macs = num.f(sum(nd.macs for nd in g.nodes))
    return _finish(c, fin_act, [k > 0 for k in ops_on], energy, total_macs)
