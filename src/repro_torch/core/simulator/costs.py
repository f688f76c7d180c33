"""The shared float64 cost model (paper §3.3.1, Eqs. 2/4-6) on torch.

Port of ``repro/core/simulator/costs.py``.  The reference writes one set
of formulas against an array namespace ``xp`` (numpy for the oracle,
``jax.numpy`` under ``vmap`` for the batched backends).  torch is not a
drop-in ``xp`` (``xp.asarray(v, f64)`` passes the dtype positionally,
``xp.maximum(t, 1.0)`` passes a Python float), so this module routes
every array operation through the small helpers below, which dispatch
on the operand types:

* torch tensors (``float64``, any device) -> torch;
* numpy arrays and Python / numpy scalars -> numpy.

The numpy path is the reference's ``xp = numpy`` path kept as it was.
Mixed operands are the batched executor's normal case: tile fields are
``(B, MAX_TILES)`` tensors, while an operator's fields are Python floats
(workload-static, shared by every candidate), so op-only subterms are
computed once on the host in float64 and never launch a kernel.

The operation order is the reference's, term for term.  Three torch
behaviours would otherwise change bits and are handled here:

* ``scalar / tensor`` in torch multiplies by the reciprocal
  (``Tensor.__rtruediv__``), and CUDA divides by a CPU scalar the same
  way; ``_div`` always divides tensor by tensor instead.
* torch's CPU ``sqrt`` for float64 is not correctly rounded (AVX-512
  build: about 1 result in 100 differs from IEEE ``sqrt`` by one ulp);
  ``_sqrt`` takes numpy's correctly rounded ``sqrt`` for CPU tensors.
  CUDA's double ``sqrt`` is IEEE round-to-nearest.
* ``2.0 ** tensor`` goes through ``pow``; the precision-bit test uses a
  table of exact powers of two instead.

This module also owns the activation-cache semantics (§3.3.4): a
per-tile FIFO bounded in bytes (``CACHE_FRAC`` of SRAM) and entries
(``ACT_CACHE_SLOTS``).  ``ActivationCache`` is the host reference the
``ChipSim`` oracle walks with; ``simulator.batched.fifo_insert`` is its
tensor mirror for the batched executors.
"""
from __future__ import annotations

import collections
import functools
from typing import Dict, Optional, Union

import numpy as np
import torch

from ...device import F64, resolve_device
from ..arch import Dataflow, Engine, MAX_TILES, Sparsity
from ..calibrate.asap7 import CalibrationTable
from ..ir import OpClass, OpType, PRECISION_BYTES

__all__ = [
    "CACHE_FRAC", "ACT_CACHE_SLOTS", "ACC_BYTES", "DSP_OPS_PER_ELEM",
    "DSP_OPS_TABLE", "SFU_NEED", "TILE_COST_KEYS", "OP_COST_KEYS",
    "COST_MODEL_VERSION", "FIDELITIES", "MAX_DRAM_CHANNELS", "MAX_LINKS",
    "CostModel", "cost_model", "ActivationCache", "noc_transfer_seconds",
    "noc_transfer_energy_pj", "split_op_fields", "grid_dims",
    "xy_route_link_mask", "dram_channel_one_hot", "pipeline_bounds",
    "steady_state_energy",
]

# Version tag of the cost formulas (the reference's; the port computes the
# same metrics, so it carries the same tag).
COST_MODEL_VERSION = "9.0"

# Throughput-II fidelity tiers: ``aggregate`` keeps the one-shared-link
# NoC / one-channel DRAM bounds; ``link`` adds per-link XY-routed NoC
# occupancy on the tile grid and per-channel (address-interleaved) DRAM
# queues on top.
FIDELITIES = ("aggregate", "link")

# Per-channel DRAM queue width of the link tier: chips declare
# ``dram_channels`` in [1, MAX_DRAM_CHANNELS]; unused lanes stay zero.
MAX_DRAM_CHANNELS = 8

# Link-occupancy width: one horizontal link (right of each grid position)
# and one vertical link (below it) on the largest admissible tile grid.
MAX_LINKS = 2 * MAX_TILES

# fraction of per-tile SRAM reserved for the activation cache (§3.3.4)
CACHE_FRAC = 0.25
# tag-array depth of the activation cache (FIFO-evicted outputs per tile)
ACT_CACHE_SLOTS = 8

# Accumulator width (partial sums) per input precision index.
ACC_BYTES = (4.0, 4.0, 4.0, 4.0, 4.0)
_ACC = ACC_BYTES[0]

_BURST = 64.0  # DRAM burst alignment (bytes)

# Lane-ops each DSP-class operator spends per element (§3.3.1 SIMD ISA).
DSP_OPS_PER_ELEM: Dict[int, float] = {
    int(OpType.ADD): 1.0,
    int(OpType.MUL): 1.0,
    int(OpType.SOFTMAX): 5.0,
    int(OpType.LAYERNORM): 7.0,
    int(OpType.RMSNORM): 5.0,
    int(OpType.GELU): 8.0,
    int(OpType.SILU): 5.0,
    int(OpType.RELU): 1.0,
    int(OpType.SIGMOID): 4.0,
    int(OpType.POOL): 1.0,
    int(OpType.REDUCE): 1.0,
    int(OpType.GATHER): 2.0,
    int(OpType.SCATTER): 3.0,
    int(OpType.SSM_SCAN): 6.0,
    int(OpType.ROPE): 4.0,
}

# Dense table indexed by op_type (23 entries; default 2.0 lane-ops).
DSP_OPS_TABLE = np.array(
    [DSP_OPS_PER_ELEM.get(t, 2.0) for t in range(23)], dtype=np.float64)

# SFU-mask bit each special op needs (1 is harmless for non-special ops).
SFU_NEED = np.ones(23, dtype=np.float64)
SFU_NEED[int(OpType.FFT)] = 1.0
SFU_NEED[int(OpType.SNN_LIF)] = 2.0
SFU_NEED[int(OpType.POLY)] = 4.0

# exact 2**precision for the precision-mask bit test
_POW2 = np.asarray([2.0 ** p for p in range(len(PRECISION_BYTES))],
                   np.float64)

TILE_COST_KEYS = (
    "exists", "num_macs", "rows", "cols", "engine", "prec_mask", "asym_mac",
    "sparsity", "dataflow", "sram_kb", "dsp_lanes", "dsp_count", "sfu_mask",
    "sfu_parallel", "double_buffer", "pipeline_depth", "clock_hz",
    "sram_bpc", "max_prec",
)

OP_COST_KEYS = (
    "op_type", "op_cls", "macs", "elems", "m", "k", "n", "precision",
    "bytes_in", "bytes_w", "bytes_out", "act_sparsity", "w_sparsity",
    "fft_n", "poly_degree", "snn_timesteps", "seq_len",
)


# =============================================================================
# type-dispatching array helpers (torch for tensors, numpy otherwise)
# =============================================================================

def _t(x) -> bool:
    return isinstance(x, torch.Tensor)


def _full(like: torch.Tensor, v) -> torch.Tensor:
    return torch.full(like.shape, float(v), dtype=F64, device=like.device)


def _div(a, b):
    """IEEE division ``a / b`` on every operand mix (see module doc)."""
    if _t(a) and _t(b):
        return torch.div(a, b)
    if _t(b):
        return torch.div(_full(b, a), b)
    if _t(a):
        return torch.div(a, _full(a, b))
    return np.divide(np.asarray(a, np.float64), b)


def _ceil(x):
    return torch.ceil(x) if _t(x) else np.ceil(x)


def _floor(x):
    return torch.floor(x) if _t(x) else np.floor(x)


def _sqrt(x):
    if not _t(x):
        return np.sqrt(x)
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.detach().numpy()))
    return torch.sqrt(x)


def _log2(x):
    return torch.log2(x) if _t(x) else np.log2(x)


def _maximum(a, b):
    if _t(a) and _t(b):
        return torch.maximum(a, b)
    if _t(a):
        return torch.clamp(a, min=float(b))
    if _t(b):
        return torch.clamp(b, min=float(a))
    return np.maximum(a, b)


def _minimum(a, b):
    if _t(a) and _t(b):
        return torch.minimum(a, b)
    if _t(a):
        return torch.clamp(a, max=float(b))
    if _t(b):
        return torch.clamp(b, max=float(a))
    return np.minimum(a, b)


def _clip(x, lo: float, hi: float):
    return torch.clamp(x, lo, hi) if _t(x) else np.clip(x, lo, hi)


def _floor_divide(a, b):
    if _t(a) and _t(b):
        return torch.floor_divide(a, b)
    if _t(a):
        return torch.floor_divide(a, float(b))
    if _t(b):
        return torch.floor_divide(_full(b, a), b)
    return np.floor_divide(a, b)


def _where(c, a, b):
    """``xp.where``.  A host-scalar condition (a workload-static
    predicate) selects a branch instead of launching a kernel; the
    taken branch gives the same bits."""
    if _t(c):
        if not _t(a) and not _t(b):
            a = _full(c, a)
        if not _t(a):
            a = float(a)
        if not _t(b):
            b = float(b)
        return torch.where(c, a, b)
    if isinstance(c, np.ndarray) and c.ndim > 0:
        return np.where(c, a, b)
    return a if bool(c) else b


def _zeros_like(x):
    return torch.zeros_like(x) if _t(x) else np.zeros_like(x)


def _ones_like(x):
    return torch.ones_like(x) if _t(x) else np.ones_like(x)


def _device_of(*xs) -> Optional[torch.device]:
    """The device of the first tensor operand; ``None``: all host."""
    return next((x.device for x in xs if _t(x)), None)


def _f64(x, dev: Optional[torch.device]):
    """``x`` as float64: a tensor on ``dev``, or numpy when ``dev`` is
    ``None``."""
    if dev is None:
        return np.asarray(x, np.float64)
    return torch.as_tensor(x, dtype=F64, device=dev)


def _arange(n: int, dev: Optional[torch.device]):
    if dev is None:
        return np.arange(n, dtype=np.float64)
    return torch.arange(n, dtype=F64, device=dev)


def _cat_last(parts):
    if _t(parts[0]):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def _max_last(x):
    """Max over the last axis (kept as a unit axis for tensors, whose
    per-candidate scalars are (B, 1))."""
    if _t(x):
        return x.max(dim=-1, keepdim=True).values
    return np.max(x, axis=-1)


# =============================================================================
# NoC transfer cost (shared by the mapper and the executor)
# =============================================================================

def noc_transfer_seconds(nbytes, noc_bpc, hops, base_cycles, ref_clock_hz):
    """Eq. 3 context: ceil(B / B_NoC) + hops * Delta_NoC cycles at the chip
    reference clock."""
    return _div(_ceil(_div(nbytes, noc_bpc)) + hops * base_cycles,
                ref_clock_hz)


def noc_transfer_energy_pj(nbytes, e_noc_pj_per_byte_hop, hops):
    return nbytes * e_noc_pj_per_byte_hop * hops


def grid_dims(num_tiles, grid_aspect):
    """(grid_w, grid_h) of the 2D tile layout: width tracks
    ``sqrt(n) * aspect`` (clipped to [1, n]); the last row may be
    partial."""
    if _t(num_tiles):
        n = torch.clamp(num_tiles.to(F64), min=1.0)
        w = torch.minimum(torch.clamp(torch.round(_sqrt(n) * grid_aspect),
                                      min=1.0), n)
        return w, torch.ceil(_div(n, w))
    n = np.maximum(np.asarray(num_tiles, np.float64), 1.0)
    w = np.clip(np.round(np.sqrt(n) * grid_aspect), 1.0, n)
    return w, np.ceil(n / w)


def xy_route_link_mask(src, dst, grid_w, grid_h, torus):
    """0/1 occupancy mask over the ``MAX_LINKS`` grid links used by an XY
    route from tile ``src`` to tile ``dst``.

    Tiles are laid out row-major on a ``grid_w x grid_h`` grid.  Link
    ``i < MAX_TILES`` is the horizontal link to the right of grid position
    ``i``; link ``MAX_TILES + i`` the vertical link below it.  Links are
    undirected.  XY routing moves along the source row first, then along
    the destination column; on a torus each dimension takes the
    wrap-around direction when strictly shorter (``2*delta > extent``;
    ties go the mesh way).  A negative ``src``/``dst`` (no tile) yields an
    empty route.  Inputs broadcast (numpy, or tensors on one device); the
    link axis is appended last."""
    dev = _device_of(src, dst, grid_w, grid_h, torus)
    links = _arange(MAX_TILES, dev)
    s = _f64(src, dev)[..., None]
    d = _f64(dst, dev)[..., None]
    w = _maximum(_f64(grid_w, dev), 1.0)[..., None]
    h = _maximum(_f64(grid_h, dev), 1.0)[..., None]
    wrap_ok = _f64(torus, dev)[..., None] > 0
    sr = _floor_divide(s, w)
    sc = s - sr * w
    dr = _floor_divide(d, w)
    dc = d - dr * w
    lr = _floor_divide(links, w)
    lc = links - lr * w
    valid = (s >= 0) & (d >= 0)
    # horizontal segment: along the source row
    cmin = _minimum(sc, dc)
    cmax = _maximum(sc, dc)
    hwrap = wrap_ok & (2.0 * (cmax - cmin) > w)
    inside_h = (lc >= cmin) & (lc < cmax)
    outside_h = (lc >= cmax) | (lc < cmin)
    use_h = valid & (lr == sr) & _where(hwrap, outside_h, inside_h)
    # vertical segment: along the destination column
    rmin = _minimum(sr, dr)
    rmax = _maximum(sr, dr)
    vwrap = wrap_ok & (2.0 * (rmax - rmin) > h)
    inside_v = (lr >= rmin) & (lr < rmax)
    outside_v = (lr >= rmax) | (lr < rmin)
    use_v = valid & (lc == dc) & (lr < h) & _where(vwrap, outside_v, inside_v)
    return _cat_last([_where(use_h, 1.0, 0.0), _where(use_v, 1.0, 0.0)])


def dram_channel_one_hot(tile_idx, dram_channels):
    """One-hot (..., MAX_DRAM_CHANNELS) selector of the DRAM channel that
    serves ``tile_idx``'s traffic: addresses interleave across channels
    by owner tile (``tile mod dram_channels``).  A negative tile index
    selects no channel."""
    dev = _device_of(tile_idx, dram_channels)
    ch = _arange(MAX_DRAM_CHANNELS, dev)
    t = _f64(tile_idx, dev)[..., None]
    n = _clip(_f64(dram_channels, dev), 1.0,
              float(MAX_DRAM_CHANNELS))[..., None]
    sel = t - _floor_divide(t, n) * n
    return _where((ch == sel) & (t >= 0), 1.0, 0.0)


def split_op_fields(op, axis, kf):
    """Array mirror of ``ir.slice_op``: even 1/k slice of a MAC op along
    OC (axis 0), B (1) or IC (2).  ``axis`` may be a host int (one axis
    for every candidate) or a per-candidate tensor."""
    sub = {f: op[f] for f in OP_COST_KEYS}
    sub_m = _where(axis == 1, _maximum(_floor(_div(op["m"], kf)), 1.0),
                   op["m"])
    sub_n = _where(axis == 0, _maximum(_floor(_div(op["n"], kf)), 1.0),
                   op["n"])
    sub_k = _where(axis == 2, _maximum(_floor(_div(op["k"], kf)), 1.0),
                   op["k"])
    sub["m"], sub["n"], sub["k"] = sub_m, sub_n, sub_k
    sub["macs"] = _where(op["macs"] > 0, sub_m * sub_k * sub_n, op["macs"])
    sub["bytes_in"] = _where(axis == 1, _floor(_div(op["bytes_in"], kf)),
                             op["bytes_in"])
    sub["bytes_w"] = _where(axis != 1, _floor(_div(op["bytes_w"], kf)),
                            op["bytes_w"])
    sub["bytes_out"] = _where(axis != 2, _floor(_div(op["bytes_out"], kf)),
                              op["bytes_out"])
    return sub


# =============================================================================
# throughput-mode steady state (§3.2 schedule modes)
# =============================================================================

def pipeline_bounds(makespan_s, tile_busy_max_s, dram_bytes, dram_gbps,
                    noc_busy_s, chan_bytes=None, dram_channels=None,
                    link_busy_s=None):
    """Steady-state initiation interval of a pipelined schedule:
    ``II = min(makespan, max(tile, DRAM, NoC bounds))`` (see the
    reference's docstring for the composition).

    The link tier passes ``chan_bytes`` (..., MAX_DRAM_CHANNELS), the
    chip's ``dram_channels`` and ``link_busy_s`` (..., MAX_LINKS): the
    busiest channel at ``dram_gbps / dram_channels`` and the busiest link
    are two more lower bounds max'd into the bottleneck, reported as
    ``ii_chan_bound_s`` and ``ii_link_bound_s``; the aggregate keys keep
    their bits, so ``II(link) >= II(aggregate)``."""
    dram_bound = _div(dram_bytes, dram_gbps * 1e9)
    bottleneck = _maximum(_maximum(tile_busy_max_s, dram_bound), noc_busy_s)
    out = {
        "ii_tile_bound_s": tile_busy_max_s,
        "ii_dram_bound_s": dram_bound,
        "ii_noc_bound_s": noc_busy_s,
    }
    if chan_bytes is not None:
        n_ch = _clip(dram_channels, 1.0, float(MAX_DRAM_CHANNELS))
        chan_bound = _div(_max_last(chan_bytes),
                          _div(dram_gbps, n_ch) * 1e9)
        link_bound = _max_last(link_busy_s)
        bottleneck = _maximum(_maximum(bottleneck, chan_bound), link_bound)
        out["ii_chan_bound_s"] = chan_bound
        out["ii_link_bound_s"] = link_bound
    out["ii_s"] = _minimum(makespan_s, bottleneck)
    return out


def steady_state_energy(energy_total_pj, leakage_pj, leak_rate_pj_per_s,
                        ii_s):
    """Per-inference energy in the pipelined steady state (leakage
    re-charged over the initiation interval)."""
    return energy_total_pj - leakage_pj + leak_rate_pj_per_s * ii_s


# =============================================================================
# the seven-module cost model
# =============================================================================

class CostModel:
    """Per-(op, tile) cycle/energy model bound to one calibration.

    ``T`` arguments are dicts of per-tile values (``TILE_COST_KEYS``);
    ``op`` arguments are dicts of per-op values (``OP_COST_KEYS``).  Any
    field may be a host scalar, a numpy array or a float64 tensor, as
    long as they broadcast.  ``device`` places the lookup tables that
    tensor indices gather from (``None``: the card, as
    ``device.resolve_device`` resolves it).
    """

    def __init__(self, calib: CalibrationTable,
                 device: Optional[Union[str, torch.device]] = None):
        self.c = calib
        self.device = resolve_device(device)
        self._np = {
            "e_mac": np.asarray(calib.e_mac_pj, np.float64),
            "eng_e": np.asarray(calib.engine_e_mult, np.float64),
            "dsp_ops": DSP_OPS_TABLE,
            "sfu_need": SFU_NEED,
            "bpe": np.asarray(PRECISION_BYTES, np.float64),
            "pow2": _POW2,
        }
        self._tt = {k: torch.as_tensor(v, dtype=F64, device=self.device)
                    for k, v in self._np.items()}

    # ---------------------------------------------------------------- helpers
    def _take(self, table: str, idx):
        """``table[int(idx)]`` for host scalars, numpy arrays or tensors."""
        if _t(idx):
            return self._tt[table][idx.long()]
        if isinstance(idx, np.ndarray):
            return self._np[table][idx.astype(np.int32)]
        return self._np[table][int(idx)]

    @staticmethod
    def _cached(T, key, fn):
        """Per-evaluation memo for terms that depend only on the tiles and
        a host-scalar op field.  A caller that evaluates many ops against
        one tile set (the batched executors) puts an empty dict under
        ``T["_cache"]``; without it every term is computed afresh."""
        cache = T.get("_cache") if isinstance(T, dict) else None
        if cache is None or any(_t(k) or isinstance(k, np.ndarray)
                                for k in key[1:]):
            return fn()
        hit = cache.get(key)
        if hit is None:
            hit = cache[key] = fn()
        return hit

    def _eta_op(self, T, op):
        return self._cached(
            T, ("eta", op["act_sparsity"], op["w_sparsity"]),
            lambda: self.eta(T["sparsity"], op["act_sparsity"],
                             op["w_sparsity"]))

    @staticmethod
    def _sel(conds, vals, default):
        """``xp.select`` semantics (first true condition wins) as nested
        ``where``."""
        out = default
        for c, v in zip(reversed(conds), reversed(vals)):
            out = _where(c, v, out)
        return out

    def mac_energy_pj(self, T, prec_idx):
        """Op-precision MAC energy on this tile's datapath, including the
        clock-gating residual of the wide path."""
        return self._cached(T, ("e_mac", prec_idx),
                            lambda: self._mac_energy_pj(T, prec_idx))

    def _mac_energy_pj(self, T, prec_idx):
        e = self._take("e_mac", prec_idx)
        e_wide = self._take("e_mac", T["max_prec"])
        e = _where(e_wide > e, e + self.c.datapath_residual * (e_wide - e), e)
        return e * self._take("eng_e", T["engine"])

    def eta(self, sparsity, act_sp, w_sp):
        """Sparsity throughput multiplier eta_T."""
        act_sp = _clip(act_sp, 0.0, 0.95)
        w_sp = _clip(w_sp, 0.0, 0.95)
        e_act = _div(1.0, 1.0 - act_sp)
        e_w = _div(1.0, 1.0 - w_sp)
        e_two = _div(1.0, _maximum((1.0 - act_sp) * (1.0 - w_sp), 1e-3))
        e_nm = _where(w_sp >= 0.5, 2.0, 1.0)
        e = self._sel(
            [sparsity == int(Sparsity.NONE), sparsity == int(Sparsity.ACT),
             sparsity == int(Sparsity.WEIGHT),
             sparsity == int(Sparsity.TWO_SIDED)],
            [_ones_like(e_act), e_act, e_w, e_two], e_nm)
        return _minimum(e, self.c.eta_cap)

    def supports_precision(self, T, prec):
        """Per-tile precision filter incl. asymmetric-MAC variants."""
        return self._cached(T, ("prec_ok", prec),
                            lambda: self._supports_precision(T, prec))

    def _supports_precision(self, T, prec):
        native = _floor_divide(T["prec_mask"], self._take("pow2", prec)) \
            % 2 >= 1
        int8_ok = _floor_divide(T["prec_mask"], 2.0) % 2 >= 1
        fp16_ok = _floor_divide(T["prec_mask"], 4.0) % 2 >= 1
        asym48 = ((T["asym_mac"] == 1.0) | (T["asym_mac"] == 2.0)) \
            & (prec == 0) & int8_ok
        asym416 = (T["asym_mac"] == 3.0) & (prec <= 1) & fp16_ok
        return native | asym48 | asym416

    def sfu_native(self, T, op):
        return self._cached(
            T, ("sfu_native", op["op_type"]),
            lambda: _floor_divide(T["sfu_mask"],
                                  self._take("sfu_need", op["op_type"]))
            % 2 >= 1)

    def supports(self, T, op):
        """Compatibility filter (paper §3.2)."""
        prec_ok = self.supports_precision(T, op["precision"])
        has_dsp = T["dsp_count"] > 0
        mac_ok = ((T["num_macs"] > 0) & prec_ok) | has_dsp
        spec_ok = self.sfu_native(T, op) \
            | ((op["op_type"] == int(OpType.FFT)) & (T["num_macs"] > 0)
               & prec_ok) \
            | has_dsp
        cls_ok = self._sel(
            [op["op_cls"] == int(OpClass.MAC),
             op["op_cls"] == int(OpClass.DSP)],
            [mac_ok, has_dsp], spec_ok)
        return (T["exists"] > 0) & cls_ok

    # ---------------------------------------------------------- MAC sub-models
    def mac_tiling(self, T, m, k, n, bpe, cache_frac=CACHE_FRAC):
        """SRAM-budget tiling pass (§3.3.1): returns (m_t, k_t, n_t)."""
        budget = T["sram_kb"] * 1024.0 * (1.0 - cache_frac)
        m_t = _minimum(m, T["rows"])
        n_t = _maximum(_minimum(n, T["cols"]), 1.0)
        db = _where(T["double_buffer"] > 0, 2.0, 1.0)
        out_b = m_t * n_t * _ACC
        k_fit = _div(budget - out_b, _maximum((m_t + n_t) * bpe * db, 1.0))
        k_t = _maximum(_minimum(k, k_fit), _minimum(k, 16.0))
        return m_t, k_t, n_t

    def mac_cycles(self, T, m, k, n, eta, m_t, k_t, n_t):
        """Engine-specific compute-cycle model (Eq. 4)."""
        D = T["pipeline_depth"]
        tn = _ceil(_div(n, n_t))
        tk = _ceil(_div(k, _maximum(k_t, 1.0)))
        tm = _ceil(_div(m, _maximum(m_t, 1.0)))
        m_eff = _div(m, _maximum(tm, 1.0))
        k_eff = _div(_div(k, _maximum(tk, 1.0)), eta)
        nm = _maximum(T["num_macs"], 1.0)
        sys = tn * tk * (D + tm * (m_eff + k_eff + D - 2.0))
        ideal = _div(_div(m * k * n, eta), nm)
        util = _div(m_eff, _maximum(m_t, 1.0)) \
            * _div(_minimum(n, n_t), _maximum(n_t, 1.0))
        spatial = _div(ideal, _maximum(_minimum(util, 1.0), 0.25)) \
            + D * tn * tk
        cim = 2.0 * ideal + D * tn * tk
        cyc = self._sel(
            [T["engine"] == int(Engine.SYSTOLIC),
             T["engine"] == int(Engine.SPATIAL),
             T["engine"] == int(Engine.DOT)],
            [sys, spatial, spatial], cim)
        return _where((m > 0) & (k > 0) & (n > 0), cyc, 0.0)

    def sram_traffic(self, T, m, k, n, bpe, m_t, k_t, n_t):
        """Tiling-aware SRAM traffic (bytes in, weights, out, k-tiles) from
        dataflow reuse, including the AUTO rule (§3.2)."""
        tm = _ceil(_div(m, _maximum(m_t, 1.0)))
        tk = _ceil(_div(k, _maximum(k_t, 1.0)))
        tn = _ceil(_div(n, _maximum(n_t, 1.0)))
        auto_os = (m * n > 4.0 * k * n) & (m * n > 4.0 * m * k)
        df = _where(T["dataflow"] == int(Dataflow.AUTO),
                    _where(auto_os, float(Dataflow.OS), float(Dataflow.WS)),
                    T["dataflow"])
        in_b = self._sel(
            [df == int(Dataflow.WS), df == int(Dataflow.OS)],
            [m * k * bpe * tn, m * k * bpe * tn], m * k * bpe * _sqrt(tn))
        w_b = self._sel(
            [df == int(Dataflow.WS), df == int(Dataflow.OS)],
            [k * n * bpe, k * n * bpe * tm], k * n * bpe * _sqrt(tm))
        out_b = self._sel(
            [df == int(Dataflow.WS), df == int(Dataflow.OS)],
            [m * n * _ACC * (2.0 * tk - 1.0), m * n * _ACC],
            m * n * _ACC * _sqrt(tk))
        return in_b, w_b, out_b, tk

    # ----------------------------------------------------------- vector paths
    def dsp_cycles_energy(self, T, op_type, elems, seq_len):
        """Vector-DSP path; the SSM scan parallelizes only per-step work."""
        ops_pe = self._take("dsp_ops", op_type)
        lane_ops = elems * ops_pe
        lanes = _maximum(T["dsp_lanes"], 1.0)
        is_scan = (op_type == int(OpType.SSM_SCAN)) & (seq_len > 1)
        per_step = _div(elems, _maximum(seq_len, 1.0)) * ops_pe
        cyc = _where(is_scan,
                     seq_len * _ceil(_div(per_step, lanes)),
                     _ceil(_div(lane_ops, lanes)))
        ok = (T["dsp_count"] > 0) & (elems > 0)
        return _where(ok, cyc, 0.0), \
            _where(ok, lane_ops * self.c.e_dsp_pj_per_lane_op, 0.0)

    def sfu_cycles_energy(self, T, op_type, elems, fft_n, poly_d, snn_t):
        """Native special-function path: radix-2 FFT, LIF array, Horner."""
        c = self.c
        par = _maximum(T["sfu_parallel"], 1.0)
        n = _maximum(fft_n, 2.0)
        transforms = _maximum(_div(elems, n), 1.0)
        lg = _log2(n)
        c_fft = transforms * _ceil(_div(n * lg, par))
        e_fft = transforms * _div(n, 2.0) * lg * c.e_fft_pj_per_butterfly
        t_ = _maximum(snn_t, 1.0)
        c_lif = _ceil(_div(elems, par)) * t_
        e_lif = elems * t_ * c.e_lif_pj_per_neuron_step
        d = _maximum(poly_d, 1.0)
        c_pol = _div(elems * d, par)
        e_pol = elems * d * c.e_poly_pj_per_fma
        cyc = self._sel([op_type == int(OpType.FFT),
                         op_type == int(OpType.SNN_LIF)], [c_fft, c_lif],
                        c_pol)
        en = self._sel([op_type == int(OpType.FFT),
                        op_type == int(OpType.SNN_LIF)], [e_fft, e_lif],
                       e_pol)
        return cyc, en

    def lowered_cycles_energy(self, T, op, prec_idx):
        """Lowered cost (paper §2.5): FFT->MAC O(N^2) when a MAC array
        exists; LIF/poly/FFT->DSP with sequential multipliers."""
        c = self.c
        lanes = _maximum(T["dsp_lanes"], 1.0)
        n = _maximum(op["fft_n"], 2.0)
        transforms = _maximum(_div(op["elems"], n), 1.0)
        macs = 4.0 * n * n * transforms
        c_fft_mac = _div(macs, _maximum(T["num_macs"], 1.0))
        e_fft_mac = macs * self.mac_energy_pj(T, prec_idx)
        tsteps = _maximum(op["snn_timesteps"], 1.0)
        lif_ops = op["elems"] * 4.0
        c_lif = tsteps * (_ceil(_div(lif_ops, _div(lanes, 4.0)))
                          + _ceil(_div(op["elems"] * 8.0, T["sram_bpc"])))
        e_lif = lif_ops * tsteps * c.e_dsp_pj_per_lane_op
        d = _maximum(op["poly_degree"], 1.0)
        pol_ops = op["elems"] * 2.0
        c_pol = d * (_ceil(_div(pol_ops, lanes))
                     + _ceil(_div(op["elems"] * 2.0, T["sram_bpc"])))
        e_pol = d * pol_ops * c.e_dsp_pj_per_lane_op
        c_fft_dsp = _ceil(_div(op["elems"] * 10.0 * _log2(n), lanes))
        e_fft_dsp = op["elems"] * 10.0 * _log2(n) * c.e_dsp_pj_per_lane_op
        is_fft = op["op_type"] == int(OpType.FFT)
        fft_on_mac = is_fft & (T["num_macs"] > 0) \
            & self.supports_precision(T, op["precision"])
        cyc = self._sel(
            [fft_on_mac, op["op_type"] == int(OpType.SNN_LIF),
             op["op_type"] == int(OpType.POLY)],
            [c_fft_mac, c_lif, c_pol], c_fft_dsp)
        en = self._sel(
            [fft_on_mac, op["op_type"] == int(OpType.SNN_LIF),
             op["op_type"] == int(OpType.POLY)],
            [e_fft_mac, e_lif, e_pol], e_fft_dsp)
        # DFT twiddle weights streamed through SRAM on the MAC lowering
        extra_sram = _where(fft_on_mac, 2.0 * n * n * self._take("bpe",
                                                                 prec_idx)
                            * c.e_sram_pj_per_byte, 0.0)
        return cyc, en, extra_sram, fft_on_mac

    # -------------------------------------------------------------- roofline
    def roofline_cycles(self, T, op, bw_gbps):
        """Mapper's cycle estimate (Eq. 2): max of compute- and
        bandwidth-bound counts."""
        total_b = op["bytes_in"] + op["bytes_w"] + op["bytes_out"]
        bpc = _div(bw_gbps * 1e9, T["clock_hz"])
        c_bw = _div(total_b, _maximum(bpc, 1e-9))
        eta = self._eta_op(T, op)
        c_mac = _where(
            (T["num_macs"] > 0) & self.supports_precision(T, op["precision"]),
            _div(op["macs"], _maximum(T["num_macs"] * eta, 1e-9)),
            _ceil(_div(2.0 * op["macs"], _maximum(T["dsp_lanes"], 1.0))))
        c_dsp, _ = self.dsp_cycles_energy(T, op["op_type"], op["elems"],
                                          op["seq_len"])
        c_sfu_nat, _ = self.sfu_cycles_energy(
            T, op["op_type"], op["elems"], op["fft_n"], op["poly_degree"],
            op["snn_timesteps"])
        c_low, _, _, _ = self.lowered_cycles_energy(T, op, op["precision"])
        c_spec = _where(self.sfu_native(T, op), c_sfu_nat, c_low)
        c_cmp = self._sel(
            [op["op_cls"] == int(OpClass.MAC),
             op["op_cls"] == int(OpClass.SPECIAL)],
            [c_mac, c_spec], c_dsp)
        return _maximum(c_cmp, c_bw)

    # --------------------------------------------------------------- execute
    def execute_static(self, T, op, cache_frac=CACHE_FRAC):
        """The state-independent half of :meth:`execute`: cycle counts,
        per-module energies, path routing and the non-DRAM energy sum."""
        c = self.c
        prec_idx = op["precision"]
        bpe = self._take("bpe", prec_idx)

        # ---- MAC path ----------------------------------------------------
        eta = self._eta_op(T, op)
        m_t, k_t, n_t = self.mac_tiling(T, op["m"], op["k"], op["n"], bpe,
                                        cache_frac)
        c_mac = self.mac_cycles(T, op["m"], op["k"], op["n"], eta,
                                m_t, k_t, n_t)
        e_mac_path = _div(op["macs"], eta) * self.mac_energy_pj(T, prec_idx)
        in_b, w_b, out_b, tk = self.sram_traffic(
            T, op["m"], op["k"], op["n"], bpe, m_t, k_t, n_t)
        e_sram_mac = (in_b + w_b + out_b) * c.e_sram_pj_per_byte
        irf_w = _ceil(_div(in_b, 32.0)) * 32.0
        irf_r = in_b * (1.0 - _minimum(op["act_sparsity"], 0.95))
        e_irf = (irf_w + irf_r) * c.e_irf_pj_per_byte
        orf_b = op["m"] * op["n"] * _ACC * (2.0 * tk - 1.0)
        e_orf = orf_b * c.e_orf_pj_per_byte
        c_mem_mac = _ceil(_div(in_b + w_b + out_b, T["sram_bpc"]))

        # ---- DSP path ----------------------------------------------------
        c_dsp, e_dsp = self.dsp_cycles_energy(T, op["op_type"], op["elems"],
                                              op["seq_len"])
        stream_b = op["bytes_in"] + op["bytes_out"]
        e_sram_stream = stream_b * c.e_sram_pj_per_byte
        c_mem_stream = _ceil(_div(stream_b, T["sram_bpc"]))

        # ---- MAC op lowered onto the DSP ---------------------------------
        lanes = _maximum(T["dsp_lanes"], 1.0)
        c_mac_on_dsp = _ceil(_div(2.0 * op["macs"], lanes))
        e_mac_on_dsp = 2.0 * op["macs"] * c.e_dsp_pj_per_lane_op

        # ---- SPECIAL path ------------------------------------------------
        c_sfu, e_sfu = self.sfu_cycles_energy(
            T, op["op_type"], op["elems"], op["fft_n"], op["poly_degree"],
            op["snn_timesteps"])
        c_low, e_low, extra_sram_low, fft_on_mac = self.lowered_cycles_energy(
            T, op, prec_idx)
        native = self.sfu_native(T, op)
        c_spec = _where(native, c_sfu, c_low)
        e_spec = _where(native, e_sfu, e_low)
        e_spec_sram = e_sram_stream + _where(native, 0.0, extra_sram_low)

        is_mac_cls = op["op_cls"] == int(OpClass.MAC)
        is_spec_cls = op["op_cls"] == int(OpClass.SPECIAL)
        prec_ok = self.supports_precision(T, op["precision"])
        on_mac = is_mac_cls & (T["num_macs"] > 0) & prec_ok
        on_dsp_low = is_mac_cls & ~on_mac
        spec_lowered_mac = is_spec_cls & ~native & fft_on_mac

        c_cmp = self._sel([on_mac, on_dsp_low, is_spec_cls],
                          [c_mac, c_mac_on_dsp, c_spec], c_dsp)
        c_mem = self._sel([on_mac, on_dsp_low, is_spec_cls],
                          [c_mem_mac, c_mem_stream, c_mem_stream],
                          c_mem_stream)

        zero = _zeros_like(c_cmp)
        e_compute = self._sel(
            [on_mac, spec_lowered_mac], [e_mac_path, e_spec], zero)
        e_dsp_mod = self._sel(
            [on_mac, on_dsp_low, is_spec_cls],
            [zero, e_mac_on_dsp,
             _where(native | fft_on_mac, zero, e_spec)], e_dsp)
        e_special = _where(is_spec_cls & native, e_spec, 0.0)
        e_sram = self._sel(
            [on_mac, on_dsp_low, is_spec_cls],
            [e_sram_mac, e_sram_stream, e_spec_sram], e_sram_stream)
        e_irf_mod = _where(on_mac, e_irf, 0.0)
        e_orf_mod = _where(on_mac, e_orf, 0.0)

        e_static = self._sel(
            [on_mac, on_dsp_low, is_spec_cls],
            [e_mac_path + e_sram_mac + e_irf + e_orf,
             e_mac_on_dsp + e_sram_stream,
             e_spec + e_spec_sram],
            e_dsp + e_sram_stream)

        path = self._sel([on_mac | spec_lowered_mac, is_spec_cls & native],
                         [_zeros_like(c_cmp), 2.0 + zero], 1.0 + zero)
        return {
            "c_cmp": c_cmp, "c_mem": c_mem,
            "e_compute": e_compute, "e_dsp": e_dsp_mod,
            "e_special": e_special, "e_sram": e_sram, "e_irf": e_irf_mod,
            "e_orf": e_orf_mod, "e_static": e_static, "path": path,
        }

    def execute_dynamic(self, st, T, bw_gbps, dram_rd, dram_wr):
        """The state-dependent half of :meth:`execute`: burst-aligned DRAM
        staging at the shared bandwidth, the Eq. 5 combine, the roofline
        code."""
        c = self.c
        c_cmp, c_mem = st["c_cmp"], st["c_mem"]
        rd_al = _where(dram_rd > 0, _ceil(_div(dram_rd, _BURST)) * _BURST,
                       0.0)
        wr_al = _where(dram_wr > 0, _ceil(_div(dram_wr, _BURST)) * _BURST,
                       0.0)
        total_dram = rd_al + wr_al
        bpc = _div(bw_gbps * 1e9, T["clock_hz"])
        c_dram = _where(total_dram > 0,
                        _div(total_dram, _maximum(bpc, 1e-9))
                        + c.dram_latency_cycles, 0.0)
        e_dram = total_dram * c.e_dram_pj_per_byte
        c_lp = _ceil(_div(dram_rd, 64.0))
        c_sp = _ceil(_div(dram_wr, 64.0))
        c_tot = _where(T["double_buffer"] > 0,
                       _maximum(_maximum(c_cmp, c_mem), c_dram) + c_lp + c_sp,
                       c_cmp + c_mem + c_dram + c_lp + c_sp)
        energy_total = st["e_static"] + e_dram
        roofline = _where(c_cmp >= _maximum(c_mem, c_dram), 0.0, 1.0)
        return {
            "cycles": c_tot, "seconds": _div(c_tot, T["clock_hz"]),
            "e_compute": st["e_compute"], "e_dsp": st["e_dsp"],
            "e_special": st["e_special"], "e_sram": st["e_sram"],
            "e_irf": st["e_irf"], "e_orf": st["e_orf"], "e_dram": e_dram,
            "energy_total": energy_total, "path": st["path"],
            "roofline": roofline, "dram_bytes": total_dram,
        }

    def execute(self, T, op, bw_gbps, dram_rd, dram_wr,
                cache_frac=CACHE_FRAC):
        """Full seven-module execution (Eq. 4-6): the composition of
        :meth:`execute_static` and :meth:`execute_dynamic`."""
        return self.execute_dynamic(self.execute_static(T, op, cache_frac),
                                    T, bw_gbps, dram_rd, dram_wr)

    # ----------------------------------------------- class-specialized halves
    # ``op_cls`` is a workload property, the same for every candidate, so a
    # caller that knows it can skip the other classes' sub-models.  Each
    # restriction is term for term the matching ``_sel`` branch of the full
    # method, so the bits are the same.

    def _stream_static(self, T, op):
        stream_b = op["bytes_in"] + op["bytes_out"]
        e_sram_stream = stream_b * self.c.e_sram_pj_per_byte
        c_mem_stream = _ceil(_div(stream_b, T["sram_bpc"]))
        return e_sram_stream, c_mem_stream

    def _bw_cycles(self, T, op, bw_gbps):
        total_b = op["bytes_in"] + op["bytes_w"] + op["bytes_out"]
        bpc = _div(bw_gbps * 1e9, T["clock_hz"])
        return _div(total_b, _maximum(bpc, 1e-9))

    def execute_static_mac(self, T, op, cache_frac=CACHE_FRAC):
        """:meth:`execute_static` restricted to ``OpClass.MAC``."""
        c = self.c
        prec_idx = op["precision"]
        bpe = self._take("bpe", prec_idx)
        eta = self._eta_op(T, op)
        m_t, k_t, n_t = self.mac_tiling(T, op["m"], op["k"], op["n"], bpe,
                                        cache_frac)
        c_mac = self.mac_cycles(T, op["m"], op["k"], op["n"], eta,
                                m_t, k_t, n_t)
        e_mac_path = _div(op["macs"], eta) * self.mac_energy_pj(T, prec_idx)
        in_b, w_b, out_b, tk = self.sram_traffic(
            T, op["m"], op["k"], op["n"], bpe, m_t, k_t, n_t)
        e_sram_mac = (in_b + w_b + out_b) * c.e_sram_pj_per_byte
        irf_w = _ceil(_div(in_b, 32.0)) * 32.0
        irf_r = in_b * (1.0 - _minimum(op["act_sparsity"], 0.95))
        e_irf = (irf_w + irf_r) * c.e_irf_pj_per_byte
        orf_b = op["m"] * op["n"] * _ACC * (2.0 * tk - 1.0)
        e_orf = orf_b * c.e_orf_pj_per_byte
        c_mem_mac = _ceil(_div(in_b + w_b + out_b, T["sram_bpc"]))
        e_sram_stream, c_mem_stream = self._stream_static(T, op)
        lanes = _maximum(T["dsp_lanes"], 1.0)
        c_mac_on_dsp = _ceil(_div(2.0 * op["macs"], lanes))
        e_mac_on_dsp = 2.0 * op["macs"] * c.e_dsp_pj_per_lane_op
        on_mac = (T["num_macs"] > 0) \
            & self.supports_precision(T, op["precision"])
        zero = _zeros_like(c_mac)
        return {
            "c_cmp": _where(on_mac, c_mac, c_mac_on_dsp),
            "c_mem": _where(on_mac, c_mem_mac, c_mem_stream),
            "e_compute": _where(on_mac, e_mac_path, 0.0),
            "e_dsp": _where(on_mac, 0.0, e_mac_on_dsp),
            "e_special": zero,
            "e_sram": _where(on_mac, e_sram_mac, e_sram_stream),
            "e_irf": _where(on_mac, e_irf, 0.0),
            "e_orf": _where(on_mac, e_orf, 0.0),
            "e_static": _where(
                on_mac, e_mac_path + e_sram_mac + e_irf + e_orf,
                e_mac_on_dsp + e_sram_stream),
            "path": _where(on_mac, zero, 1.0 + zero),
        }

    def execute_static_dsp(self, T, op):
        """:meth:`execute_static` restricted to ``OpClass.DSP``."""
        c_dsp, e_dsp = self.dsp_cycles_energy(T, op["op_type"], op["elems"],
                                              op["seq_len"])
        e_sram_stream, c_mem_stream = self._stream_static(T, op)
        zero = _zeros_like(c_dsp)
        return {
            "c_cmp": c_dsp, "c_mem": c_mem_stream + zero,
            "e_compute": zero, "e_dsp": e_dsp, "e_special": zero,
            "e_sram": e_sram_stream + zero, "e_irf": zero, "e_orf": zero,
            "e_static": e_dsp + e_sram_stream,
            "path": 1.0 + zero,
        }

    def execute_static_special(self, T, op):
        """:meth:`execute_static` restricted to ``OpClass.SPECIAL``."""
        prec_idx = op["precision"]
        c_sfu, e_sfu = self.sfu_cycles_energy(
            T, op["op_type"], op["elems"], op["fft_n"], op["poly_degree"],
            op["snn_timesteps"])
        c_low, e_low, extra_sram_low, fft_on_mac = self.lowered_cycles_energy(
            T, op, prec_idx)
        native = self.sfu_native(T, op)
        e_sram_stream, c_mem_stream = self._stream_static(T, op)
        c_spec = _where(native, c_sfu, c_low)
        e_spec = _where(native, e_sfu, e_low)
        e_spec_sram = e_sram_stream + _where(native, 0.0, extra_sram_low)
        spec_lowered_mac = ~native & fft_on_mac
        zero = _zeros_like(c_spec)
        return {
            "c_cmp": c_spec, "c_mem": c_mem_stream + zero,
            "e_compute": _where(spec_lowered_mac, e_spec, 0.0),
            "e_dsp": _where(native | fft_on_mac, 0.0, e_spec),
            "e_special": _where(native, e_spec, 0.0),
            "e_sram": e_spec_sram, "e_irf": zero, "e_orf": zero,
            "e_static": e_spec + e_spec_sram,
            "path": _where(spec_lowered_mac, zero,
                           _where(native, 2.0 + zero, 1.0 + zero)),
        }

    def execute_static_cls(self, T, op, cls: int):
        """Dispatch to the class-specialized static half for a host-known
        ``op_cls``."""
        if cls == int(OpClass.MAC):
            return self.execute_static_mac(T, op)
        if cls == int(OpClass.DSP):
            return self.execute_static_dsp(T, op)
        return self.execute_static_special(T, op)

    def roofline_cycles_mac(self, T, op, bw_gbps):
        """:meth:`roofline_cycles` restricted to ``OpClass.MAC``."""
        eta = self._eta_op(T, op)
        c_mac = _where(
            (T["num_macs"] > 0) & self.supports_precision(T, op["precision"]),
            _div(op["macs"], _maximum(T["num_macs"] * eta, 1e-9)),
            _ceil(_div(2.0 * op["macs"], _maximum(T["dsp_lanes"], 1.0))))
        return _maximum(c_mac, self._bw_cycles(T, op, bw_gbps))

    def roofline_cycles_dsp(self, T, op, bw_gbps):
        """:meth:`roofline_cycles` restricted to ``OpClass.DSP``."""
        c_dsp, _ = self.dsp_cycles_energy(T, op["op_type"], op["elems"],
                                          op["seq_len"])
        return _maximum(c_dsp, self._bw_cycles(T, op, bw_gbps))

    def roofline_cycles_special(self, T, op, bw_gbps):
        """:meth:`roofline_cycles` restricted to ``OpClass.SPECIAL``."""
        c_sfu_nat, _ = self.sfu_cycles_energy(
            T, op["op_type"], op["elems"], op["fft_n"], op["poly_degree"],
            op["snn_timesteps"])
        c_low, _, _, _ = self.lowered_cycles_energy(T, op, op["precision"])
        c_spec = _where(self.sfu_native(T, op), c_sfu_nat, c_low)
        return _maximum(c_spec, self._bw_cycles(T, op, bw_gbps))

    def roofline_cycles_cls(self, T, op, bw_gbps, cls: int):
        if cls == int(OpClass.MAC):
            return self.roofline_cycles_mac(T, op, bw_gbps)
        if cls == int(OpClass.DSP):
            return self.roofline_cycles_dsp(T, op, bw_gbps)
        return self.roofline_cycles_special(T, op, bw_gbps)

    def supports_mac(self, T, op):
        """:meth:`supports` restricted to ``OpClass.MAC``."""
        prec_ok = self.supports_precision(T, op["precision"])
        has_dsp = T["dsp_count"] > 0
        return (T["exists"] > 0) & (((T["num_macs"] > 0) & prec_ok) | has_dsp)

    def supports_dsp(self, T, op):
        """:meth:`supports` restricted to ``OpClass.DSP``."""
        return (T["exists"] > 0) & (T["dsp_count"] > 0)

    def supports_special(self, T, op):
        """:meth:`supports` restricted to ``OpClass.SPECIAL``."""
        prec_ok = self.supports_precision(T, op["precision"])
        has_dsp = T["dsp_count"] > 0
        spec_ok = self.sfu_native(T, op) \
            | ((op["op_type"] == int(OpType.FFT)) & (T["num_macs"] > 0)
               & prec_ok) \
            | has_dsp
        return (T["exists"] > 0) & spec_ok

    def supports_cls(self, T, op, cls: int):
        if cls == int(OpClass.MAC):
            return self.supports_mac(T, op)
        if cls == int(OpClass.DSP):
            return self.supports_dsp(T, op)
        return self.supports_special(T, op)


@functools.lru_cache(maxsize=32)
def _cached_model(calib: CalibrationTable, device: str) -> CostModel:
    return CostModel(calib, torch.device(device))


def cost_model(calib: CalibrationTable,
               device: Optional[Union[str, torch.device]] = None
               ) -> CostModel:
    """Cached CostModel factory, one per (calibration, device); ``None``
    is the card (``device.resolve_device``)."""
    return _cached_model(calib, str(resolve_device(device)))


# =============================================================================
# activation cache (§3.3.4): byte- and slot-bounded FIFO, host reference
# =============================================================================

class ActivationCache:
    """Per-tile FIFO activation cache.

    Holds at most ``ACT_CACHE_SLOTS`` producer outputs totalling at most
    ``cap_bytes``; inserting evicts oldest-first until the new output fits
    (outputs larger than the capacity are never inserted).  Mirrored
    bitwise by ``simulator.batched.fifo_insert`` -- keep the two in sync.
    """

    def __init__(self, tile_index: int, cap_bytes: float,
                 slots: int = ACT_CACHE_SLOTS):
        self.tile_index = tile_index
        self.cap = cap_bytes
        self.slots = slots
        self.entries: collections.deque = collections.deque()  # (op, bytes)
        self.used = 0.0

    def insert(self, op_idx: int, nbytes: float,
               cached_at: Dict[int, int]) -> None:
        """Insert ``op_idx``'s output, updating the shared op->tile map."""
        if nbytes > self.cap:
            return
        while self.entries and (self.used + nbytes > self.cap
                                or len(self.entries) == self.slots):
            old_op, old_b = self.entries.popleft()
            self.used -= old_b
            cached_at.pop(old_op, None)
        self.entries.append((op_idx, nbytes))
        self.used += nbytes
        cached_at[op_idx] = self.tile_index
