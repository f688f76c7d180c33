"""The per-operator cost model of one tile, written out plainly: scalar
arithmetic and one branch per execution path (paper §3.3.1, Eqs. 2, 4-6).

A tile runs an operator on one of three paths.  A MAC-class operator runs
on the MAC array when the tile has one that takes its precision (Eq. 4:
an SRAM-budget tiling pass, then the engine's cycle count and the
dataflow's SRAM traffic), and is lowered onto the vector DSP otherwise.
A DSP-class operator runs on the DSP lanes.  A special operator (FFT,
LIF, polynomial) runs on its special-function unit where the tile has it,
and is lowered otherwise (FFT to an O(N^2) DFT on the MAC array, or every
kind onto the DSP).  Eq. 5 combines compute, SRAM staging and
burst-aligned DRAM traffic at the tile's share of the DRAM bandwidth;
double-buffered tiles overlap the three.  Eq. 2 is the mapper's roofline
estimate.

Every number is of one float type, chosen by ``Num``: Python floats
(float64) for the reference, numpy float32 for its lower-precision
control.  Nothing here imports the program or its cost model.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from .core.arch import Dataflow, Engine, Sparsity, TileTemplate
from .core.calibrate.asap7 import CalibrationTable
from .core.ir import OpClass, OpNode, OpType, PRECISION_BYTES
from .core.simulator.area import tile_area

ACT_CACHE_FRAC = 0.25     # share of a tile's SRAM kept as activation cache
ACT_CACHE_SLOTS = 8       # outputs one tile's activation cache holds
PSUM_BYTES = 4.0          # accumulator width of a partial sum
BURST = 64.0              # DRAM burst (bytes)
MIN_K_TILE = 16.0         # the tiling pass never cuts K below this
MIN_SPATIAL_UTIL = 0.25   # utilisation floor of spatial / dot engines
MAX_SPARSITY = 0.95       # sparsities are clipped to this

# lane-ops a DSP-class operator spends per element (default 2)
LANE_OPS = {OpType.ADD: 1.0, OpType.MUL: 1.0, OpType.SOFTMAX: 5.0,
            OpType.LAYERNORM: 7.0, OpType.RMSNORM: 5.0, OpType.GELU: 8.0,
            OpType.SILU: 5.0, OpType.RELU: 1.0, OpType.SIGMOID: 4.0,
            OpType.POOL: 1.0, OpType.REDUCE: 1.0, OpType.GATHER: 2.0,
            OpType.SCATTER: 3.0, OpType.SSM_SCAN: 6.0, OpType.ROPE: 4.0}
# the special-function unit (bit of ``sfu_mask``) each special op needs
SFU_BIT = {OpType.FFT: 1, OpType.SNN_LIF: 2, OpType.POLY: 4}


class Num:
    """One float type for every number of a run of the model."""

    def __init__(self, name: str):
        self.name = name
        self.f = float if name == "float64" else np.float32

    def ceil(self, x):
        return self.f(math.ceil(x))

    def floor(self, x):
        return self.f(math.floor(x))

    def sqrt(self, x):
        return self.f(math.sqrt(x)) if self.f is float else np.sqrt(x)

    def log2(self, x):
        return self.f(math.log2(x)) if self.f is float else np.log2(x)


F64, F32 = Num("float64"), Num("float32")


class Tile(NamedTuple):
    """One tile instance's fields, in the run's float type."""
    tmpl: TileTemplate
    nm: float            # MACs in the array (0: no MAC array)
    rows: float
    cols: float
    engine: int
    sparsity: int
    dataflow: int
    sram_kb: float
    lanes: float         # DSP lanes, at least 1
    has_dsp: bool
    sfu_mask: int
    sfu_par: float       # at least 1
    double_buffer: bool
    depth: float
    clock_hz: float
    sram_bpc: float      # SRAM bytes a cycle: 16 per bank
    cache_cap: float     # activation-cache bytes
    area: float


class Op(NamedTuple):
    """One operator's fields, in the run's float type."""
    type: OpType
    cls: OpClass
    prec: int
    macs: float
    elems: float
    m: float
    k: float
    n: float
    b_in: float
    b_w: float
    b_out: float
    act_sp: float
    w_sp: float
    fft_n: float
    poly_d: float
    snn_t: float
    seq_len: float


def make_tile(t: TileTemplate, calib: CalibrationTable, num: Num) -> Tile:
    f = num.f
    return Tile(
        tmpl=t, nm=f(t.rows * t.cols), rows=f(t.rows), cols=f(t.cols),
        engine=int(t.engine), sparsity=int(t.sparsity),
        dataflow=int(t.dataflow), sram_kb=f(t.sram_kb),
        lanes=f(max(t.dsp_count * t.dsp_simd, 1)), has_dsp=t.dsp_count > 0,
        sfu_mask=int(t.sfu_mask), sfu_par=f(max(t.sfu_parallel, 1)),
        double_buffer=bool(t.double_buffer), depth=f(t.pipeline_depth),
        clock_hz=f(t.clock_mhz) * f(1e6),
        sram_bpc=f(max(t.sram_banks, 1) * 16.0),
        cache_cap=f(t.sram_kb) * f(1024.0) * f(ACT_CACHE_FRAC),
        area=f(tile_area(t, calib)))


def make_op(nd: OpNode, num: Num) -> Op:
    f = num.f
    cls = nd.op_cls
    macs = nd.m * nd.k * nd.n if cls == OpClass.MAC else 0
    return Op(type=nd.op_type, cls=cls, prec=int(nd.precision), macs=f(macs),
              elems=f(nd.elems), m=f(nd.m), k=f(nd.k), n=f(nd.n),
              b_in=f(nd.bytes_in), b_w=f(nd.bytes_w), b_out=f(nd.bytes_out),
              act_sp=f(nd.act_sparsity), w_sp=f(nd.w_sparsity),
              fft_n=f(nd.fft_n), poly_d=f(nd.poly_degree),
              snn_t=f(nd.snn_timesteps), seq_len=f(nd.seq_len))


def split_op(op: Op, axis: int, parts, num: Num) -> Op:
    """An even slice of a MAC operator for ``parts`` tiles (Eq. 3) along
    the output channels (0), the batch (1) or the input channels (2):
    the cut dimension and the byte counts are floored, never below 1."""
    cut = lambda v: max(num.floor(v / parts), 1.0)
    m = cut(op.m) if axis == 1 else op.m
    n = cut(op.n) if axis == 0 else op.n
    k = cut(op.k) if axis == 2 else op.k
    b_in = num.floor(op.b_in / parts) if axis == 1 else op.b_in
    b_w = num.floor(op.b_w / parts) if axis != 1 else op.b_w
    b_out = num.floor(op.b_out / parts) if axis != 2 else op.b_out
    return op._replace(m=m, n=n, k=k, macs=m * n * k, b_in=b_in, b_w=b_w,
                       b_out=b_out)


class Model:
    """The cost model under one calibration and float type."""

    def __init__(self, calib: CalibrationTable, num: Num):
        f = num.f
        self.num = num
        self.e_mac_tab = [f(v) for v in calib.e_mac_pj]
        self.e_eng = [f(v) for v in calib.engine_e_mult]
        self.bpe_tab = [f(v) for v in PRECISION_BYTES]
        self.residual = f(calib.datapath_residual)
        self.eta_cap = f(calib.eta_cap)
        self.e_sram = f(calib.e_sram_pj_per_byte)
        self.e_irf = f(calib.e_irf_pj_per_byte)
        self.e_orf = f(calib.e_orf_pj_per_byte)
        self.e_dram = f(calib.e_dram_pj_per_byte)
        self.e_dsp = f(calib.e_dsp_pj_per_lane_op)
        self.e_fft = f(calib.e_fft_pj_per_butterfly)
        self.e_lif = f(calib.e_lif_pj_per_neuron_step)
        self.e_poly = f(calib.e_poly_pj_per_fma)
        self.e_noc = f(calib.e_noc_pj_per_byte_hop)
        self.dram_lat = f(calib.dram_latency_cycles)
        self.leak = f(calib.leak_mw_per_mm2)
        self.gated = f(calib.power_gate_residual)

    # ------------------------------------------------------------ filters
    @staticmethod
    def prec_ok(t: Tile, op: Op) -> bool:
        return t.tmpl.supports_precision(op.prec)

    @staticmethod
    def has_sfu(t: Tile, op: Op) -> bool:
        return bool(t.sfu_mask & SFU_BIT.get(op.type, 1))

    def on_mac(self, t: Tile, op: Op) -> bool:
        return t.nm > 0 and self.prec_ok(t, op)

    def supports(self, t: Tile, op: Op) -> bool:
        """The compatibility filter (§3.2)."""
        if op.cls == OpClass.MAC:
            return self.on_mac(t, op) or t.has_dsp
        if op.cls == OpClass.DSP:
            return t.has_dsp
        return self.has_sfu(t, op) or t.has_dsp or (
            op.type == OpType.FFT and self.on_mac(t, op))

    # ---------------------------------------------------------- MAC array
    def eta(self, t: Tile, op: Op):
        """Sparsity speed-up of the tile's MAC array."""
        a = min(max(op.act_sp, 0.0), MAX_SPARSITY)
        w = min(max(op.w_sp, 0.0), MAX_SPARSITY)
        s = t.sparsity
        if s == Sparsity.NONE:
            e = self.num.f(1.0)
        elif s == Sparsity.ACT:
            e = 1.0 / (1.0 - a)
        elif s == Sparsity.WEIGHT:
            e = 1.0 / (1.0 - w)
        elif s == Sparsity.TWO_SIDED:
            e = 1.0 / max((1.0 - a) * (1.0 - w), 1e-3)
        else:                                   # N:M structured
            e = self.num.f(2.0 if w >= 0.5 else 1.0)
        return min(e, self.eta_cap)

    def e_mac(self, t: Tile, prec: int):
        """pJ a MAC at ``prec``; a narrower operation on a wider datapath
        keeps a share (the residual) of the wide MAC's extra energy."""
        e = self.e_mac_tab[prec]
        wide = self.e_mac_tab[int(t.tmpl.max_precision)]
        if wide > e:
            e = e + self.residual * (wide - e)
        return e * self.e_eng[t.engine]

    def mac_array(self, t: Tile, op: Op):
        """Eq. 4 on the MAC array: (cycles, SRAM cycles, energy)."""
        num = self.num
        m, k, n = op.m, op.k, op.n
        bpe = self.bpe_tab[op.prec]
        eta = self.eta(t, op)
        # tiling: the output tile stays in the accumulators, K is cut to
        # what the SRAM budget (less the activation cache) holds
        budget = t.sram_kb * 1024.0 * (1.0 - ACT_CACHE_FRAC)
        m_t = min(m, t.rows)
        n_t = max(min(n, t.cols), 1.0)
        buffers = 2.0 if t.double_buffer else 1.0
        k_fit = (budget - m_t * n_t * PSUM_BYTES) \
            / max((m_t + n_t) * bpe * buffers, 1.0)
        k_t = max(min(k, k_fit), min(k, MIN_K_TILE))
        tm = num.ceil(m / max(m_t, 1.0))
        tk = num.ceil(k / max(k_t, 1.0))
        tn = num.ceil(n / n_t)
        # cycles by engine
        D = t.depth
        if m > 0 and k > 0 and n > 0:
            m_eff = m / max(tm, 1.0)
            k_eff = k / max(tk, 1.0) / eta
            ideal = m * k * n / eta / max(t.nm, 1.0)
            if t.engine == Engine.SYSTOLIC:
                cyc = tn * tk * (D + tm * (m_eff + k_eff + D - 2.0))
            elif t.engine in (Engine.SPATIAL, Engine.DOT):
                util = m_eff / max(m_t, 1.0) * (min(n, n_t) / max(n_t, 1.0))
                cyc = ideal / max(min(util, 1.0), MIN_SPATIAL_UTIL) \
                    + D * tn * tk
            else:                               # compute-in-memory
                cyc = 2.0 * ideal + D * tn * tk
        else:
            cyc = num.f(0.0)
        # SRAM traffic by dataflow; AUTO keeps outputs stationary when the
        # output is over four times both operands
        df = t.dataflow
        if df == Dataflow.AUTO:
            df = Dataflow.OS if (m * n > 4.0 * k * n
                                 and m * n > 4.0 * m * k) else Dataflow.WS
        a_b, w_b, o_b = m * k * bpe, k * n * bpe, m * n * PSUM_BYTES
        if df == Dataflow.WS:
            in_b, wt_b, out_b = a_b * tn, w_b, o_b * (2.0 * tk - 1.0)
        elif df == Dataflow.OS:
            in_b, wt_b, out_b = a_b * tn, w_b * tm, o_b
        else:                                   # row stationary
            in_b, wt_b, out_b = (a_b * num.sqrt(tn), w_b * num.sqrt(tm),
                                 o_b * num.sqrt(tk))
        sram_b = in_b + wt_b + out_b
        irf_b = num.ceil(in_b / 32.0) * 32.0 \
            + in_b * (1.0 - min(op.act_sp, MAX_SPARSITY))
        orf_b = m * n * PSUM_BYTES * (2.0 * tk - 1.0)
        energy = op.macs / eta * self.e_mac(t, op.prec) \
            + sram_b * self.e_sram + irf_b * self.e_irf + orf_b * self.e_orf
        return cyc, num.ceil(sram_b / t.sram_bpc), energy

    # ------------------------------------------------------ vector paths
    def dsp(self, t: Tile, op: Op):
        """(cycles, energy) on the DSP lanes; an SSM scan is sequential
        over its steps."""
        num = self.num
        if not (t.has_dsp and op.elems > 0):
            return num.f(0.0), num.f(0.0)
        per = LANE_OPS.get(op.type, 2.0)
        lane_ops = op.elems * per
        if op.type == OpType.SSM_SCAN and op.seq_len > 1:
            step = op.elems / max(op.seq_len, 1.0) * per
            cyc = op.seq_len * num.ceil(step / t.lanes)
        else:
            cyc = num.ceil(lane_ops / t.lanes)
        return cyc, lane_ops * self.e_dsp

    def mac_on_dsp(self, t: Tile, op: Op):
        """A MAC operator lowered onto the DSP: two lane-ops a MAC."""
        return self.num.ceil(2.0 * op.macs / t.lanes), \
            2.0 * op.macs * self.e_dsp

    def sfu(self, t: Tile, op: Op):
        """(cycles, energy) on the native unit: radix-2 FFT, LIF array,
        Horner polynomial."""
        num = self.num
        if op.type == OpType.FFT:
            n = max(op.fft_n, 2.0)
            transforms = max(op.elems / n, 1.0)
            lg = num.log2(n)
            return transforms * num.ceil(n * lg / t.sfu_par), \
                transforms * (n / 2.0) * lg * self.e_fft
        if op.type == OpType.SNN_LIF:
            steps = max(op.snn_t, 1.0)
            return num.ceil(op.elems / t.sfu_par) * steps, \
                op.elems * steps * self.e_lif
        d = max(op.poly_d, 1.0)
        return op.elems * d / t.sfu_par, op.elems * d * self.e_poly

    def lowered(self, t: Tile, op: Op):
        """(cycles, energy, SRAM energy) of a special op without its
        unit: the FFT as a DFT matmul on the MAC array (its twiddles
        streamed through SRAM), or on the DSP."""
        num = self.num
        n = max(op.fft_n, 2.0)
        if op.type == OpType.FFT and self.on_mac(t, op):
            macs = 4.0 * n * n * max(op.elems / n, 1.0)
            twiddle_b = 2.0 * n * n * self.bpe_tab[op.prec]
            return macs / max(t.nm, 1.0), macs * self.e_mac(t, op.prec), \
                twiddle_b * self.e_sram
        zero = num.f(0.0)
        if op.type == OpType.SNN_LIF:
            steps = max(op.snn_t, 1.0)
            ops = op.elems * 4.0
            cyc = steps * (num.ceil(ops / (t.lanes / 4.0))
                           + num.ceil(op.elems * 8.0 / t.sram_bpc))
            return cyc, ops * steps * self.e_dsp, zero
        if op.type == OpType.POLY:
            d = max(op.poly_d, 1.0)
            ops = op.elems * 2.0
            cyc = d * (num.ceil(ops / t.lanes)
                       + num.ceil(op.elems * 2.0 / t.sram_bpc))
            return cyc, d * ops * self.e_dsp, zero
        ops = op.elems * 10.0 * num.log2(n)
        return num.ceil(ops / t.lanes), ops * self.e_dsp, zero

    # ---------------------------------------------------------- Eq. 2
    def roofline(self, t: Tile, op: Op, bw_gbps):
        """The mapper's estimate: the larger of compute and DRAM cycles."""
        per_cycle = bw_gbps * 1e9 / t.clock_hz
        c_bw = (op.b_in + op.b_w + op.b_out) / max(per_cycle, 1e-9)
        if op.cls == OpClass.MAC:
            if self.on_mac(t, op):
                c = op.macs / max(t.nm * self.eta(t, op), 1e-9)
            else:
                c = self.mac_on_dsp(t, op)[0]
        elif op.cls == OpClass.DSP:
            c = self.dsp(t, op)[0]
        elif self.has_sfu(t, op):
            c = self.sfu(t, op)[0]
        else:
            c = self.lowered(t, op)[0]
        return max(c, c_bw)

    # ---------------------------------------------------------- Eq. 5
    def execute(self, t: Tile, op: Op, bw_gbps, dram_rd, dram_wr):
        """(seconds, energy pJ, DRAM bytes) of the op on the tile, with
        ``dram_rd`` / ``dram_wr`` bytes staged through DRAM at
        ``bw_gbps``."""
        num = self.num
        stream_b = op.b_in + op.b_out
        stream_cyc = num.ceil(stream_b / t.sram_bpc)
        stream_e = stream_b * self.e_sram
        if op.cls == OpClass.MAC and self.on_mac(t, op):
            c_cmp, c_mem, e = self.mac_array(t, op)
        elif op.cls == OpClass.MAC:
            c_cmp, e = self.mac_on_dsp(t, op)
            c_mem, e = stream_cyc, e + stream_e
        elif op.cls == OpClass.DSP:
            c_cmp, e = self.dsp(t, op)
            c_mem, e = stream_cyc, e + stream_e
        elif self.has_sfu(t, op):
            c_cmp, e = self.sfu(t, op)
            c_mem, e = stream_cyc, e + stream_e
        else:
            c_cmp, e, twiddle_e = self.lowered(t, op)
            c_mem, e = stream_cyc, e + (stream_e + twiddle_e)
        # burst-aligned DRAM staging, plus the access latency
        rd = num.ceil(dram_rd / BURST) * BURST if dram_rd > 0 else 0.0
        wr = num.ceil(dram_wr / BURST) * BURST if dram_wr > 0 else 0.0
        dram_b = rd + wr
        per_cycle = bw_gbps * 1e9 / t.clock_hz
        c_dram = dram_b / max(per_cycle, 1e-9) + self.dram_lat \
            if dram_b > 0 else 0.0
        c_rd, c_wr = num.ceil(dram_rd / BURST), num.ceil(dram_wr / BURST)
        if t.double_buffer:
            cyc = max(c_cmp, c_mem, c_dram) + c_rd + c_wr
        else:
            cyc = c_cmp + c_mem + c_dram + c_rd + c_wr
        return cyc / t.clock_hz, e + dram_b * self.e_dram, num.f(dram_b)

    # -------------------------------------------------------- the chip
    def leakage(self, tiles, busy, makespan):
        """Leakage over the makespan; a tile that ran nothing is power
        gated to a residual."""
        total = 0.0
        for t, used in zip(tiles, busy):
            total = total + self.leak * t.area * makespan \
                * (1.0 if used else self.gated) * 1e9
        return total
