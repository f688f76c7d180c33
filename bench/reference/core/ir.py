"""MOSAIC workload IR: the 23-operator vocabulary and the DAG representation.

A *workload* is a directed acyclic graph (DAG) of operators (paper §3.1).
Each operator carries a type from a 23-entry vocabulary (5 MAC-class,
15 DSP-class, 3 special), a shape (expressed as GEMM-equivalent M/K/N
dimensions plus an element count for non-GEMM ops), a precision, and
per-operand sparsity rates.

Two representations coexist:

* ``OpNode`` / ``WorkloadGraph`` — the object graph the compiler passes
  mutate (precision assignment, fusion tags, mapping results).
* ``OpTensor`` — a structure-of-arrays (SoA) encoding of the same graph as
  fixed-width numpy arrays, consumed by the candidate-batched torch
  executor (``simulator.batched``) and packed for the CUDA ``dse_eval``
  roofline kernel (``dse.prefilter``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "OpType",
    "OpClass",
    "Precision",
    "PRECISION_BYTES",
    "OpNode",
    "WorkloadGraph",
    "OpTensor",
    "PlanTensor",
    "MAX_PREDS",
    "AXIS_CODES",
    "AXIS_NAMES",
    "bucket_ops",
    "placement_rows",
]

MAX_PREDS = 4  # fixed predecessor fan-in for the SoA encoding (padded with -1)

# Split-axis integer codes shared by slice_op, the plan lowering
# (compiler.pipeline.lower_plan), the batched mapper and the batched
# executor.
AXIS_CODES = {"": -1, "OC": 0, "B": 1, "IC": 2}
AXIS_NAMES = {v: k for k, v in AXIS_CODES.items()}


def placement_rows(owner: "np.ndarray", n_split: "np.ndarray",
                   split_axis: "np.ndarray", split_mask: "np.ndarray"
                   ) -> Dict[int, Tuple[Tuple[int, ...], str]]:
    """Decode ONE candidate's stacked placement arrays back into per-op
    placement tuples ``{op index: (tiles, axis)}`` — the row-wise inverse
    of ``compiler.pipeline.lower_plan``'s placement lowering, shared by
    the oracle-replay helper (``compiler.pipeline.plan_from_arrays``) and
    the mapper parity tests.

    ``owner`` / ``n_split`` / ``split_axis`` are (max_ops,) integer
    arrays, ``split_mask`` (max_ops, num_tile_slots); rows with
    ``n_split == 0`` (fused / padding) are omitted.  Single placements
    return ``((owner,), "")``; splits return the mask's tile indices in
    ascending order with the owner first — ``lower_plan`` and the batched
    mapper both emit the lowest-index tile as the owner, which
    ``validate()``-ed tables guarantee.
    """
    out: Dict[int, Tuple[Tuple[int, ...], str]] = {}
    for i in np.flatnonzero(np.asarray(n_split) > 0):
        i = int(i)
        k = int(n_split[i])
        if k == 1:
            out[i] = ((int(owner[i]),), "")
        else:
            tiles = tuple(int(t) for t in np.flatnonzero(split_mask[i]))
            out[i] = (tiles, AXIS_NAMES[int(split_axis[i])])
    return out


def bucket_ops(n: int) -> int:
    """Pad op counts to multiples of 64 (the reference's op-table layout;
    padding rows carry ``valid == 0`` and the torch executors skip
    them)."""
    return max(((n + 63) // 64) * 64, 64)


class OpClass(enum.IntEnum):
    MAC = 0      # executed on the MAC array
    DSP = 1      # executed on the vector DSP
    SPECIAL = 2  # executed on a special-function unit (FFT / SNN / poly)


class OpType(enum.IntEnum):
    """23-entry operator vocabulary (paper §3.1): 5 MAC, 15 DSP, 3 special."""

    # --- MAC-class (5) ---
    CONV2D = 0
    DWCONV = 1
    CONV1D = 2
    MATMUL = 3
    FC = 4
    # --- DSP-class (15) ---
    ADD = 5
    MUL = 6
    SOFTMAX = 7
    LAYERNORM = 8
    RMSNORM = 9
    GELU = 10
    SILU = 11
    RELU = 12
    SIGMOID = 13
    POOL = 14
    REDUCE = 15
    GATHER = 16
    SCATTER = 17
    SSM_SCAN = 18
    ROPE = 19
    # --- Special (3) ---
    FFT = 20
    SNN_LIF = 21
    POLY = 22


_MAC_OPS = frozenset({OpType.CONV2D, OpType.DWCONV, OpType.CONV1D, OpType.MATMUL, OpType.FC})
_SPECIAL_OPS = frozenset({OpType.FFT, OpType.SNN_LIF, OpType.POLY})


def op_class(op_type: OpType) -> OpClass:
    if op_type in _MAC_OPS:
        return OpClass.MAC
    if op_type in _SPECIAL_OPS:
        return OpClass.SPECIAL
    return OpClass.DSP


class Precision(enum.IntEnum):
    INT4 = 0
    INT8 = 1
    FP16 = 2
    BF16 = 3
    FP32 = 4


# bytes per element, indexed by Precision
PRECISION_BYTES = np.array([0.5, 1.0, 2.0, 2.0, 4.0], dtype=np.float64)


@dataclasses.dataclass
class OpNode:
    """One operator in a workload DAG.

    GEMM-equivalent dims: a MAC op computes an (M x K) @ (K x N) product
    (convolutions are im2col-lowered: M = out pixels, K = Cin*kh*kw,
    N = Cout).  DSP/special ops use ``elems`` (element count of the
    dominant operand); M/K/N stay 0.
    """

    name: str
    op_type: OpType
    # GEMM dims (MAC ops)
    m: int = 0
    k: int = 0
    n: int = 0
    # element count (DSP / special ops)
    elems: int = 0
    precision: Precision = Precision.FP16
    # operand byte counts; filled by finalize() if left at 0
    bytes_in: int = 0
    bytes_w: int = 0
    bytes_out: int = 0
    act_sparsity: float = 0.0   # fraction of zero activations
    w_sparsity: float = 0.0     # fraction of zero weights
    preds: List[int] = dataclasses.field(default_factory=list)
    # special-op parameters
    fft_n: int = 0              # FFT length (radix-2)
    poly_degree: int = 0        # Horner polynomial degree
    snn_timesteps: int = 0      # LIF integration timesteps
    seq_len: int = 0            # SSM scan sequential multiplier (paper §3.3.1)
    # splitting permission along OC / batch / IC (paper Eq. 3 context)
    splittable: bool = True
    # accuracy-sensitive layers are pinned to FP16 by compiler pass 1
    accuracy_sensitive: bool = False
    # compiler pass results
    fused_into: int = -1        # index of group head when fused away
    fused_count: int = 0        # number of ops folded into this head
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def op_cls(self) -> OpClass:
        return op_class(self.op_type)

    @property
    def macs(self) -> int:
        if self.op_cls != OpClass.MAC:
            return 0
        return self.m * self.k * self.n

    def finalize(self) -> "OpNode":
        """Fill operand byte counts from dims when not explicitly given."""
        bpe = float(PRECISION_BYTES[self.precision])
        if self.op_cls == OpClass.MAC:
            if self.bytes_in == 0:
                self.bytes_in = int(self.m * self.k * bpe)
            if self.bytes_w == 0:
                self.bytes_w = int(self.k * self.n * bpe)
            if self.bytes_out == 0:
                self.bytes_out = int(self.m * self.n * bpe)
        else:
            if self.elems == 0:
                self.elems = max(self.m * max(self.n, 1), 1)
            if self.bytes_in == 0:
                self.bytes_in = int(self.elems * bpe)
            if self.bytes_out == 0:
                self.bytes_out = int(self.elems * bpe)
        return self


@dataclasses.dataclass
class WorkloadGraph:
    """A topologically ordered operator DAG plus workload metadata."""

    name: str
    nodes: List[OpNode] = dataclasses.field(default_factory=list)
    # Default numeric precision of the published model (Table 1 column)
    model_precision: Precision = Precision.FP16
    family: str = ""

    def add(self, node: OpNode, preds: Sequence[int] = ()) -> int:
        """Append ``node`` (preds refer to already-added indices); returns index."""
        idx = len(self.nodes)
        for p in preds:
            if not (0 <= p < idx):
                raise ValueError(f"{self.name}: pred {p} of node {idx} not topological")
        node.preds = list(preds)[:MAX_PREDS]
        node.finalize()
        self.nodes.append(node)
        return idx

    # -- convenience builders used by the workload suite --------------------
    def matmul(self, name: str, m: int, k: int, n: int, preds=(), **kw) -> int:
        return self.add(OpNode(name, OpType.MATMUL, m=m, k=k, n=n, **kw), preds)

    def dsp(self, name: str, op_type: OpType, elems: int, preds=(), **kw) -> int:
        return self.add(OpNode(name, op_type, elems=elems, **kw), preds)

    def validate(self) -> None:
        for i, nd in enumerate(self.nodes):
            for p in nd.preds:
                if p >= i:
                    raise ValueError(f"{self.name}: node {i} has non-topological pred {p}")

    # -- aggregate statistics ------------------------------------------------
    @property
    def total_macs(self) -> int:
        return sum(nd.macs for nd in self.nodes)

    @property
    def total_bytes(self) -> int:
        return sum(nd.bytes_in + nd.bytes_w + nd.bytes_out for nd in self.nodes)

    def arithmetic_intensity(self) -> float:
        """MACs per byte moved (paper Fig. 8 x-axis)."""
        b = self.total_bytes
        return self.total_macs / b if b else 0.0

    def class_histogram(self) -> Dict[str, int]:
        h = {"MAC": 0, "DSP": 0, "SPECIAL": 0}
        for nd in self.nodes:
            h[nd.op_cls.name] += 1
        return h

    def to_tensor(self, max_ops: Optional[int] = None) -> "OpTensor":
        return OpTensor.from_graph(self, max_ops=max_ops)


def slice_op(op: OpNode, axis: str, k: int) -> OpNode:
    """Even 1/k slice of a MAC op along OC (N), B (M) or IC (K) for
    op-splitting (paper Eq. 3 context).  Shared by the mapper's split
    estimate and the orchestrator's split execution."""
    sub = dataclasses.replace(op, preds=list(op.preds))
    if axis == "OC":
        sub.n = max(op.n // k, 1)
    elif axis == "B":
        sub.m = max(op.m // k, 1)
    elif axis == "IC":
        sub.k = max(op.k // k, 1)
    else:
        raise ValueError(f"bad split axis {axis}")
    sub.bytes_in = int(op.bytes_in // (k if axis == "B" else 1))
    sub.bytes_w = int(op.bytes_w // (k if axis != "B" else 1))
    sub.bytes_out = int(op.bytes_out // (k if axis != "IC" else 1))
    return sub


# Field list of the OpTensor op-table (the dse_eval kernel packs a subset).
_SCALAR_FIELDS: Tuple[Tuple[str, np.dtype], ...] = (
    ("op_type", np.int32),
    ("op_cls", np.int32),
    ("macs", np.float64),
    ("elems", np.float64),
    ("m", np.float64),
    ("k", np.float64),
    ("n", np.float64),
    ("precision", np.int32),
    ("bytes_in", np.float64),
    ("bytes_w", np.float64),
    ("bytes_out", np.float64),
    ("act_sparsity", np.float64),
    ("w_sparsity", np.float64),
    ("fft_n", np.float64),
    ("poly_degree", np.float64),
    ("snn_timesteps", np.float64),
    ("seq_len", np.float64),
    ("splittable", np.int32),
    ("fused", np.int32),        # 1 if folded into a predecessor (skipped)
    ("fused_count", np.int32),  # fused group size when this is a head
    ("valid", np.int32),        # 0 on padding rows
)


@dataclasses.dataclass
class OpTensor:
    """SoA encoding of a workload graph (padded to ``max_ops`` rows)."""

    name: str
    num_ops: int
    arrays: Dict[str, np.ndarray]
    preds: np.ndarray  # (max_ops, MAX_PREDS) int32, -1 padded

    def __getattr__(self, item: str) -> np.ndarray:
        try:
            return self.arrays[item]
        except KeyError as e:  # pragma: no cover - attribute protocol
            raise AttributeError(item) from e

    @property
    def max_ops(self) -> int:
        return self.preds.shape[0]

    @staticmethod
    def from_graph(g: WorkloadGraph, max_ops: Optional[int] = None) -> "OpTensor":
        g.validate()
        n = len(g.nodes)
        cap = max_ops or n
        if cap < n:
            raise ValueError(f"{g.name}: {n} ops exceed max_ops={cap}")
        arrays: Dict[str, np.ndarray] = {
            fname: np.zeros(cap, dtype=dt) for fname, dt in _SCALAR_FIELDS
        }
        preds = np.full((cap, MAX_PREDS), -1, dtype=np.int32)
        for i, nd in enumerate(g.nodes):
            arrays["op_type"][i] = int(nd.op_type)
            arrays["op_cls"][i] = int(nd.op_cls)
            arrays["macs"][i] = nd.macs
            arrays["elems"][i] = nd.elems
            arrays["m"][i] = nd.m
            arrays["k"][i] = nd.k
            arrays["n"][i] = nd.n
            arrays["precision"][i] = int(nd.precision)
            arrays["bytes_in"][i] = nd.bytes_in
            arrays["bytes_w"][i] = nd.bytes_w
            arrays["bytes_out"][i] = nd.bytes_out
            arrays["act_sparsity"][i] = nd.act_sparsity
            arrays["w_sparsity"][i] = nd.w_sparsity
            arrays["fft_n"][i] = nd.fft_n
            arrays["poly_degree"][i] = nd.poly_degree
            arrays["snn_timesteps"][i] = nd.snn_timesteps
            arrays["seq_len"][i] = nd.seq_len
            arrays["splittable"][i] = int(nd.splittable)
            arrays["fused"][i] = int(nd.fused_into >= 0)
            arrays["fused_count"][i] = nd.fused_count
            arrays["valid"][i] = 1
            for j, p in enumerate(nd.preds[:MAX_PREDS]):
                preds[i, j] = p
        return OpTensor(name=g.name, num_ops=n, arrays=arrays, preds=preds)


# Placement fields of the plan op-table (PlanTensor), alongside the
# _SCALAR_FIELDS op fields.  ``owner`` is the first placement tile
# (ChipSim's ``pl.tiles[0]``), ``n_split`` the placement width, and
# ``split_mask`` the per-instance-slot membership of a split execution.
PLAN_FIELDS: Tuple[Tuple[str, np.dtype], ...] = (
    ("owner", np.int32),
    ("n_split", np.int32),
    ("split_axis", np.int32),   # AXIS_CODES; -1 on single placements
)


@dataclasses.dataclass
class PlanTensor:
    """SoA encoding of a compiled ExecutionPlan (paper §3.2 output).

    The op-table the batched simulator executes: the workload's
    ``OpTensor`` (ops padded to a fixed row count) plus per-op placement
    integer arrays and the config-independent auxiliaries the orchestrator
    needs (per-pred byte shares, fused-group PPM/refund credits).

    Built by ``repro.core.compiler.pipeline.lower_plan``; executed by
    ``repro.core.simulator.batched``.
    """

    ops: OpTensor
    owner: np.ndarray        # (max_ops,) int32; -1 on fused/padding rows
    n_split: np.ndarray      # (max_ops,) int32; 0 on fused/padding rows
    split_axis: np.ndarray   # (max_ops,) int32; AXIS_CODES values
    split_mask: np.ndarray   # (max_ops, num_tile_slots) int8
    num_tiles: int           # instantiated tiles of the target chip
    aux: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # §3.2 schedule mode stamped from ExecutionPlan.mode by lower_plan:
    # "latency" (one batch, makespan-scored) or "throughput" (pipelined
    # batches, scored by the steady-state initiation interval).  The
    # batched executor dispatches on it — backends refuse modes they
    # cannot model instead of silently returning latency numbers.
    mode: str = "latency"

    @property
    def name(self) -> str:
        return self.ops.name

    @property
    def max_ops(self) -> int:
        return self.ops.max_ops

    def validate(self) -> None:
        n = self.ops.num_ops
        fused = self.ops.arrays["fused"]
        for i in range(n):
            if fused[i]:
                continue
            if not (0 <= self.owner[i] < self.num_tiles):
                raise ValueError(f"{self.name}: op {i} owner {self.owner[i]} "
                                 f"outside 0..{self.num_tiles - 1}")
            k = int(self.n_split[i])
            if k < 1 or k != int(self.split_mask[i].sum()):
                raise ValueError(f"{self.name}: op {i} split width {k} "
                                 f"inconsistent with its mask")
            if k > 1 and int(self.split_axis[i]) not in (0, 1, 2):
                raise ValueError(f"{self.name}: op {i} split without axis")
