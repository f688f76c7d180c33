"""Simulator output records (paper §3.3.6).

Port of ``repro/core/simulator/outputs.py``: plain host dataclasses that
the ``ChipSim`` oracle fills (per-op trace, per-tile breakdowns, chip
energy by module), with the ``golden_dict`` snapshot, ``summary`` and the
chrome trace."""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

__all__ = ["EnergyBreakdown", "OpResult", "TileBreakdown", "SimResult"]

ENERGY_MODULES = (
    "compute", "dram", "sram", "irf", "orf", "dsp", "special", "noc", "leakage",
)


@dataclasses.dataclass
class EnergyBreakdown:
    """Per-module energy in pJ (Eq. 6 terms + NoC + leakage)."""

    compute: float = 0.0
    dram: float = 0.0
    sram: float = 0.0
    irf: float = 0.0
    orf: float = 0.0
    dsp: float = 0.0
    special: float = 0.0
    noc: float = 0.0
    leakage: float = 0.0
    fuse_savings: float = 0.0  # subtracted (E_fuse in Eq. 6)

    @property
    def total_pj(self) -> float:
        return (self.compute + self.dram + self.sram + self.irf + self.orf
                + self.dsp + self.special + self.noc + self.leakage
                - self.fuse_savings)

    def add(self, other: "EnergyBreakdown") -> None:
        for f in ENERGY_MODULES + ("fuse_savings",):
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def as_dict(self) -> Dict[str, float]:
        d = {f: getattr(self, f) for f in ENERGY_MODULES}
        d["fuse_savings"] = self.fuse_savings
        d["total"] = self.total_pj
        return d


@dataclasses.dataclass
class OpResult:
    """One executed operator on one tile."""

    op_index: int
    tile_index: int
    path: str                    # "MAC" | "DSP" | "SFU"
    start_s: float
    finish_s: float
    cycles: float
    energy: EnergyBreakdown
    roofline: str = "compute"    # "compute" | "memory"
    split_tiles: int = 1         # >1 when the mapper split the op (Eq. 3)
    cache: str = "miss"          # "hit" | "noc" | "miss"

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.start_s


@dataclasses.dataclass
class TileBreakdown:
    tile_index: int
    template: str
    active_s: float = 0.0
    ops: int = 0
    macs: float = 0.0
    energy: EnergyBreakdown = dataclasses.field(default_factory=EnergyBreakdown)
    power_gated: bool = False

    def utilization(self, makespan_s: float) -> float:
        return self.active_s / makespan_s if makespan_s > 0 else 0.0


@dataclasses.dataclass
class SimResult:
    """End-to-end result for one (workload, architecture) pair (§3.3.6)."""

    workload: str
    arch: str
    latency_s: float
    energy_pj: float
    area_mm2: float
    peak_tops: float
    achieved_tops: float
    energy_breakdown: EnergyBreakdown
    tiles: List[TileBreakdown]
    ops: List[OpResult]
    total_macs: float
    arithmetic_intensity: float
    # §3.2 schedule mode this plan was emitted in.  For throughput-mode
    # runs ``pipeline`` carries the steady state: ``ii_s`` (initiation
    # interval), ``fill_latency_s`` (= one-batch makespan), the three
    # per-resource bounds (``ii_tile_bound_s`` / ``ii_dram_bound_s`` /
    # ``ii_noc_bound_s``), ``energy_ss_pj`` (per-inference energy with
    # leakage charged over II) and ``pipeline_depth``.
    mode: str = "latency"
    pipeline: Optional[Dict[str, float]] = None

    @property
    def avg_power_w(self) -> float:
        # pJ / s -> W is 1e-12
        return self.energy_pj * 1e-12 / self.latency_s if self.latency_s > 0 else 0.0

    @property
    def ii_s(self) -> float:
        """Throughput-mode initiation interval (= latency for latency-mode
        results, where every batch is a full serial replay)."""
        return self.pipeline["ii_s"] if self.pipeline else self.latency_s

    @property
    def tops_per_w(self) -> float:
        p = self.avg_power_w
        return self.achieved_tops / p if p > 0 else 0.0

    @property
    def tops_per_mm2(self) -> float:
        return self.achieved_tops / self.area_mm2 if self.area_mm2 > 0 else 0.0

    def golden_dict(self) -> Dict:
        """Full-precision snapshot in the layout of the golden traces
        (tests/golden/): chip metrics, per-module energy, per-tile stats.
        Throughput-mode results additionally freeze the pipeline steady
        state (mode + II + bounds); latency-mode payloads are unchanged so
        pre-existing golden files stay valid."""
        d = {
            "workload": self.workload,
            "arch": self.arch,
            "latency_s": self.latency_s,
            "energy_pj": self.energy_pj,
            "area_mm2": self.area_mm2,
            "peak_tops": self.peak_tops,
            "achieved_tops": self.achieved_tops,
            "total_macs": self.total_macs,
            "arithmetic_intensity": self.arithmetic_intensity,
            "num_ops": len(self.ops),
            "energy_breakdown": self.energy_breakdown.as_dict(),
            "tiles": [
                {
                    "template": b.template,
                    "ops": b.ops,
                    "macs": b.macs,
                    "active_s": b.active_s,
                    "power_gated": bool(b.power_gated),
                    "energy_pj": b.energy.total_pj,
                }
                for b in self.tiles
            ],
        }
        if self.pipeline is not None:
            d["mode"] = self.mode
            d["pipeline"] = dict(self.pipeline)
        return d

    def summary(self) -> Dict[str, float]:
        out = {
            "workload": self.workload,
            "arch": self.arch,
            "latency_us": self.latency_s * 1e6,
            "energy_uj": self.energy_pj * 1e-6,
            "area_mm2": self.area_mm2,
            "avg_power_w": self.avg_power_w,
            "peak_tops": self.peak_tops,
            "achieved_tops": self.achieved_tops,
            "tops_per_w": self.tops_per_w,
            "tops_per_mm2": self.tops_per_mm2,
            "arithmetic_intensity": self.arithmetic_intensity,
        }
        if self.pipeline is not None:
            out["ii_us"] = self.pipeline["ii_s"] * 1e6
            out["energy_ss_uj"] = self.pipeline["energy_ss_pj"] * 1e-6
            out["pipeline_depth"] = self.pipeline["pipeline_depth"]
        return out

    # -- chrome trace (stands in for the paper's Perfetto output) ------------
    def chrome_trace(self, batches: int = 1) -> str:
        """Per-op timeline (one ``pid`` row group per batch).

        For throughput-mode results ``batches > 1`` replays the plan with
        the per-batch steady-state offset of II seconds, visualizing the
        pipelined overlap of successive inferences (the fill batch is
        ``pid 0``; batch ``b`` is shifted by ``b * II``)."""
        if batches > 1 and self.pipeline is None:
            raise ValueError(
                "multi-batch traces need a throughput-mode result "
                "(plan emitted with mode='throughput')")
        offset = self.pipeline["ii_s"] if batches > 1 else 0.0
        events = []
        for b in range(batches):
            for r in self.ops:
                events.append({
                    "name": f"op{r.op_index}:{r.path}",
                    "ph": "X",
                    "ts": (r.start_s + b * offset) * 1e6,
                    "dur": max(r.latency_s * 1e6, 1e-3),
                    "pid": b,
                    "tid": r.tile_index,
                    "args": {"cycles": r.cycles, "roofline": r.roofline,
                             "cache": r.cache, "split": r.split_tiles,
                             "batch": b},
                })
        return json.dumps({"traceEvents": events})
