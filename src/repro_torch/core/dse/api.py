"""The engine API surface: ``EngineConfig`` and the store context digest.

Port of ``repro/core/dse/api.py``.  ``EngineConfig`` keeps the
reference's fields, defaults and validation.  The device is not a config
field: ``EvalEngine`` takes it as a constructor argument.  It does enter
the port's ``context_digest``, together with the framework name, so a
store never serves a row computed by the reference (or on another
device) to the port, and a service client or a cluster refuses a worker
on another device type.

``Evaluator`` is the protocol every scoring surface satisfies -- the
local ``EvalEngine``, the in-process and TCP ``DSEClient`` and the
``DSECluster`` (``repro_torch.serve``) -- pinned by the conformance suite
in tests/test_torch_api.py.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import (Any, Dict, Optional, Protocol, Sequence,
                    runtime_checkable)

import numpy as np

from ..calibrate.asap7 import CalibrationTable
from ..simulator.costs import COST_MODEL_VERSION, FIDELITIES
from ..simulator.orchestrator import SCHEDULE_MODES

__all__ = ["EngineConfig", "Evaluator", "context_digest", "BACKENDS", "EXACT_MAPPERS",
           "NONFINITE_POLICIES", "META_VERSION", "FRAMEWORK"]

BACKENDS = ("scan", "exact", "batched", "oracle")
EXACT_MAPPERS = ("batched", "python")
NONFINITE_POLICIES = ("raise", "skip")

# Version stamp of the result["meta"] schema (the reference's).
META_VERSION = 1

FRAMEWORK = "torch"


def context_digest(workloads: Sequence[str], calib: CalibrationTable,
                   aggressive_int4: bool, enable_fusion: bool,
                   backend: str, fidelity: str, device: str) -> bytes:
    """Digest of everything a memoized metric row depends on besides the
    (canonical genome, mode) pair: the reference's fields (workload list
    and order, calibration, compile flags, mapping class, fidelity tier,
    cost-model version) plus the framework and the device type."""
    mapping = "approx" if backend == "scan" else "exact"
    text = repr((tuple(workloads), repr(calib), bool(aggressive_int4),
                 bool(enable_fusion), mapping, str(fidelity),
                 COST_MODEL_VERSION, FRAMEWORK, str(device)))
    return hashlib.sha256(text.encode()).digest()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Every ``EvalEngine`` knob in one frozen, comparable value object.
    ``store`` is excluded from equality / repr (runtime wiring)."""

    backend: str = "scan"
    mode: str = "latency"
    fidelity: str = "aggregate"
    exact_mapper: str = "batched"
    shard: bool = False
    memoize: bool = True
    vectorized: bool = True
    aggressive_int4: bool = False
    enable_fusion: bool = True
    batch: int = 1024
    memo_max: Optional[int] = None
    nonfinite: str = "raise"
    store: Optional[Any] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.mode not in SCHEDULE_MODES:
            raise ValueError(f"mode {self.mode!r} not in {SCHEDULE_MODES}")
        if self.fidelity not in FIDELITIES:
            raise ValueError(
                f"fidelity {self.fidelity!r} not in {FIDELITIES}")
        if self.exact_mapper not in EXACT_MAPPERS:
            raise ValueError(f"exact_mapper {self.exact_mapper!r} not in "
                             f"{EXACT_MAPPERS}")
        if self.nonfinite not in NONFINITE_POLICIES:
            raise ValueError(f"nonfinite {self.nonfinite!r} not in "
                             f"{NONFINITE_POLICIES}")
        if self.backend == "exact" and self.exact_mapper != "batched":
            raise ValueError("backend='exact' is the fused search kernel; "
                             "it cannot run exact_mapper='python'")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")

    def context_digest(self, workloads: Sequence[str],
                       calib: CalibrationTable, device) -> bytes:
        """The content-context digest this config induces for a given
        (workloads, calib, device) triple -- see module-level
        ``context_digest``.  Unlike the reference's method it takes the
        device (a ``torch.device`` or its type name), because the port's
        digest includes the device type."""
        return context_digest(workloads, calib, self.aggressive_int4,
                              self.enable_fusion, self.backend,
                              self.fidelity, getattr(device, "type", device))


@runtime_checkable
class Evaluator(Protocol):
    """What a scoring surface must provide for the search frontends
    (sweep / GA / Bayes / hillclimb) and the serving layer to drive it.
    Satisfied by ``EvalEngine``, ``DSEClient`` (both bindings) and
    ``DSECluster``.

    Metric contract: ``evaluate``/``rescore``/``score_batch`` return a
    dict of float64 numpy ``latency`` (N, W), ``energy`` (N, W),
    ``tops_w`` (N, W), ``area`` (N,); ``evaluate`` and ``rescore``
    additionally carry a ``"meta"`` dict stamped with ``meta_version``
    (see ``META_VERSION``).
    """

    workloads: Sequence[str]
    stats: Any

    def evaluate(self, genomes: np.ndarray, keep=None,
                 mode: Optional[str] = None,
                 canonical: Optional[np.ndarray] = None
                 ) -> Dict[str, Any]: ...

    def rescore(self, genomes: np.ndarray, oracle: bool = False,
                mode: Optional[str] = None) -> Dict[str, Any]: ...

    def score_batch(self, genomes: np.ndarray,
                    mode: Optional[str] = None) -> Dict[str, Any]: ...

    def context_key(self) -> bytes: ...
