"""Score genomes on workloads without the program: the rows that
``EvalEngine.evaluate`` returns, worked out again.

``score(genomes, workloads, how, precision)`` returns ``latency``,
``energy`` and ``tops_w`` (N, W) float64 and ``area`` (N,), in latency
mode on the aggregate fidelity tier.  Each genome is decoded to its chip
(``decode``, the frozen genome encoding) and walked on each workload's
compiled graph (precision assignment and fusion, the frozen compiler
passes 1-2) by ``simulate``:

* ``"exact"``: the exact Eq. 1-3 mapping and the orchestrator's replay,
  the exact cells' reference;
* ``"scan"``: the scan's approximate in-scan mapping, the scan cells'.

``precision`` is ``"float64"`` (the configuration's) or ``"float32"``
(the lower-precision control).  TOPS/W and the rows of genomes that
read NaN follow ``evaluate``: such a row scores inf / inf / 0 on every
workload; an unmappable pair of the exact mapping scores inf / inf / 0.
Areas come from ``chip_area(decode(g))``.
"""
from __future__ import annotations

import copy
import functools
from typing import Dict, Sequence

import numpy as np

from .core.calibrate.asap7 import DEFAULT_CALIB
from .core.compiler.fusion import fuse
from .core.compiler.precision import assign_precision
from .core.dse.encoding import decode
from .core.simulator.area import chip_area
from .core.workloads import build
from .model import F32, F64, Model
from .simulate import exact, scan

PATHS = {"exact": exact, "scan": scan}
NUMS = {"float64": F64, "float32": F32}


@functools.lru_cache(maxsize=32)
def prepared_graph(name: str):
    """Compiler passes 1-2 (precision, fusion) on one workload, with the
    engine's default flags."""
    return fuse(assign_precision(copy.deepcopy(build(name))))


def active_rows(name: str) -> int:
    """Operators a walk of the workload visits (those not fused away),
    the unit of the per-row metrics."""
    return sum(1 for nd in prepared_graph(name).nodes if nd.fused_into < 0)


def tops_per_watt(lat, en, tops):
    """TOPS/W from latency (s), energy (pJ) and achieved TOPS, with the
    engine's guards against a zero latency or power."""
    with np.errstate(invalid="ignore", divide="ignore"):
        power = np.asarray(en) * 1e-12 / np.maximum(lat, 1e-30)
        return np.asarray(tops) / np.maximum(power, 1e-30)


def score(genomes, workloads: Sequence[str], how: str = "exact",
          precision: str = "float64") -> Dict[str, np.ndarray]:
    if how not in PATHS or precision not in NUMS:
        raise ValueError(f"no reference {how!r} in {precision!r}")
    walk, model = PATHS[how], Model(DEFAULT_CALIB, NUMS[precision])
    genomes = np.asarray(genomes, np.int64)
    n, W = len(genomes), len(workloads)
    out = np.zeros((3, n, W))
    chips = [decode(g, f"g{i}") for i, g in enumerate(genomes)]
    for j, w in enumerate(workloads):
        g = prepared_graph(w)
        for i, chip in enumerate(chips):
            out[:, i, j] = [float(v) for v in
                            walk(chip, g, model, DEFAULT_CALIB)]
    lat, en, tops = out
    tw = tops_per_watt(lat, en, tops)
    if how == "exact":
        tw[~np.isfinite(lat)] = 0.0
    bad = (np.isnan(lat) | np.isnan(en) | np.isnan(tw)
           | np.isinf(tw)).any(axis=1)
    lat[bad], en[bad], tw[bad] = np.inf, np.inf, 0.0
    area = np.asarray([chip_area(c) for c in chips], np.float64)
    return {"latency": lat, "energy": en, "tops_w": tw, "area": area}
