"""Pareto-front utilities for the (energy, area, latency) PEA triple
(paper §3.5, §4.2 -- lower is better on every axis).

Port of ``repro/core/dse/pareto.py``: ``pareto_mask`` and
``pareto_front`` are the reference's numpy code; ``pareto_mask_device``
is the same mask as one vectorized torch computation on an explicit
device."""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device

__all__ = ["pareto_front", "pareto_mask", "pareto_mask_device"]


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows.  ``points``: (N, D), lower is
    better on every column.  O(N^2) but N is the finalist set, not the
    sweep.

    Bitwise-identical rows are mutually non-dominating, so without a
    dedupe every copy would survive -- and cumulative fronts would grow
    with each repeated candidate.  Only the first copy of a duplicate row
    is kept.
    """
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    mask = np.ones(n, dtype=bool)
    if n == 0:
        return mask
    # keep-first dedupe before the dominance loop
    _, first = np.unique(pts, axis=0, return_index=True)
    keep_first = np.zeros(n, dtype=bool)
    keep_first[first] = True
    mask &= keep_first
    for i in range(n):
        if not mask[i]:
            continue
        dominates = np.all(pts <= pts[i], axis=1) & np.any(pts < pts[i], axis=1)
        if np.any(dominates & mask):
            mask[i] = False
    return mask


def pareto_mask_device(points, device=None) -> torch.Tensor:
    """``pareto_mask`` as one vectorized computation on ``device`` (the
    card unless ``"cpu"`` is asked for), returned there as an (N,) bool
    tensor.  Same semantics: keep-first dedupe of bitwise-identical rows,
    then dominance (a row is dropped iff some row is <= on every column
    and < on at least one).  O(N^2) memory, fine for finalist sets."""
    pts = torch.as_tensor(np.asarray(points, np.float64)
                          if not isinstance(points, torch.Tensor)
                          else points, dtype=torch.float64,
                          device=resolve_device(device))
    n = pts.shape[0]
    if n == 0:
        return torch.ones((0,), dtype=torch.bool, device=pts.device)
    a, b = pts[:, None, :], pts[None, :, :]                 # [i], [j]
    idx = torch.arange(n, device=pts.device)
    earlier = idx[None, :] < idx[:, None]                   # j < i
    dup = ((a == b).all(dim=2) & earlier).any(dim=1)
    dominated = ((b <= a).all(dim=2) & (b < a).any(dim=2)).any(dim=1)
    return ~dup & ~dominated


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Indices of the Pareto-optimal rows, sorted by the first column."""
    idx = np.nonzero(pareto_mask(points))[0]
    return idx[np.argsort(np.asarray(points)[idx, 0])]
