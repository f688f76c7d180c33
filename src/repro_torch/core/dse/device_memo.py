"""Device-resident result memo: a fixed-size open-addressing hash table
of canonical-genome keys living in device memory.

Port of ``repro/core/dse/device_memo.py``.  The engine's host memo
(``dse/store.py``) costs the device GA loop a host round trip per
generation; this module keeps the same (canonical genome -> (lat, en,
tw) row) mapping in tensors on the engine's device, so the fused
refinement loop (``ga_device.run_ga_fused``) probes and fills it without
leaving the card, and the host store is consulted only at seed
boundaries (``memo_from_store`` / ``drain_to_store``).

Layout: linear probing over a ``capacity``-slot table with a bounded
probe window (``PROBES``) --

* ``keys``  (C, GENOME_LEN) int32 -- the canonical genomes (the host
  store's key bytes minus the mode tag: one memo serves one engine mode);
* ``used``  (C,) bool -- slot occupancy;
* ``vals``  (C, 3, W) float64 -- the engine's memo row, (lat, en, tw)
  per workload, bitwise the host store's value;
* ``fresh`` (C,) bool -- slots filled since the last host sync, so the
  seed-boundary drain is a delta.

Semantics are the reference's, and so is the table it builds (the same
slot for every key, the same bits):

* put-if-absent -- an insert that finds its key already present writes
  nothing;
* graceful degradation at full load -- an insert whose probe window
  holds ``PROBES`` other live keys is dropped, never evicted or
  corrupted;
* deterministic -- inserts run as ``PROBES`` synchronized vectorized
  rounds with a lowest-row-index claim per contested slot
  (``scatter_reduce_(reduce="amin")``), so in-batch duplicates resolve
  first-copy-wins.  Each slot then gathers its winner's row: the write
  is a gather over the table, never a scatter with duplicate indices,
  so the result does not depend on the device's scatter order.

The reference exits its round loop once no row is pending; a torch loop
would need a host read per round for that, so the port always runs the
``PROBES`` rounds.  A round with no pending row changes nothing, so the
table is the same.  FNV-1a runs in int64 with a 32-bit mask after each
multiply (``(h ^ g) * 16777619`` stays below 2^57).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...device import F64, resolve_device
from .encoding import GENOME_LEN

__all__ = ["DeviceMemo", "PROBES", "memo_init", "memo_lookup",
           "memo_insert", "memo_fill", "memo_to_arrays",
           "memo_from_store", "drain_to_store", "fresh_entries",
           "clear_fresh"]

# linear-probe window: an insert tries this many consecutive slots before
# dropping; a lookup probes the same window
PROBES = 16

# FNV-1a over the genome's genes, as uint32 arithmetic
_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF


class DeviceMemo(NamedTuple):
    """The table state.  ``fresh`` marks slots filled since the last host
    sync: inserts set it, ``memo_from_store`` clears it after preloading,
    and ``drain_to_store`` exports only fresh slots."""

    keys: torch.Tensor   # (C, GENOME_LEN) int32
    used: torch.Tensor   # (C,) bool
    vals: torch.Tensor   # (C, 3, W) float64
    fresh: torch.Tensor  # (C,) bool

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def memo_init(capacity: int, n_workloads: int, device=None) -> DeviceMemo:
    """Empty table with ``capacity`` slots for (3, W) metric rows on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    c = max(int(capacity), 1)
    return DeviceMemo(
        keys=torch.zeros((c, GENOME_LEN), dtype=torch.int32, device=dev),
        used=torch.zeros((c,), dtype=torch.bool, device=dev),
        vals=torch.zeros((c, 3, int(n_workloads)), dtype=F64, device=dev),
        fresh=torch.zeros((c,), dtype=torch.bool, device=dev))


def _hash(canon: torch.Tensor, capacity: int) -> torch.Tensor:
    """(P,) base slots: FNV-1a folded over the gene axis."""
    g = canon.to(torch.int64) & _U32
    h = torch.full((canon.shape[0],), _FNV_OFFSET, dtype=torch.int64,
                   device=canon.device)
    for i in range(canon.shape[1]):
        h = ((h ^ g[:, i]) * _FNV_PRIME) & _U32
    return h % capacity


def memo_lookup(memo: DeviceMemo, canon: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the table for every row of ``canon`` (P, GENOME_LEN).
    Returns ``hit`` (P,) bool and ``vals`` (P, 3, W) -- slot garbage where
    ``hit`` is False; callers select with ``hit``."""
    c = memo.capacity
    canon = canon.to(torch.int32)
    probes = min(PROBES, c)
    h = _hash(canon, c)
    slots = (h[:, None] + torch.arange(probes, device=canon.device)) % c
    match = memo.used[slots] \
        & (memo.keys[slots] == canon[:, None, :]).all(dim=2)
    hit = match.any(dim=1)
    j = match.to(torch.uint8).argmax(dim=1)       # first matching probe
    s = slots[torch.arange(canon.shape[0], device=canon.device), j]
    return hit, memo.vals[s]


def memo_insert(memo: DeviceMemo, canon: torch.Tensor, vals: torch.Tensor,
                update: Optional[torch.Tensor] = None) -> DeviceMemo:
    """Insert rows (put-if-absent) and return the new table state.

    ``canon``: (P, GENOME_LEN) keys; ``vals``: (P, 3, W) rows;
    ``update``: optional (P,) bool gating which rows insert at all.  Each
    of ``PROBES`` rounds moves every pending row one probe step: a row
    whose slot holds its key retires, rows wanting the same empty slot
    resolve to the lowest row index, in-batch duplicates retire against
    the copy that landed; a row still pending after the last round is
    dropped."""
    c = memo.capacity
    p = canon.shape[0]
    if p == 0:
        return memo
    dev = canon.device
    canon = canon.to(torch.int32)
    vals = vals.to(F64)
    probes = min(PROBES, c)
    h = _hash(canon, c)
    idx = torch.arange(p, device=dev)
    pending = (torch.ones(p, dtype=torch.bool, device=dev) if update is None
               else update.to(device=dev, dtype=torch.bool))
    keys, used, rows, new = memo.keys, memo.used, memo.vals, memo.fresh
    for j in range(probes):
        slot = (h + j) % c
        occ = used[slot]
        match = pending & occ & (keys[slot] == canon).all(dim=1)
        pending = pending & ~match                 # already present
        want = pending & ~occ
        # one winner per contested empty slot: the lowest row index
        claim = torch.full((c,), p, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, slot, torch.where(want, idx, p),
                              reduce="amin")
        win = want & (claim[slot] == idx)
        # every claimed slot takes its winner's row (claim[s] < p exactly
        # for the slots some pending row won this round)
        has = claim < p
        src = torch.clamp(claim, max=p - 1)
        keys = torch.where(has[:, None], canon[src], keys)
        used = used | has
        rows = torch.where(has[:, None, None], vals[src], rows)
        new = new | has
        pending = pending & ~win
        # losers whose key just landed here retire now: put-if-absent
        dup = pending & (keys[slot] == canon).all(dim=1) & used[slot]
        pending = pending & ~dup
    return DeviceMemo(keys, used, rows, new)


def memo_fill(memo: DeviceMemo) -> int:
    """Number of live entries (host-side)."""
    return int(memo.used.sum())


# =============================================================================
# seed-boundary host sync
# =============================================================================

def memo_to_arrays(memo: DeviceMemo) -> Tuple[np.ndarray, np.ndarray]:
    """Host copies of the live entries: (N, GENOME_LEN) int64 canonical
    genomes + (N, 3, W) float64 rows."""
    used = memo.used.cpu().numpy()
    keys = memo.keys.cpu().numpy()[used].astype(np.int64)
    vals = memo.vals.cpu().numpy()[used]
    return keys, vals


def memo_from_store(engine, capacity: int,
                    mode: Optional[str] = None) -> DeviceMemo:
    """Preload a fresh table on the engine's device from the engine
    store's in-memory tier (the host->device half of the seed-boundary
    sync), in the tier's LRU order through ``memo_insert``.  Preloaded
    entries are not fresh: the next drain exports only what the device
    computed since."""
    canon, rows = engine.export_memo(mode)
    memo = memo_init(capacity, len(engine.workloads), engine.device)
    if len(canon) == 0:
        return memo
    dev = engine.device
    memo = memo_insert(memo, torch.as_tensor(canon, device=dev),
                       torch.as_tensor(rows, dtype=F64, device=dev))
    return clear_fresh(memo)


def fresh_entries(memo: DeviceMemo) -> Tuple[np.ndarray, np.ndarray]:
    """Host copies of the entries inserted since the last host sync:
    (N, GENOME_LEN) int64 canonical genomes + (N, 3, W) float64 rows.
    The checkpointing pipeline records these per-stage deltas durably
    (and imports them itself) instead of calling ``drain_to_store``."""
    new = (memo.fresh & memo.used).cpu().numpy()
    keys = memo.keys.cpu().numpy()[new].astype(np.int64)
    vals = memo.vals.cpu().numpy()[new]
    return keys, vals


def clear_fresh(memo: DeviceMemo) -> DeviceMemo:
    """Mark the table synced: the next ``fresh_entries``/
    ``drain_to_store`` exports only what the device computes after
    this."""
    return memo._replace(fresh=torch.zeros_like(memo.fresh))


def drain_to_store(memo: DeviceMemo, engine,
                   mode: Optional[str] = None) -> int:
    """Write every entry inserted since the last host sync into the
    engine's host store (put-if-absent).  A delta: a replay whose every
    probe hit drains nothing.  Returns the number of rows offered."""
    keys, vals = fresh_entries(memo)
    return engine.import_memo(keys, vals, mode)
