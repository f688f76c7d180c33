"""Durable checkpoint/resume for the §4 multi-seed pipeline.

Port of ``repro/core/dse/checkpoint.py``: the records, the run digest and
the directory layout are the reference's.  In the port the GA streams
are keyed by ``seed + bracket`` through the draw source
(``ga_device.TorchDraws`` by default), and the engine context folds in
the framework and the device type.

A paper-scale ``run_pipeline`` study is hours of work whose stages are
already deterministic and content-addressed: sweeps are keyed by seed,
GA genome streams by ``seed + bracket``, and every metric row
is bitwise reproducible and memo-hit inert.  That means resume needs no
mid-kernel state capture at all — it only has to make each *stage
boundary* durable:

* after every sweep: the ``SweepResult`` arrays (which double as store
  rows — resume re-imports them, so refinements of a resumed run hit
  the store exactly like the uninterrupted run's warm store);
* after every refinement: the ``GAResult``, the final population and
  its metrics, the cumulative Pareto front *after* merging the stage,
  and the device-memo **delta** (the ``fresh_entries`` computed by this
  bracket) so later brackets' memo preloads stay warm across a resume;
* after every seed: a ``seed_done`` watermark.

Each stage is one ``.npz`` record written atomically (tmp file +
``os.replace`` + directory fsync): a SIGKILL at any instant leaves
either no record or a complete one, never a torn file.  Presence of the
record *is* the watermark — there is no manifest to double-write.

``meta.json`` pins a **run digest** — engine ``context_key()`` (which
already folds workloads, calibration, compile flags, backend fidelity,
and the cost-model version) plus every pipeline parameter that shapes
the outputs (seeds, brackets, samples per stratum, the full
``GAConfig``, island topology).  Resuming against a directory whose
digest differs raises ``CheckpointMismatch`` instead of silently mixing
two studies.

Bitwise-equality argument (pinned by tests/test_torch_pipeline.py): a
resumed run replays completed stages from records (bitwise, via npz)
and recomputes the rest from the same keyed RNG streams against a store
whose *values* are bitwise identical — and since memo/store hits are
bitwise inert everywhere in the engine and the fused loop, the merged
front, per-seed results, and ``best()`` match an uninterrupted run
bit for bit.

The checkpoint directory can also host the study's persistent result
store (``open_store()`` → ``TieredStore`` over ``results.sqlite``), so
one directory is the whole resumable study.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from .store import MemoryLRUStore, SqliteStore, TieredStore

__all__ = ["CheckpointMismatch", "PipelineCheckpoint", "run_digest"]

_FORMAT = 1


class CheckpointMismatch(ValueError):
    """The checkpoint directory was written by a different study
    (engine context or pipeline parameters differ)."""


def run_digest(engine, seeds: Iterable[int], brackets: Iterable[float],
               samples_per_stratum: int, cfg, islands: Optional[int],
               migrate_every: int, migrate_k: int) -> str:
    """Digest of everything that determines the study's outputs."""
    text = repr((engine.context_key().hex(), engine.mode,
                 tuple(int(s) for s in seeds),
                 tuple(float(b) for b in brackets),
                 int(samples_per_stratum), dataclasses.astuple(cfg),
                 islands if islands is None else int(islands),
                 int(migrate_every), int(migrate_k), _FORMAT))
    return hashlib.sha256(text.encode()).hexdigest()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class PipelineCheckpoint:
    """One directory of atomic per-stage records (see module docstring).

    Stage keys are ``sweep:<seed>``, ``refine:<seed>:<bracket:g>`` and
    ``seed_done:<seed>``; ``record()`` makes a key durable, ``has()``
    answers whether a prior run completed it, ``load()`` returns its
    arrays.  ``open()`` must run first: it writes the run digest on a
    fresh directory and verifies it on an existing one.
    """

    def __init__(self, path: str):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self._digest: Optional[str] = None
        self._done: Dict[str, str] = {}   # stage key -> filename

    # --------------------------------------------------------------- lifecycle
    def open(self, digest: str) -> "PipelineCheckpoint":
        meta_path = os.path.join(self.path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("format") != _FORMAT:
                raise CheckpointMismatch(
                    f"checkpoint format {meta.get('format')!r} != {_FORMAT}")
            if meta.get("digest") != digest:
                raise CheckpointMismatch(
                    "checkpoint directory belongs to a different study "
                    f"(digest {meta.get('digest')!r:.20} != {digest!r:.20}); "
                    "use a fresh directory or rerun with the original "
                    "workloads/seeds/brackets/GA config")
        else:
            self._write_atomic(meta_path, json.dumps(
                {"format": _FORMAT, "digest": digest}).encode())
        self._digest = digest
        self._scan()
        return self

    def _write_atomic(self, path: str, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        _fsync_dir(self.path)

    def _scan(self) -> None:
        """Index complete records.  Only ``*.npz`` final names count —
        interrupted writes only ever leave ``*.tmp`` files behind."""
        self._done.clear()
        for fname in sorted(os.listdir(self.path)):
            if not fname.endswith(".npz"):
                continue
            full = os.path.join(self.path, fname)
            try:
                with np.load(full) as f:
                    key = str(f["stage"])
            except Exception:
                continue   # unreadable/foreign file — treat as absent
            self._done[key] = fname

    # ----------------------------------------------------------------- stages
    @staticmethod
    def _fname(key: str) -> str:
        return key.replace(":", "_").replace(".", "-") + ".npz"

    def completed(self) -> List[str]:
        return sorted(self._done)

    def has(self, key: str) -> bool:
        return key in self._done

    def record(self, key: str, **arrays: Any) -> None:
        """Make one completed stage durable (atomic; idempotent —
        last-write-wins, but stage outputs are deterministic so every
        write holds the same bytes)."""
        if self._digest is None:
            raise RuntimeError("PipelineCheckpoint.open() must run first")
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, stage=np.asarray(key), **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.path, self._fname(key)))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        _fsync_dir(self.path)
        self._done[key] = self._fname(key)

    def load(self, key: str) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.path, self._done[key])) as f:
            return {k: f[k].copy() for k in f.files if k != "stage"}

    # ------------------------------------------------------------------ store
    def store_path(self) -> str:
        return os.path.join(self.path, "results.sqlite")

    def open_store(self, lru_entries: int = 131_072) -> TieredStore:
        """The study's persistent result store, living in the checkpoint
        directory: LRU front over ``results.sqlite``."""
        return TieredStore(MemoryLRUStore(lru_entries),
                           SqliteStore(self.store_path()))
