"""Result stores for the DSE evaluation engine.

Port of ``repro/core/dse/store.py``: the ``ResultStore`` interface,
``MemoryLRUStore`` (the engine's default bounded LRU memo), the
persistent content-addressed ``SqliteStore`` (one sqlite file in WAL
mode, ``INSERT OR IGNORE`` first-write-wins, bounded lock retries,
cost-model-version invalidation with ``purge_stale``) and
``TieredStore`` (an LRU front over a persistent back, degrading to the
front alone when the back fails).

The engine hands stores short keys -- ``b"<mode>:" + canonical genome
bytes`` -- plus, once at construction, a binding context digest
(``api.context_digest``, which folds in the framework and the device
type, so a port store never serves a row the reference, or the port on
another device, wrote).  Persistent stores fold the context into every
stored key.  Values are ``(lat, en, tw)`` triples of float64 ``(W,)``
arrays; persistence round-trips them through raw little-endian bytes
(the reference's encoding, byte for byte), so a store-served row is
bitwise the computed one.  ``put`` is put-if-absent: metrics for one
key are immutable.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import sqlite3
import threading
import time
import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from ..simulator.costs import COST_MODEL_VERSION

__all__ = ["StoreStats", "ResultStore", "MemoryLRUStore", "SqliteStore",
           "TieredStore", "COST_MODEL_VERSION"]

Row = Tuple[np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class StoreStats:
    """Lifetime counters of one store instance (not of the backing file:
    a shared sqlite file is fed by many instances across processes)."""

    gets: int = 0
    hits: int = 0
    puts: int = 0
    evictions: int = 0
    errors: int = 0     # tier/backing failures survived (degraded ops)

    def hit_rate(self) -> float:
        return self.hits / max(self.gets, 1)

    def snapshot(self) -> Dict[str, float]:
        return {"gets": self.gets, "hits": self.hits, "puts": self.puts,
                "evictions": self.evictions, "errors": self.errors,
                "hit_rate": self.hit_rate()}


class ResultStore:
    """Interface the engine's caching policy is written against."""

    def bind(self, context: bytes) -> "ResultStore":
        """Attach the engine-context digest (see module docstring).
        Returns self.  Persistent stores fold it into every key;
        in-process stores may ignore it.  Rebinding with a different
        context raises — one store instance serves one engine context
        (share the *file*, not the instance)."""
        raise NotImplementedError

    def get(self, key: bytes) -> Optional[Row]:
        raise NotImplementedError

    def put(self, key: bytes, row: Row) -> None:
        """Put-if-absent; values for one key are immutable."""
        raise NotImplementedError

    def peek(self, key: bytes) -> bool:
        """Presence probe with no stats or recency side effects (the
        service uses it for per-request store-hit attribution)."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def lru_dict(self) -> Optional[Dict[bytes, Row]]:
        """The in-memory LRU mapping when this store (or its front tier)
        has one — the engine's legacy ``_memo`` view — else None."""
        return None

    def close(self) -> None:
        pass


class _Bindable(ResultStore):
    def __init__(self) -> None:
        self._context: Optional[bytes] = None
        self.stats = StoreStats()

    def bind(self, context: bytes) -> "ResultStore":
        if self._context is not None and self._context != context:
            raise ValueError(
                "store instance already bound to a different engine "
                "context — construct one instance per engine (a "
                "persistent store may still share the same file path)")
        self._context = context
        return self


class MemoryLRUStore(_Bindable):
    """The historical engine memo as a store: bounded dict-ordered LRU.
    ``get`` refreshes recency; ``put`` evicts the least recently touched
    entry once ``max_entries`` is reached.  Not persistent; the binding
    context is ignored (the owning engine scopes the instance)."""

    def __init__(self, max_entries: int = 131_072):
        super().__init__()
        self.max_entries = max(int(max_entries), 1)
        self.data: Dict[bytes, Row] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[Row]:
        with self._lock:
            self.stats.gets += 1
            row = self.data.get(key)
            if row is None:
                return None
            self.data[key] = self.data.pop(key)   # refresh recency
            self.stats.hits += 1
            return row

    def put(self, key: bytes, row: Row) -> None:
        with self._lock:
            if key in self.data:
                return
            while len(self.data) >= self.max_entries:
                self.data.pop(next(iter(self.data)))
                self.stats.evictions += 1
            self.data[key] = row
            self.stats.puts += 1

    def peek(self, key: bytes) -> bool:
        return key in self.data

    def resize(self, max_entries: int) -> None:
        """Re-cap the LRU, eagerly evicting least-recently-touched
        entries when the new cap is smaller.  The engine applies an
        explicit ``memo_max`` to a caller-supplied store through this
        (previously ``memo_max`` was silently ignored with ``store=``)."""
        with self._lock:
            self.max_entries = max(int(max_entries), 1)
            while len(self.data) > self.max_entries:
                self.data.pop(next(iter(self.data)))
                self.stats.evictions += 1

    def __len__(self) -> int:
        return len(self.data)

    def lru_dict(self) -> Optional[Dict[bytes, Row]]:
        return self.data


class SqliteStore(_Bindable):
    """Persistent content-addressed result store over one sqlite file.

    Stored key = sha256(version digest + engine context + short key):
    canonical genome x chip/engine context x mode x cost-model version,
    fixed 32 bytes.  The file is opened in WAL mode with a busy timeout,
    and every write is a single ``INSERT OR IGNORE`` transaction —
    concurrent writers (threads or processes) serialize on sqlite's file
    lock and first-write-wins keeps the table consistent without any
    application-level locking (values per key are immutable).

    ``version`` defaults to ``simulator.costs.COST_MODEL_VERSION``; a
    bump re-addresses every key, so stale metrics can never be served.
    The superseded rows stay on disk (still tagged with the version that
    wrote them) until ``purge_stale()`` deletes them.

    Busy/locked errors (another writer holding the file lock past the
    30 s sqlite busy timeout, NFS hiccups, an injected fault under the
    chaos suite) are retried with bounded exponential backoff
    (``lock_retries`` attempts) instead of raising straight through
    ``EvalEngine.evaluate()``; only after the retry budget is exhausted
    does the error propagate.  ``close()`` runs a WAL checkpoint first
    so short-lived processes don't leave ``-wal``/``-shm`` files behind.
    """

    LOCK_BACKOFF_S = 0.02   # first retry sleep; doubles, capped at 0.5 s

    def __init__(self, path: str, version: str = COST_MODEL_VERSION,
                 lock_retries: int = 6, fault_injector=None):
        super().__init__()
        self.path = str(path)
        self.version = str(version)
        self.lock_retries = max(int(lock_retries), 1)
        self._faults = None   # armed after setup so schedules count ops only
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()   # sqlite conns are not thread-safe
        self._closed = False
        self._conn = sqlite3.connect(self.path, timeout=30.0,
                                     check_same_thread=False)
        with self._lock:
            self._execute("PRAGMA journal_mode=WAL")
            self._execute("PRAGMA synchronous=NORMAL")
            self._execute(
                "CREATE TABLE IF NOT EXISTS results ("
                " k BLOB PRIMARY KEY,"
                " w INTEGER NOT NULL,"
                " data BLOB NOT NULL,"
                " version TEXT NOT NULL,"
                " created REAL NOT NULL)")
            self._commit()
        self._faults = fault_injector

    # --------------------------------------------------------- lock retries
    @staticmethod
    def _is_lock_error(exc: sqlite3.OperationalError) -> bool:
        msg = str(exc).lower()
        return "locked" in msg or "busy" in msg

    def _retry(self, fn):
        """Run ``fn`` under the bounded-backoff locked/busy retry loop.
        Call with ``self._lock`` held."""
        delay = self.LOCK_BACKOFF_S
        for attempt in range(self.lock_retries):
            if self._faults is not None \
                    and self._faults.should_fire("sqlite_lock"):
                err: sqlite3.OperationalError = sqlite3.OperationalError(
                    "database is locked")
            else:
                try:
                    return fn()
                except sqlite3.OperationalError as exc:
                    if not self._is_lock_error(exc):
                        raise
                    err = exc
            if attempt == self.lock_retries - 1:
                raise err
            time.sleep(delay)
            delay = min(delay * 2, 0.5)
        raise AssertionError("unreachable")

    def _execute(self, sql: str, params: Tuple = ()):
        return self._retry(lambda: self._conn.execute(sql, params))

    def _commit(self) -> None:
        self._retry(self._conn.commit)

    # ------------------------------------------------------------ keys/values
    def _addr(self, key: bytes) -> bytes:
        h = hashlib.sha256()
        h.update(self.version.encode())
        h.update(b"\x00")
        h.update(self._context or b"")
        h.update(b"\x00")
        h.update(key)
        return h.digest()

    @staticmethod
    def _encode(row: Row) -> Tuple[int, bytes]:
        lat, en, tw = (np.ascontiguousarray(a, np.float64) for a in row)
        return len(lat), lat.tobytes() + en.tobytes() + tw.tobytes()

    @staticmethod
    def _decode(w: int, blob: bytes) -> Row:
        flat = np.frombuffer(blob, np.float64)
        return (flat[:w].copy(), flat[w:2 * w].copy(), flat[2 * w:].copy())

    # ------------------------------------------------------------- interface
    def get(self, key: bytes) -> Optional[Row]:
        self.stats.gets += 1
        with self._lock:
            cur = self._execute(
                "SELECT w, data FROM results WHERE k = ?", (self._addr(key),))
            hit = cur.fetchone()
        if hit is None:
            return None
        self.stats.hits += 1
        return self._decode(int(hit[0]), hit[1])

    def put(self, key: bytes, row: Row) -> None:
        w, blob = self._encode(row)
        with self._lock:
            self._execute(
                "INSERT OR IGNORE INTO results (k, w, data, version, created)"
                " VALUES (?, ?, ?, ?, ?)",
                (self._addr(key), w, blob, self.version, time.time()))
            self._commit()
        self.stats.puts += 1

    def peek(self, key: bytes) -> bool:
        with self._lock:
            cur = self._execute(
                "SELECT 1 FROM results WHERE k = ?", (self._addr(key),))
            return cur.fetchone() is not None

    def __len__(self) -> int:
        with self._lock:
            return int(self._execute(
                "SELECT COUNT(*) FROM results").fetchone()[0])

    def version_counts(self) -> Dict[str, int]:
        """Rows per cost-model version in the backing file (stale rows
        are the ones not matching ``self.version``)."""
        with self._lock:
            cur = self._execute(
                "SELECT version, COUNT(*) FROM results GROUP BY version")
            return {v: int(n) for v, n in cur.fetchall()}

    def purge_stale(self) -> int:
        """Delete rows written under any other cost-model version;
        returns the number reclaimed."""
        with self._lock:
            cur = self._execute(
                "DELETE FROM results WHERE version != ?", (self.version,))
            self._commit()
            return cur.rowcount

    def close(self) -> None:
        """Idempotent; checkpoints + truncates the WAL first so a
        short-lived process leaves just the .sqlite file behind."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
            except sqlite3.Error:
                pass   # best effort — another writer may hold the lock
            self._conn.close()


class TieredStore(_Bindable):
    """LRU front tier over a (typically persistent) back tier.

    ``get``: front first; on a front miss the back is probed and a hit
    is promoted into the front (so a warm persistent file refills the
    hot in-process working set at memory speed).  ``put``: write-through
    to both tiers.  Stats: this instance counts the merged view; the
    tiers keep their own counters for attribution.

    Degradation: the back tier is *optional for correctness* (it only
    adds persistence), so a back-tier error — disk full, a locked sqlite
    file past its retry budget, an injected chaos fault — never fails
    the evaluation: the op completes against the LRU front alone, the
    failure is counted in ``stats.errors``, and a ``RuntimeWarning`` is
    emitted once per instance.  Reads degrade to front-only hits, writes
    to front-only inserts; the run loses persistence for those rows,
    not results."""

    def __init__(self, front: ResultStore, back: ResultStore):
        super().__init__()
        self.front = front
        self.back = back
        self._warned_back = False

    def bind(self, context: bytes) -> "ResultStore":
        super().bind(context)
        self.front.bind(context)
        self.back.bind(context)
        return self

    def _back_error(self, op: str, exc: Exception) -> None:
        self.stats.errors += 1
        if not self._warned_back:
            self._warned_back = True
            warnings.warn(
                f"TieredStore back tier failed on {op} ({exc!r}); "
                "continuing LRU-only (counted in stats.errors)",
                RuntimeWarning, stacklevel=3)

    def get(self, key: bytes) -> Optional[Row]:
        self.stats.gets += 1
        row = self.front.get(key)
        if row is None:
            try:
                row = self.back.get(key)
            except Exception as exc:      # degrade: serve front-only
                self._back_error("get", exc)
                row = None
            if row is not None:
                self.front.put(key, row)   # promote
        if row is not None:
            self.stats.hits += 1
        return row

    def put(self, key: bytes, row: Row) -> None:
        self.front.put(key, row)
        try:
            self.back.put(key, row)
        except Exception as exc:          # degrade: lose persistence only
            self._back_error("put", exc)
        self.stats.puts += 1

    def peek(self, key: bytes) -> bool:
        if self.front.peek(key):
            return True
        try:
            return self.back.peek(key)
        except Exception as exc:
            self._back_error("peek", exc)
            return False

    def __len__(self) -> int:
        try:
            n_back = len(self.back)
        except Exception as exc:
            self._back_error("len", exc)
            n_back = 0
        return max(len(self.front), n_back)

    def lru_dict(self) -> Optional[Dict[bytes, Row]]:
        return self.front.lru_dict()

    def close(self) -> None:
        self.front.close()
        try:
            self.back.close()
        except Exception as exc:
            self._back_error("close", exc)
