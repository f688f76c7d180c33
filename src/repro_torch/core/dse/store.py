"""Result stores for the DSE evaluation engine.

Port of the in-process half of ``repro/core/dse/store.py``: the
``ResultStore`` interface and ``MemoryLRUStore``, the engine's default
bounded LRU memo.  The persistent ``SqliteStore`` and ``TieredStore`` are
not ported yet.

The engine hands stores short keys -- ``b"<mode>:" + canonical genome
bytes`` -- plus, once at construction, a binding context digest
(``api.context_digest``).  Values are ``(lat, en, tw)`` triples of
float64 ``(W,)`` arrays.  ``put`` is put-if-absent: metrics for one key
are immutable.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["StoreStats", "ResultStore", "MemoryLRUStore"]

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
