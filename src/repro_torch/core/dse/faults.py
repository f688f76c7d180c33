"""Deterministic, seedable fault injection for the DSE stack.

Port of ``repro/core/dse/faults.py``.  The schedule is the reference's
bit for bit (a fire decision depends only on ``(seed, site, n)``).  The
service fires ``tcp_drop`` (``serve/dse_service.py``) and the cluster's
coordinator ``worker_kill``, ``heartbeat_drop`` and ``shard_timeout``
(``serve/cluster.py``).

Chaos testing a bitwise-deterministic system needs bitwise-deterministic
faults: a failure schedule that depends on wall clock or a shared global
RNG makes every red run unreproducible.  ``FaultInjector`` therefore
derives each fire/no-fire decision purely from ``(seed, site, n)`` where
``n`` is that site's own call counter — replaying the same operations in
the same order replays the same faults, regardless of what other sites
did in between.

Sites (one counter each):

* ``store_get`` / ``store_put`` — the persistent back tier erroring on
  read/write (exercises ``TieredStore``'s LRU-only degradation);
* ``sqlite_lock`` — ``sqlite3.OperationalError: database is locked``
  (exercises ``SqliteStore``'s bounded-backoff retry);
* ``tcp_drop`` — the service aborts a client connection mid-protocol
  (exercises ``DSEClient``'s reconnect/backoff/idempotent-retry path);
* ``engine_exc`` — ``EvalEngine._simulate`` raises (exercises the
  service failing one batch without killing the batcher loop);
* ``nan_metrics`` — ``_simulate`` returns a NaN row (exercises the
  engine's non-finite guard);
* ``worker_kill`` — a ``DSECluster`` shard dispatch kills its target
  worker outright (the service stops, no drain) before the call lands
  (exercises ejection + shard failover onto survivors);
* ``heartbeat_drop`` — a cluster ``heartbeat()`` probe fails
  (exercises consecutive-failure ejection and backoff-gated rejoin);
* ``shard_timeout`` — a cluster shard dispatch is declared lost on its
  first attempt (exercises the retry-on-surviving-workers path without
  waiting out a real timeout).

The three cluster sites are consulted only from single-threaded call
sites (the coordinator's shard-assignment loop and the heartbeat
prober), so their counters advance deterministically even though shard
execution itself is concurrent.

Faults can be scheduled two ways, combinable per site:

* ``rates={"store_put": 0.2}`` — fire pseudorandomly at that marginal
  rate (sha256 of (seed, site, n) mapped to [0, 1));
* ``at={"tcp_drop": (0, 5)}`` — fire exactly at those call indices.

Injected faults raise ``InjectedFault`` subclasses carrying
``retryable = True`` so the resilience layers under test can make the
same retry decision they would for the real error.  Chaos tests use
fault classes that never corrupt values (fail-then-retry, never
wrong-data), which is why tenant results under faults are asserted
*bitwise equal* to clean runs (tests/test_torch_stores.py).
"""
from __future__ import annotations

import hashlib
import os
import sqlite3
import threading
from typing import Dict, Iterable, Optional

import numpy as np

from .store import ResultStore, Row

__all__ = ["FAULT_SITES", "InjectedFault", "InjectedStoreError",
           "InjectedEngineError", "FaultInjector", "FaultyStore",
           "inject_engine_faults", "fault_seed_from_env"]

FAULT_SITES = ("store_get", "store_put", "sqlite_lock", "tcp_drop",
               "engine_exc", "nan_metrics", "worker_kill",
               "heartbeat_drop", "shard_timeout")


class InjectedFault(RuntimeError):
    """Base class for injector-raised errors.  ``retryable`` mirrors the
    contract real transient errors carry through the service wire."""

    retryable = True


class InjectedStoreError(InjectedFault):
    pass


class InjectedEngineError(InjectedFault):
    pass


def fault_seed_from_env(default: int = 0) -> int:
    """The chaos suite's seed: ``FAULT_SEED`` env var (CI matrixes over
    it) or ``default``."""
    return int(os.environ.get("FAULT_SEED", default))


def _u01(seed: int, site: str, n: int) -> float:
    h = hashlib.sha256(f"{seed}:{site}:{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


class FaultInjector:
    """Deterministic per-site fault schedule (see module docstring).

    Thread-safe: counters advance under a lock, and the decision for
    call ``n`` of a site depends only on ``(seed, site, n)``.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 at: Optional[Dict[str, Iterable[int]]] = None):
        for site in list(rates or ()) + list(at or ()):
            if site not in FAULT_SITES:
                raise ValueError(f"unknown fault site {site!r}; "
                                 f"known: {FAULT_SITES}")
        self.seed = int(seed)
        self.rates = {k: float(v) for k, v in (rates or {}).items()}
        self.at = {k: frozenset(int(i) for i in v)
                   for k, v in (at or {}).items()}
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {s: 0 for s in FAULT_SITES}
        self._fired: Dict[str, int] = {s: 0 for s in FAULT_SITES}

    def should_fire(self, site: str) -> bool:
        """Advance ``site``'s counter and decide (deterministically)
        whether this call faults."""
        with self._lock:
            n = self._calls[site]
            self._calls[site] = n + 1
            fire = n in self.at.get(site, ())
            rate = self.rates.get(site, 0.0)
            if not fire and rate > 0.0:
                fire = _u01(self.seed, site, n) < rate
            if fire:
                self._fired[site] += 1
            return fire

    def calls(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._calls)

    def fired(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._fired)


class FaultyStore(ResultStore):
    """Delegating ``ResultStore`` wrapper that raises per the injector.

    ``store_get``/``store_put`` raise ``InjectedStoreError``;
    ``sqlite_lock`` raises the real ``sqlite3.OperationalError`` text the
    retry/degradation paths match on.  Used as a ``TieredStore`` back
    tier to exercise LRU-only degradation without a real disk failure.
    """

    def __init__(self, inner: ResultStore, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    # stats/locking live in the wrapped store
    @property
    def stats(self):
        return self.inner.stats

    def bind(self, context: bytes) -> "ResultStore":
        self.inner.bind(context)
        return self

    def _maybe_lock(self) -> None:
        if self.injector.should_fire("sqlite_lock"):
            raise sqlite3.OperationalError("database is locked")

    def get(self, key: bytes) -> Optional[Row]:
        self._maybe_lock()
        if self.injector.should_fire("store_get"):
            raise InjectedStoreError("injected store read failure")
        return self.inner.get(key)

    def put(self, key: bytes, row: Row) -> None:
        self._maybe_lock()
        if self.injector.should_fire("store_put"):
            raise InjectedStoreError("injected store write failure")
        self.inner.put(key, row)

    def peek(self, key: bytes) -> bool:
        return self.inner.peek(key)

    def __len__(self) -> int:
        return len(self.inner)

    def lru_dict(self):
        return self.inner.lru_dict()

    def close(self) -> None:
        self.inner.close()


def inject_engine_faults(engine, injector: FaultInjector):
    """Wrap ``engine._simulate`` so ``engine_exc`` raises an
    ``InjectedEngineError`` and ``nan_metrics`` poisons one latency cell
    with NaN (which the engine's non-finite guard must catch before the
    row reaches any memo/store).  Returns the engine; the wrapper only
    shadows the bound method on this instance and keeps the port's
    ``_simulate(cfgs, genomes, mode, oracle, exact)`` signature."""
    inner = engine._simulate

    def _simulate(cfgs, genomes, mode, oracle=None, exact=False):
        if injector.should_fire("engine_exc"):
            raise InjectedEngineError("injected engine failure")
        lat, en, tw = inner(cfgs, genomes, mode, oracle=oracle, exact=exact)
        if injector.should_fire("nan_metrics"):
            lat = np.array(lat, np.float64, copy=True)
            lat[0, 0] = np.nan
        return lat, en, tw

    engine._simulate = _simulate
    return engine
