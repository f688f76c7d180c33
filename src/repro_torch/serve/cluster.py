"""Fault-tolerant DSE worker cluster: sharded evaluation across
replicated services with failover, hedging, and bit-for-bit recovery.

Port of ``repro/serve/cluster.py``.  One ``DSEService`` is both the
throughput ceiling and a single point of failure for a §4-scale study.
``DSECluster`` is a coordinator over N workers (in-process ``DSEService``
handles or TCP addresses) that speaks the same ``core/dse/api.Evaluator``
surface the engine and ``DSEClient`` do, so the sweep, the GA, BO,
hillclimb and ``run_pipeline(cluster=...)`` run against it unchanged:

* **Sharding** -- each evaluate micro-batch is partitioned per genome by
  rendezvous-hashing the canonical genome key (``mode:canonical-bytes``,
  the engine's own store key) over the live worker set.  The
  highest-scoring worker owns the key, so repeated genomes land on the
  same worker across calls and across coordinators: per-worker store
  locality survives membership churn (only a lost worker's keys move).
* **Health** -- ``heartbeat()`` probes every worker's ``health()``;
  ``eject_after`` *consecutive* failures (probes or shard dispatches)
  eject a worker from the shard ranking, and a backoff-gated rejoin
  re-probes it after ``rejoin_backoff_s`` (doubling per ejection).  A
  background prober (``start_heartbeats``) is optional -- dispatch
  failures feed the same counters.
* **Recovery** -- a failed or timed-out shard retries on the next
  surviving worker in its rendezvous ranking with exponential backoff;
  ``hedge_after_s`` optionally re-dispatches a straggling shard to the
  runner-up worker, first result wins.  Identical in-flight shards are
  merged onto one future coordinator-side.  Evaluation is
  content-addressed, so a hedge or a retry that lands twice is a store
  hit, and every recovery path returns the bytes of an unfaulted
  single-engine run (``-m chaos`` tests/test_torch_cluster.py).

All workers must serve one engine context, and the port's context
includes the device type: a cluster mixing a CPU worker and a card
worker is refused at construction.  On one card every in-process
worker's engine sits on ``cuda:0`` and drives it from its own dispatch
thread; the cluster has no ``device``, so a GA driven through it runs
its genetics where the caller's ``device=`` says.

Chaos sites (``core/dse/faults.py``): ``worker_kill`` stops a shard's
target service before the dispatch lands, ``heartbeat_drop`` fails a
probe, ``shard_timeout`` declares a shard lost on its first attempt.
All three are consulted only from single-threaded coordinator code so
their deterministic schedules replay exactly.

Set ``CLUSTER_LOG_DIR`` to make the coordinator append a line per
membership/recovery event to ``<dir>/cluster-<pid>-<id>.log``.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..core.dse.api import META_VERSION
from ..core.dse.encoding import GENOME_LEN
from ..core.dse.engine import EngineStats, canonical_genomes, genome_areas
from .dse_service import DSEClient, DSEService, _Backoff

__all__ = ["DSECluster", "ClusterStats", "ClusterError", "ShardTimeoutError"]


class ShardTimeoutError(TimeoutError):
    """A shard dispatch exceeded its attempt timeout (or an injected
    ``shard_timeout`` declared it lost).  Retryable: the cluster re-runs
    the shard on the next surviving worker -- duplicate completions are
    free through the content-addressed store."""

    retryable = True


class ClusterError(ConnectionError):
    """No worker could complete a shard within the retry budget.  Not
    retryable at this layer -- the cluster already exhausted its
    failover attempts across the membership."""

    retryable = False


@dataclasses.dataclass
class ClusterStats:
    """Coordinator-side lifetime counters."""

    requests: int = 0            # evaluate() calls
    shards: int = 0              # shards formed (one per worker per call)
    dispatches: int = 0          # shard dispatch attempts (incl. retries)
    retried_shards: int = 0      # failover re-dispatches after a failure
    hedged_shards: int = 0       # straggler duplicates launched
    hedge_wins: int = 0          # hedges that finished first
    inflight_merged: int = 0     # shards merged onto an in-flight future
    worker_failures: int = 0     # failed probes + failed dispatches
    ejections: int = 0
    rejoins: int = 0
    heartbeats: int = 0

    def snapshot(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class _Worker:
    """One cluster member: client handle + health state.  ``salt`` is
    the stable rendezvous identity (index-based, so the ranking of every
    key is deterministic for a given worker-list order)."""

    def __init__(self, index: int, service: Optional[DSEService],
                 address: Optional[tuple], calib: CalibrationTable):
        self.index = index
        self.service = service
        self.address = address
        self.calib = calib
        self.salt = f"worker-{index}".encode()
        self.name = (f"w{index}" if address is None
                     else f"w{index}@{address[0]}:{address[1]}")
        self.client: Optional[DSEClient] = None
        self.failures = 0            # consecutive
        self.ejected = False
        self.ejections = 0
        self.ejected_until = 0.0     # monotonic
        self.dead = False            # killed for good (service stopped)
        self.lock = threading.Lock()
        self.connect()

    def connect(self) -> DSEClient:
        if self.client is None:
            # the cluster owns failover, so the per-worker client fails
            # fast (one quick retry smooths a transient TCP hiccup)
            if self.service is not None:
                self.client = DSEClient(service=self.service, retries=1,
                                        backoff_s=0.02)
            else:
                self.client = DSEClient(address=self.address,
                                        calib=self.calib, retries=1,
                                        backoff_s=0.02)
        return self.client

    def drop_client(self) -> None:
        cl, self.client = self.client, None
        if cl is not None:
            try:
                cl.close()
            except Exception:   # noqa: BLE001 - peer already gone
                pass

    def usable(self, now: float) -> bool:
        if self.dead:
            return False
        if self.ejected:
            return now >= self.ejected_until    # rejoin candidate
        return True


@dataclasses.dataclass
class _Shard:
    """One per-worker slice of an evaluate call."""

    sel: np.ndarray              # row indices into the caller's batch
    canon: np.ndarray            # (n, GENOME_LEN) canonical genomes
    mode: str
    rank: List[int]              # rendezvous ranking (worker indices)
    digest: bytes                # content key for in-flight dedup
    inject_timeout: bool = False


class DSECluster:
    """Shard-scheduling coordinator over N ``DSEService`` workers (see
    module docstring).  Satisfies the ``Evaluator`` protocol and the
    engine duck-type the search frontends score through.

    ``workers`` mixes in-process ``DSEService`` handles and TCP
    ``(host, port)`` addresses freely.  All workers must serve the same
    engine context (workloads/calibration/backend/fidelity/device-type
    digest) -- a mixed membership is refused at construction, the same
    way a ``DSEClient`` refuses a context-changing reconnect.
    """

    def __init__(self, workers: Sequence, *,
                 calib: CalibrationTable = DEFAULT_CALIB,
                 shard_retries: int = 4, backoff_s: float = 0.05,
                 backoff_max_s: float = 2.0, eject_after: int = 3,
                 rejoin_backoff_s: float = 1.0,
                 rejoin_backoff_max_s: float = 30.0,
                 shard_timeout_s: Optional[float] = None,
                 hedge_after_s: Optional[float] = None,
                 fault_injector=None):
        if not workers:
            raise ValueError("DSECluster needs at least one worker")
        self.shard_retries = max(int(shard_retries), 0)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.eject_after = max(int(eject_after), 1)
        self.rejoin_backoff_s = float(rejoin_backoff_s)
        self.rejoin_backoff_max_s = float(rejoin_backoff_max_s)
        self.shard_timeout_s = shard_timeout_s
        self.hedge_after_s = hedge_after_s
        self._faults = fault_injector
        self.calib = calib
        self._workers: List[_Worker] = []
        for spec in workers:
            i = len(self._workers)
            if isinstance(spec, DSEService):
                self._workers.append(_Worker(i, spec, None, calib))
            else:
                host, port = spec
                self._workers.append(_Worker(i, None, (str(host), int(port)),
                                             calib))
        # membership handshake: one engine context across the cluster
        first = self._workers[0].client
        self.workloads = list(first.workloads)
        self.backend = first.backend
        self.mode = first.mode
        self.fidelity = first.fidelity
        self.calib = first.calib
        self._context = first.context_key()
        for w in self._workers[1:]:
            if w.client.context_key() != self._context:
                raise ValueError(
                    f"worker {w.name} serves a different engine context "
                    "(workloads, calibration, backend class, fidelity or "
                    "device type) -- refusing to mix incompatible metrics "
                    "in one cluster")
        self.memoize = True
        self.stats = EngineStats(workloads=len(self.workloads))
        self.cluster_stats = ClusterStats()
        self._lock = threading.Lock()          # stats + membership state
        self._inflight: Dict[bytes, concurrent.futures.Future] = {}
        n = len(self._workers)
        self._shard_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(4, n + 2), thread_name_prefix="cluster-shard")
        self._attempt_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(8, 3 * n), thread_name_prefix="cluster-attempt")
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._log_path = None
        log_dir = os.environ.get("CLUSTER_LOG_DIR")
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._log_path = os.path.join(
                log_dir, f"cluster-{os.getpid()}-{id(self):x}.log")
        self._log(f"cluster up: {n} workers "
                  f"({', '.join(w.name for w in self._workers)})")

    # ------------------------------------------------------------- logging
    def _log(self, msg: str) -> None:
        if self._log_path is None:
            return
        try:
            with open(self._log_path, "a") as f:
                f.write(f"{time.monotonic():.3f} {msg}\n")
        except OSError:
            pass

    # ---------------------------------------------------------- membership
    def _rank(self, key: bytes) -> List[int]:
        """Rendezvous (highest-random-weight) ranking of every worker
        for one key: each worker scores sha256(salt + key); descending
        score order.  Stable per key, minimally disturbed by membership
        changes -- only a lost worker's keys move."""
        scored = sorted(
            ((hashlib.sha256(w.salt + key).digest(), w.index)
             for w in self._workers), reverse=True)
        return [i for _, i in scored]

    def _pick(self, rank: Sequence[int],
              exclude: Sequence[int] = ()) -> Optional[_Worker]:
        now = time.monotonic()
        for i in rank:
            w = self._workers[i]
            if i not in exclude and w.usable(now):
                return w
        return None

    def _worker_ok(self, w: _Worker) -> None:
        with self._lock:
            w.failures = 0
            if w.ejected:
                w.ejected = False
                self.cluster_stats.rejoins += 1
                self._log(f"{w.name} rejoined after backoff")

    def _worker_failed(self, w: _Worker, exc: BaseException) -> None:
        with self._lock:
            self.cluster_stats.worker_failures += 1
            w.failures += 1
            if w.address is not None:
                w.drop_client()     # force a clean reconnect next attempt
            if not w.ejected and (w.failures >= self.eject_after or w.dead):
                w.ejected = True
                backoff = min(self.rejoin_backoff_s * 2 ** w.ejections,
                              self.rejoin_backoff_max_s)
                w.ejected_until = time.monotonic() + backoff
                w.ejections += 1
                self.cluster_stats.ejections += 1
                self._log(f"{w.name} ejected after {w.failures} consecutive "
                          f"failures ({exc!r}); rejoin probe in "
                          f"{backoff:.2f}s")

    def _kill_worker(self, w: _Worker) -> None:
        """The ``worker_kill`` chaos site: stop the target service for
        real (no drain) so every in-flight and future dispatch to it
        fails the way a crashed process would."""
        self._log(f"chaos: killing {w.name}")
        w.dead = True
        if w.service is not None:
            w.service.stop(drain=False)
        w.drop_client()

    def heartbeat(self) -> Dict[str, Any]:
        """Probe every non-dead worker's ``health()`` once; success
        resets its failure count (and rejoins it if its ejection backoff
        elapsed), failure counts toward ejection.  Returns
        ``membership()``.  Deterministic for the chaos schedules: probes
        run sequentially in worker order."""
        now = time.monotonic()
        for w in self._workers:
            if w.dead or (w.ejected and now < w.ejected_until):
                continue
            with self._lock:
                self.cluster_stats.heartbeats += 1
            try:
                if self._faults is not None and \
                        self._faults.should_fire("heartbeat_drop"):
                    raise ConnectionError(
                        f"injected heartbeat drop for {w.name}")
                h = w.connect().health()
                if h.get("status") not in ("ok", "stopping"):
                    raise ConnectionError(f"{w.name} health: {h}")
                self._worker_ok(w)
            except Exception as exc:    # noqa: BLE001 - health is a probe
                self._worker_failed(w, exc)
        return self.membership()

    def membership(self) -> List[Dict[str, Any]]:
        """Per-worker status snapshot (name, live/ejected/dead,
        consecutive failures, ejection count)."""
        now = time.monotonic()
        out = []
        for w in self._workers:
            status = ("dead" if w.dead else
                      "ejected" if w.ejected and now < w.ejected_until else
                      "rejoining" if w.ejected else "ok")
            out.append({"name": w.name, "status": status,
                        "failures": w.failures, "ejections": w.ejections})
        return out

    def start_heartbeats(self, interval_s: float = 1.0) -> "DSECluster":
        """Run ``heartbeat()`` on a daemon thread every ``interval_s``
        until ``close()``."""
        if self._hb_thread is not None:
            return self

        def _probe():
            while not self._hb_stop.wait(interval_s):
                self.heartbeat()

        self._hb_thread = threading.Thread(target=_probe, daemon=True,
                                           name="cluster-heartbeat")
        self._hb_thread.start()
        return self

    # ------------------------------------------------------------ evaluate
    def _form_shards(self, sel: np.ndarray, canon: np.ndarray,
                     mode: str) -> List[_Shard]:
        """Group the kept rows per rendezvous-owned worker.  Runs in the
        caller's thread in deterministic (worker-index) order -- the only
        place the ``worker_kill``/``shard_timeout`` chaos sites fire, so
        their schedules replay exactly."""
        tag = mode.encode() + b":"
        by_worker: Dict[int, List[int]] = {}
        ranks: Dict[int, List[int]] = {}
        for j, g in enumerate(canon):
            key = tag + np.ascontiguousarray(g, np.int64).tobytes()
            rank = self._rank(key)
            w = self._pick(rank)
            if w is None:
                raise ClusterError("no usable worker in the cluster")
            by_worker.setdefault(w.index, []).append(j)
            ranks.setdefault(w.index, rank)
        shards = []
        for wi in sorted(by_worker):
            rows = np.asarray(by_worker[wi], np.int64)
            sc = np.ascontiguousarray(canon[rows], np.int64)
            digest = hashlib.sha256(
                self._context + tag + sc.tobytes()).digest()
            shard = _Shard(sel=sel[rows], canon=sc, mode=mode,
                           rank=ranks[wi], digest=digest)
            if self._faults is not None:
                if self._faults.should_fire("worker_kill"):
                    self._kill_worker(self._workers[wi])
                if self._faults.should_fire("shard_timeout"):
                    shard.inject_timeout = True
            shards.append(shard)
        with self._lock:
            self.cluster_stats.shards += len(shards)
        return shards

    def _eval_on(self, w: _Worker, shard: _Shard) -> Tuple[np.ndarray, ...]:
        with self._lock:
            self.cluster_stats.dispatches += 1
        res = w.connect().evaluate_shard(shard.canon, mode=shard.mode)
        return res["latency"], res["energy"], res["tops_w"]

    def _submit(self, w: _Worker, shard: _Shard, dedup: bool
                ) -> concurrent.futures.Future:
        """Submit one attempt; identical first-attempt shards (hedges
        from another tenant, a concurrent evaluate of the same rows)
        merge onto the in-flight future."""
        if not dedup:
            return self._attempt_pool.submit(self._eval_on, w, shard)
        with self._lock:
            fut = self._inflight.get(shard.digest)
            if fut is not None:
                self.cluster_stats.inflight_merged += 1
                return fut
            fut = self._attempt_pool.submit(self._eval_on, w, shard)
            self._inflight[shard.digest] = fut

        def _clear(f, key=shard.digest):
            with self._lock:
                if self._inflight.get(key) is f:
                    del self._inflight[key]

        fut.add_done_callback(_clear)
        return fut

    def _attempt(self, w: _Worker, shard: _Shard, dedup: bool):
        """One (possibly hedged) attempt on one worker; raises on
        failure or attempt timeout."""
        fut = self._submit(w, shard, dedup)
        timeout = self.shard_timeout_s
        if self.hedge_after_s is not None:
            done, _ = concurrent.futures.wait({fut},
                                              timeout=self.hedge_after_s)
            if not done:
                h = self._pick(shard.rank, exclude=(w.index,))
                if h is not None:
                    with self._lock:
                        self.cluster_stats.hedged_shards += 1
                    self._log(f"hedging straggler shard "
                              f"({len(shard.sel)} rows) from {w.name} "
                              f"to {h.name}")
                    hedge = self._attempt_pool.submit(self._eval_on, h,
                                                      shard)
                    remaining = None if timeout is None else \
                        max(timeout - self.hedge_after_s, 0.01)
                    done, _ = concurrent.futures.wait(
                        {fut, hedge}, timeout=remaining,
                        return_when=concurrent.futures.FIRST_COMPLETED)
                    for f in done:       # first success wins
                        if f.exception() is None:
                            if f is hedge:
                                with self._lock:
                                    self.cluster_stats.hedge_wins += 1
                            return f.result()
                    pending = {fut, hedge} - done
                    if pending:
                        return next(iter(pending)).result(timeout=remaining)
                    raise next(iter(done)).exception()
        try:
            return fut.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            raise ShardTimeoutError(
                f"shard ({len(shard.sel)} rows) on {w.name} exceeded "
                f"{timeout}s") from None

    def _run_shard(self, shard: _Shard) -> Tuple[np.ndarray, ...]:
        """Dispatch one shard with failover: primary owner first, then
        the surviving workers in rendezvous order, exponential backoff
        between attempts.  Every failure feeds the ejection counters."""
        tries = _Backoff(self.backoff_s, self.backoff_max_s)
        tried: List[int] = []
        for attempt in range(self.shard_retries + 1):
            w = self._pick(shard.rank, exclude=tried)
            if w is None:
                tried = []          # everyone failed once: start over
                w = self._pick(shard.rank)
            if w is None:
                break               # whole membership dead/ejected
            if attempt:
                with self._lock:
                    self.cluster_stats.retried_shards += 1
                self._log(f"retrying shard ({len(shard.sel)} rows) on "
                          f"{w.name} (attempt {attempt + 1})")
                tries.pause()
            try:
                if shard.inject_timeout and attempt == 0:
                    raise ShardTimeoutError(
                        f"injected shard timeout on {w.name}")
                rows = self._attempt(w, shard, dedup=attempt == 0)
                self._worker_ok(w)
                return rows
            except Exception as exc:    # noqa: BLE001 - failover
                self._worker_failed(w, exc)
                tried.append(w.index)
                tries.last = exc
        raise ClusterError(
            f"shard ({len(shard.sel)} rows) failed on every usable worker "
            f"after {self.shard_retries + 1} attempts") from tries.last

    def evaluate(self, genomes: np.ndarray, keep=None,
                 mode: Optional[str] = None,
                 canonical: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Sharded ``EvalEngine.evaluate``: same output contract, same
        client-side ``keep`` prefilter semantics as ``DSEClient``
        (skipped genomes never travel), plus cluster ``meta`` (shards,
        failovers, hedges)."""
        t0 = time.perf_counter()
        genomes = np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN)
        mode = self.mode if mode is None else mode
        n, W = len(genomes), len(self.workloads)
        area = genome_areas(genomes, self.calib)
        keep_mask = np.ones(n, bool) if keep is None else \
            np.asarray(keep(area), bool)
        lat = np.zeros((n, W))
        en = np.zeros((n, W))
        tw = np.zeros((n, W))
        skip = np.flatnonzero(~keep_mask)
        lat[skip] = np.inf
        en[skip] = np.inf
        sel = np.flatnonzero(keep_mask)
        with self._lock:
            self.stats.requests += n
            self.stats.skips += len(skip)
            self.cluster_stats.requests += 1
        st0 = self.cluster_stats.snapshot()
        shards: List[_Shard] = []
        if len(sel):
            canon = canonical_genomes(genomes[sel]) if canonical is None \
                else np.asarray(canonical,
                                np.int64).reshape(-1, GENOME_LEN)[sel]
            shards = self._form_shards(sel, canon, mode)
            futs = [self._shard_pool.submit(self._run_shard, s)
                    for s in shards]
            for shard, fut in zip(shards, futs):
                slat, sen, stw = fut.result()
                lat[shard.sel] = slat
                en[shard.sel] = sen
                tw[shard.sel] = stw
        st1 = self.cluster_stats.snapshot()
        with self._lock:
            self.stats.misses += len(sel)
            self.stats.eval_seconds += time.perf_counter() - t0
        meta = {"meta_version": META_VERSION, "backend": self.backend,
                "fidelity": self.fidelity, "mode": mode, "requests": n,
                "skips": len(skip), "hits": 0, "misses": len(sel),
                "hit_rate": 0.0,
                "shards": len(shards),
                "workers": sum(1 for m in self.membership()
                               if m["status"] == "ok"),
                "retried_shards": st1["retried_shards"]
                - st0["retried_shards"],
                "hedged_shards": st1["hedged_shards"]
                - st0["hedged_shards"]}
        return {"latency": lat, "energy": en, "tops_w": tw, "area": area,
                "meta": meta}

    # ------------------------------------------------------ engine surface
    def check_workloads(self, workloads: Sequence[str],
                        calib: Optional[CalibrationTable] = None
                        ) -> "DSECluster":
        if list(workloads) != self.workloads:
            raise ValueError(
                f"cluster workloads {self.workloads} != caller workloads "
                f"{list(workloads)}")
        if calib is not None and calib != self.calib:
            raise ValueError("caller calib differs from the cluster "
                             "engines' calib -- results would not match")
        return self

    def areas(self, genomes: np.ndarray) -> np.ndarray:
        genomes = np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN)
        return genome_areas(genomes, self.calib)

    def context_key(self) -> bytes:
        """The shared engine-context digest every worker was verified
        against at construction."""
        return self._context

    def score_batch(self, genomes: np.ndarray,
                    mode: Optional[str] = None) -> Dict[str, Any]:
        res = self.evaluate(genomes, mode=mode)
        return {k: res[k] for k in ("latency", "energy", "tops_w", "area")}

    def rescore(self, genomes: np.ndarray, oracle: bool = False,
                mode: Optional[str] = None) -> Dict[str, Any]:
        """Exact rescore on one worker (rendezvous-picked by batch
        content), with the same failover the shards get."""
        genomes = np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN)
        key = b"rescore:" + np.ascontiguousarray(genomes).tobytes()
        rank = self._rank(hashlib.sha256(key).digest())
        tries = _Backoff(self.backoff_s, self.backoff_max_s)
        tried: List[int] = []
        for attempt in range(self.shard_retries + 1):
            w = self._pick(rank, exclude=tried)
            if w is None:
                break
            if attempt:
                tries.pause()
            try:
                res = w.connect().rescore(genomes, oracle=oracle, mode=mode)
                self._worker_ok(w)
                return res
            except Exception as exc:    # noqa: BLE001 - failover
                self._worker_failed(w, exc)
                tried.append(w.index)
                tries.last = exc
        raise ClusterError("rescore failed on every usable worker") \
            from tries.last

    def reserve_shapes(self, max_batch: int = 64) -> None:
        for w in self._workers:
            if w.usable(time.monotonic()):
                try:
                    w.connect().reserve_shapes(max_batch)
                except Exception:   # noqa: BLE001 - best-effort prewarm
                    pass

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Stop the heartbeat prober and close every client.  Does NOT
        stop the workers -- the cluster is a tenant of the services, not
        their owner."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
        for w in self._workers:
            w.drop_client()
        self._shard_pool.shutdown(wait=False)
        self._attempt_pool.shutdown(wait=False)
        self._log("cluster closed")
