"""DSE-as-a-service: a coalescing async evaluation front over the engine.

Port of ``repro/serve/dse_service.py``.  MOSAIC's §4 pipeline (stratified
sweep -> per-seed GA -> Pareto merge) means thousands of candidate
evaluations per study, re-run by every user and every CI job.  The
engine's exact search already scores an arbitrary candidate batch on
every workload in one dispatch, so scoring candidates from *different*
requests in the same dispatch is nearly free.  This module turns the
per-process ``EvalEngine`` into traffic-serving infrastructure:

``DSEService``
    An asyncio front over one engine.  ``evaluate`` requests break into
    per-genome items on a queue; a continuous-batching loop collects
    items across requests into micro-batches -- up to ``max_batch``
    genomes or ``max_wait_ms`` of admission window, whichever first --
    and drives them through ``EvalEngine.evaluate`` on a single-thread
    dispatch executor.  While a batch simulates, new arrivals keep
    queueing, so concurrent tenants share fused dispatches.  Identical
    in-flight candidates are merged onto one future (on top of the
    engine's store, which already dedups completed ones).  ``search``
    runs a whole GA server-side through the same coalescing queue,
    streaming cumulative Pareto-front updates as generations complete;
    ``pipeline`` streams the fused §4 study stage by stage.

``DSEClient``
    A thin client with the engine's scoring surface (``check_workloads``
    / ``evaluate`` / ``areas`` / ``rescore`` / ``score_batch`` /
    ``reserve_shapes`` / ``stats``), bound either in-process to a
    ``DSEService`` or over TCP (JSON lines; see ``DSEService.listen``).
    Python's JSON floats round-trip float64 bit for bit, so served
    metrics equal a local engine's on the same device byte for byte,
    across the wire too (tests/test_torch_service.py).  The ``keep``
    area prefilter runs client-side (areas are a host function of the
    genome), so skipped genomes are never memoized, as in the engine.

What the port changes, and why:

* Every engine call runs on the service's one dispatch thread --
  coalesced batches, ``rescore`` (the reference runs it on its search
  pool), an in-process client's ``score_batch``, and the ``pipeline``
  op.  The port's ``EvalEngine`` holds no lock around its memo, its
  stats or its row loops; evaluation is content-addressed, so
  serializing changes no result.  The asyncio loop thread touches host
  numpy only, never a device tensor.
* ``search`` runs the GA's genetics on the service engine's device
  (``run_ga(device=engine.device)``): a client has no ``device``.
* The engine context digest includes the framework and the device type
  (``api.context_digest``), so the ``hello`` reply carries one field the
  reference's does not, ``device`` (the engine's device type), from
  which the client recomputes the digest.  A client or a cluster refuses
  a server whose engine runs on another device type.
* Replies are serialized with a ``default`` that turns numpy scalars
  into Python numbers and refuses anything else (a torch tensor would
  otherwise lose bits silently).

The service degrades, it does not die: admission is bounded (a full
queue rejects with a *retryable* ``OverloadedError``), ``evaluate`` takes
a per-request ``deadline_s`` (the wait is bounded; the shared work keeps
running), the batcher loop survives any per-batch failure, and
``stop()`` drains gracefully, fails whatever remains with
``ConnectionError`` and is idempotent.  The client reconnects and retries
single-reply calls with exponential backoff + jitter under idempotent
request ids -- safe because evaluation is content-addressed.

``python -m repro_torch.serve.dse_service --smoke [--device cpu]`` runs
the service check (two concurrent GA tenants bit for bit local exact
runs while sharing fused dispatches; the served pipeline bit for bit a
local ``run_pipeline``; a warm sqlite store above 50 % hits).
``--serve HOST:PORT`` runs a standalone TCP server.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import functools
import itertools
import json
import random
import shutil
import socket
import tempfile
import threading
import time
import warnings
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..core.calibrate.asap7 import CalibrationTable, DEFAULT_CALIB
from ..core.dse.api import META_VERSION, EngineConfig, context_digest
from ..core.dse.encoding import GENOME_LEN
from ..core.dse.engine import (EngineStats, EvalEngine, canonical_genomes,
                               genome_areas)
from ..core.dse.pareto import pareto_mask
from ..core.simulator.costs import COST_MODEL_VERSION
from ..core.simulator.orchestrator import SCHEDULE_MODES

__all__ = ["DSEService", "DSEClient", "ServiceStats", "OverloadedError",
           "DeadlineExceededError"]


class OverloadedError(RuntimeError):
    """The admission queue is full: the request was rejected before any
    of its genomes enqueued (no side effects).  Retryable -- back off and
    resubmit; ``DSEClient`` does so automatically."""

    retryable = True


class DeadlineExceededError(TimeoutError):
    """``deadline_s`` elapsed before every requested row resolved.  The
    underlying evaluations keep running (their futures are shared with
    other tenants and the store memoizes their results), so a retry of
    the same request is cheap -- but NOT automatic: the deadline is the
    caller's own budget."""

    retryable = False


class _Backoff:
    """Exponential backoff between the attempts of one retried request
    (the client's, and the cluster's shard and rescore failover).
    ``pause()`` sleeps ``backoff_s``, doubling on every pause up to
    ``backoff_max_s``, plus up to half as much again with ``jitter``.
    With ``deadline`` (a ``time.monotonic()`` instant) a pause that
    would pass it raises ``DeadlineExceededError`` instead, chained to
    ``last``, the failure that called for the retry."""

    def __init__(self, backoff_s: float, backoff_max_s: float,
                 deadline: Optional[float] = None, jitter: bool = False):
        self.delay = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.deadline = deadline
        self.jitter = jitter
        self.attempts = 1
        self.last: Optional[BaseException] = None

    def pause(self) -> None:
        sleep_s = self.delay + (random.uniform(0.0, self.delay / 2)
                                if self.jitter else 0.0)
        if self.deadline is not None and \
                self.deadline - time.monotonic() <= sleep_s:
            raise DeadlineExceededError(
                f"request deadline exhausted after {self.attempts} "
                f"attempt(s): the next {sleep_s:.2f}s backoff exceeds the "
                "remaining budget") from self.last
        time.sleep(sleep_s)
        self.delay = min(self.delay * 2, self.backoff_max_s)
        self.attempts += 1


# the longest request line the TCP front reads: asyncio's default (64 KiB)
# is about 500 genomes with their canonical forms, less than one micro-batch
_LINE_LIMIT = 1 << 26


def _wire(obj):
    """``json.dumps`` default for replies: numpy scalars become Python
    numbers; anything else (a torch tensor above all) is refused."""
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f"{type(obj).__name__} is not wire-serializable")


def _dumps(payload) -> bytes:
    return json.dumps(payload, default=_wire).encode() + b"\n"


# =============================================================================
# service-side accounting
# =============================================================================

@dataclasses.dataclass
class ServiceStats:
    """Lifetime counters of one service.  ``batches`` are the coalesced
    micro-batches the continuous-batching loop formed; ``engine_*`` are
    the engine-side outcomes of dispatching them (``engine_dispatches``
    is what the coalescing check compares against the sum of per-client
    local dispatch counts)."""

    requests: int = 0            # evaluate() calls admitted
    request_genomes: int = 0     # genomes across those calls
    store_hits: int = 0          # peek-attributed: present at admission
    inflight_merged: int = 0     # merged onto an already-queued future
    batches: int = 0             # micro-batches formed
    batch_genomes: int = 0       # unique genomes dispatched
    coalesced_batches: int = 0   # batches mixing >= 2 requests
    queue_seconds: float = 0.0   # summed admission->dispatch wait
    engine_hits: int = 0
    engine_misses: int = 0
    engine_dispatches: int = 0   # fused miss-batch dispatches

    def occupancy(self, max_batch: int) -> float:
        return self.batch_genomes / max(self.batches * max_batch, 1)

    def mean_queue_ms(self) -> float:
        return 1e3 * self.queue_seconds / max(self.batch_genomes, 1)

    def snapshot(self, max_batch: Optional[int] = None) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["mean_queue_ms"] = self.mean_queue_ms()
        if max_batch:
            d["batch_occupancy"] = self.occupancy(max_batch)
        return d


@dataclasses.dataclass
class _Pending:
    """One queued genome: resolved by the batch that dispatches it."""
    rid: int
    key: bytes
    genome: np.ndarray           # canonical (GENOME_LEN,) int64 row
    mode: str
    future: asyncio.Future       # -> (lat (W,), en (W,), tw (W,))
    t_enq: float


class _SeedPool:
    """The slice of ``SweepResult`` the GA seeding logic reads, built
    from wire-serializable pieces (seed genomes in rank order + the
    bracket's homogeneous-baseline energies) so a ``search`` request
    doesn't need to ship a whole sweep."""

    def __init__(self, workloads: Sequence[str], genomes: np.ndarray,
                 bracket: float, e_homo: np.ndarray):
        self.workloads = list(workloads)
        self.genomes = np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN)
        self.bracket = np.full(len(self.genomes), float(bracket))
        self._baseline = {float(bracket): np.asarray(e_homo, np.float64)}

    def homo_baseline(self) -> Dict[float, np.ndarray]:
        return self._baseline

    def fitness(self, alpha: float) -> np.ndarray:
        # seed genomes arrive pre-ranked; a constant keeps argsort stable
        return np.zeros(len(self.genomes))


def _ga_result_json(res) -> Optional[Dict[str, Any]]:
    if res is None:
        return None
    return {"bracket": res.bracket,
            "best_genome": np.asarray(res.best_genome).tolist(),
            "best_fitness": res.best_fitness,
            "best_savings_per_wl": np.asarray(
                res.best_savings_per_wl).tolist(),
            "best_metrics": {k: np.asarray(v).tolist()
                             for k, v in res.best_metrics.items()},
            "history": list(res.history),
            "evaluated": res.evaluated}


# =============================================================================
# the service
# =============================================================================

class DSEService:
    """Coalescing evaluation service over one ``EvalEngine``.

    ``max_batch`` caps genomes per coalesced micro-batch; ``max_wait_ms``
    is the admission window after the first arrival.  The dispatch
    executor is single-threaded and runs every engine call, so engine
    work serializes while the event loop keeps admitting.
    """

    def __init__(self, engine: EvalEngine, max_batch: int = 1024,
                 max_wait_ms: float = 10.0, max_queue: int = 100_000,
                 fault_injector=None, worker_id: Optional[str] = None):
        self.engine = engine
        # stable identity for cluster membership (the ``membership`` wire
        # op); defaults to a per-instance tag
        self.worker_id = worker_id or f"dse-{id(self) & 0xffffff:x}"
        self.max_batch = max(int(max_batch), 1)
        self.max_wait = max_wait_ms / 1e3
        self.max_queue = max(int(max_queue), 0)   # 0 = unbounded
        self.stats = ServiceStats()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._queue: Optional[asyncio.Queue] = None
        self._batcher_task = None
        self._server = None
        self._conns: set = set()           # open TCP writers, aborted on stop
        self._inflight: Dict[bytes, asyncio.Future] = {}
        self._req_acct: Dict[int, Dict[str, Any]] = {}
        self._rid = itertools.count()
        self._faults = fault_injector    # dse.faults.FaultInjector or None
        self._stop_lock = threading.Lock()
        self._stopping = False
        self._t_start = time.monotonic()
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dse-dispatch")
        self._searches = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="dse-search")

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "DSEService":
        """Run the service loop on a daemon thread; returns self."""
        if self._loop is not None:
            return self
        self._loop = asyncio.new_event_loop()
        ready = threading.Event()

        def _run():
            asyncio.set_event_loop(self._loop)
            self._queue = asyncio.Queue()
            self._batcher_task = self._loop.create_task(self._batcher())
            ready.set()
            self._loop.run_forever()
            self._loop.close()

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="dse-service")
        self._thread.start()
        ready.wait()
        self._t_start = time.monotonic()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Shut the service down.  Idempotent (concurrent/repeat calls
        are no-ops) and graceful by default: stops admitting (new
        ``evaluate`` calls raise ``ConnectionError``, the TCP listener
        closes), drains the queued + in-flight work for up to
        ``timeout`` seconds, then fails whatever is still pending with
        ``ConnectionError`` -- callers get an exception promptly, never a
        future that hangs forever.  ``drain=False`` skips the wait and
        fails pending work immediately.  A dispatch still running on the
        device is not waited for: its rows land in this engine's own
        store only, and nobody receives them.  Warns if the service
        thread refuses to exit."""
        with self._stop_lock:
            if self._loop is None or self._stopping:
                return
            self._stopping = True
        loop, thread = self._loop, self._thread

        async def _shutdown():
            server, self._server = self._server, None
            if server is not None:
                server.close()       # stop listening; peers abort below
            if drain:
                deadline = loop.time() + timeout
                while ((self._queue.qsize() or self._inflight)
                       and loop.time() < deadline):
                    await asyncio.sleep(0.01)
            self._batcher_task.cancel()
            # whatever survived the drain window fails fast, not forever
            leftover = list(self._inflight.values())
            self._inflight.clear()
            for fut in leftover:
                if not fut.done():
                    fut.set_exception(ConnectionError(
                        "DSE service stopped before this request "
                        "completed"))
            # abort surviving TCP peers: once the loop stops, their
            # handler coroutines would freeze mid-readline and the
            # sockets stay half-open, so the peer blocks out its socket
            # timeout instead of seeing a prompt reset
            for w in list(self._conns):
                try:
                    w.transport.abort()
                except Exception:   # noqa: BLE001 - already closed
                    pass
            self._conns.clear()
            if server is not None:
                # (since Python 3.12 this waits for every connection's
                # handler, which the aborts above end)
                try:
                    await asyncio.wait_for(server.wait_closed(), 5.0)
                except asyncio.TimeoutError:
                    pass
            # let the requests that just failed deliver their errors
            # (their callers wait on them from other threads) before the
            # loop stops; whatever still waits after that is cancelled
            others = [t for t in asyncio.all_tasks()
                      if t is not asyncio.current_task()]
            if others:
                _, pending = await asyncio.wait(others, timeout=1.0)
                for t in pending:
                    t.cancel()

        asyncio.run_coroutine_threadsafe(_shutdown(), loop).result()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        if thread.is_alive():
            warnings.warn(
                "dse-service thread did not exit within 10 s of stop() -- "
                "the daemon thread leaks until process exit",
                RuntimeWarning, stacklevel=2)
        self._executor.shutdown(wait=False)
        self._searches.shutdown(wait=False)
        self._loop = None
        self._thread = None

    close = stop   # the two names must behave identically

    def health(self) -> Dict[str, Any]:
        """Cheap liveness/pressure snapshot (also the ``health``/``ping``
        wire op): status, queue depth vs. bound, in-flight count,
        uptime.  Safe from any thread."""
        if self._loop is None:
            status = "stopped"
        elif self._stopping:
            status = "stopping"
        else:
            status = "ok"
        return {"status": status, "worker_id": self.worker_id,
                "queue_depth": self._queue.qsize() if self._queue else 0,
                "max_queue": self.max_queue,
                "inflight": len(self._inflight),
                "uptime_s": time.monotonic() - self._t_start}

    def listen(self, host: str = "127.0.0.1", port: int = 0):
        """Open the JSON-lines TCP front; returns the bound (host, port)."""
        async def _start():
            self._server = await asyncio.start_server(
                self._handle_conn, host, port, limit=_LINE_LIMIT)
            return self._server.sockets[0].getsockname()[:2]

        return asyncio.run_coroutine_threadsafe(_start(), self._loop).result()

    # ------------------------------------------------------------- evaluate
    async def evaluate(self, genomes: np.ndarray, mode: Optional[str] = None,
                       canonical: Optional[np.ndarray] = None,
                       deadline_s: Optional[float] = None
                       ) -> Dict[str, Any]:
        """Score genomes through the coalescing queue; same output
        contract as ``EvalEngine.evaluate`` (no ``keep`` -- the client
        applies its area prefilter before submitting), with a service
        ``meta``: per-request queue time, batch occupancy, store-hit
        attribution, and in-flight merges.

        Admission is bounded: when the queue already holds ``max_queue``
        items the request is rejected with ``OverloadedError`` (a
        retryable error, raised before anything enqueues).
        ``deadline_s`` bounds the *wait*, not the work: if the rows are
        not all resolved within the budget, ``DeadlineExceededError``
        raises while the shared in-flight futures keep running for other
        tenants (a retry after they finish is a store hit)."""
        eng = self.engine
        mode = eng.mode if mode is None else mode
        if mode not in SCHEDULE_MODES:
            raise ValueError(f"mode {mode!r} not in {SCHEDULE_MODES}")
        if self._stopping or self._loop is None:
            raise ConnectionError("DSE service is stopping")
        genomes = np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN)
        if self.max_queue and \
                self._queue.qsize() + len(genomes) > self.max_queue:
            raise OverloadedError(
                f"admission queue holds {self._queue.qsize()} genomes "
                f"(bound {self.max_queue}); retry after backoff")
        canon = canonical_genomes(genomes) if canonical is None else \
            np.asarray(canonical, np.int64).reshape(-1, GENOME_LEN)
        n = len(genomes)
        tag = mode.encode() + b":"
        keys = [tag + eng._key(g) for g in canon]
        # attribution only (no recency side effects): which of this
        # request's genomes the store could already serve at admission
        store_hits = sum(1 for k in keys if eng.store.peek(k))
        rid = next(self._rid)
        acct = self._req_acct[rid] = {"queue_s": 0.0, "queued": 0,
                                      "occ": 0.0, "batches": set()}
        merged = 0
        futs: List[asyncio.Future] = []
        for k, g in zip(keys, canon):
            fut = self._inflight.get(k)
            if fut is None:
                fut = self._loop.create_future()
                self._inflight[k] = fut
                self._queue.put_nowait(_Pending(
                    rid, k, g, mode, fut, self._loop.time()))
                acct["queued"] += 1
            else:
                merged += 1
            futs.append(fut)
        st = self.stats
        st.requests += 1
        st.request_genomes += n
        st.store_hits += store_hits
        st.inflight_merged += merged
        try:
            if deadline_s is not None and futs:
                done, pending = await asyncio.wait(set(futs),
                                                   timeout=deadline_s)
                if pending:
                    raise DeadlineExceededError(
                        f"{len(pending)} of {len(set(futs))} rows still "
                        f"pending after the {deadline_s} s deadline")
                rows = [f.result() for f in futs]
            else:
                rows = await asyncio.gather(*futs)
        finally:
            acct = self._req_acct.pop(rid)
        W = len(eng.workloads)
        lat = np.stack([r[0] for r in rows]) if rows else np.zeros((0, W))
        en = np.stack([r[1] for r in rows]) if rows else np.zeros((0, W))
        tw = np.stack([r[2] for r in rows]) if rows else np.zeros((0, W))
        n_batches = max(len(acct["batches"]), 1)
        meta = {"meta_version": META_VERSION, "backend": eng.backend,
                "fidelity": eng.fidelity, "mode": mode, "requests": n,
                "store_hits": store_hits,
                "hit_rate": store_hits / max(n, 1),
                "inflight_merged": merged,
                "queue_ms": 1e3 * acct["queue_s"] / max(acct["queued"], 1),
                "batch_occupancy": acct["occ"] / n_batches,
                "batches": len(acct["batches"])}
        # the area evaluate() itself returns (its config stack): the
        # reference's eng.areas() walks decode() below 16 genomes, which
        # can differ from it in the last bit
        area = np.asarray(eng._configs(genomes)["chip"]["chip_area"],
                          np.float64).copy()
        return {"latency": lat, "energy": en, "tops_w": tw, "area": area,
                "meta": meta}

    async def _batcher(self):
        """The continuous-batching loop: block on the first item, admit
        more until the batch fills or the window closes, dispatch, and
        repeat -- arrivals during a dispatch queue up and form the next
        batch, so concurrent tenants coalesce whenever the engine is the
        bottleneck (and within the window when it is not).

        The loop survives any per-batch failure: ``_dispatch`` forwards
        engine exceptions to the batch's callers, and anything that still
        escapes fails that batch's futures while the loop keeps serving
        the next batch -- one tenant's poison never kills the service."""
        while True:
            batch = [await self._queue.get()]
            deadline = self._loop.time() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - self._loop.time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            try:
                await self._dispatch(batch)
            except asyncio.CancelledError:
                raise
            except Exception as exc:    # noqa: BLE001 - fail batch, live on
                for it in batch:
                    self._inflight.pop(it.key, None)
                    if not it.future.done():
                        it.future.set_exception(exc)

    async def _dispatch(self, batch: List[_Pending]):
        st = self.stats
        bid = st.batches
        st.batches += 1
        st.batch_genomes += len(batch)
        occ = len(batch) / self.max_batch
        now = self._loop.time()
        if len({it.rid for it in batch}) > 1:
            st.coalesced_batches += 1
        for it in batch:
            wait = now - it.t_enq
            st.queue_seconds += wait
            acct = self._req_acct.get(it.rid)
            if acct is not None:
                acct["queue_s"] += wait
                if bid not in acct["batches"]:
                    acct["batches"].add(bid)
                    acct["occ"] += occ
        by_mode: Dict[str, List[_Pending]] = {}
        for it in batch:
            by_mode.setdefault(it.mode, []).append(it)
        for mode, items in by_mode.items():
            canon = np.stack([it.genome for it in items])
            # canonical genomes are fixpoints of canonical_genomes, so
            # passing them back as their own canonical forms is exact
            fn = functools.partial(self.engine.evaluate, canon, None, mode,
                                   canon)
            try:
                res = await self._loop.run_in_executor(self._executor, fn)
            except Exception as exc:    # noqa: BLE001 - forwarded to callers
                for it in items:
                    self._inflight.pop(it.key, None)
                    if not it.future.done():
                        it.future.set_exception(exc)
                continue
            m = res["meta"]
            st.engine_hits += m["hits"]
            st.engine_misses += m["misses"]
            st.engine_dispatches += m["dispatches"]
            for r, it in enumerate(items):
                self._inflight.pop(it.key, None)
                if not it.future.done():
                    it.future.set_result((res["latency"][r], res["energy"][r],
                                          res["tops_w"][r]))

    # --------------------------------------------------------------- search
    async def search(self, seed_genomes, bracket: float, e_homo,
                     cfg: Optional[Dict[str, Any]] = None, seed: int = 0,
                     prefilter: bool = True):
        """Run one GA refinement server-side, its scoring flowing through
        the coalescing queue (so concurrent searches and evaluate tenants
        share fused dispatches) and its genetics on the service engine's
        device.  Async generator of events: ``{"event": "generation",
        ...}`` after every generation -- with the *cumulative* Pareto
        front over (mean energy, area, mean latency) of all valid
        candidates seen so far -- then ``{"event": "done", "result":
        <GAResult as JSON>}`` (or ``{"event": "error", ...}``)."""
        from ..core.dse.ga import GAConfig, run_ga
        queue: asyncio.Queue = asyncio.Queue()
        loop = self._loop
        pool = _SeedPool(self.engine.workloads,
                         np.zeros((0, GENOME_LEN), np.int64)
                         if seed_genomes is None else seed_genomes,
                         bracket, e_homo)
        front_pts = np.zeros((0, 3))
        front_genomes = np.zeros((0, GENOME_LEN), np.int64)

        def emit(ev):
            loop.call_soon_threadsafe(queue.put_nowait, ev)

        def on_generation(gen, pop, fit, metrics):
            nonlocal front_pts, front_genomes
            valid = np.isfinite(fit)
            if valid.any():
                pts = np.stack([metrics["energy"][valid].mean(axis=1),
                                metrics["area"][valid],
                                metrics["latency"][valid].mean(axis=1)],
                               axis=1)
                front_pts = np.concatenate([front_pts, pts])
                front_genomes = np.concatenate([front_genomes,
                                                pop[valid].astype(np.int64)])
                mask = pareto_mask(front_pts)
                front_pts = front_pts[mask]
                front_genomes = front_genomes[mask]
            order = np.argsort(front_pts[:, 0])
            emit({"event": "generation", "gen": int(gen),
                  "best_fitness": float(np.max(fit)) if len(fit) else
                  float("-inf"),
                  "front_size": int(len(front_pts)),
                  "front": {"points": front_pts[order].tolist(),
                            "genomes": front_genomes[order].tolist()}})

        def _run_ga():
            client = DSEClient(service=self)
            try:
                res = run_ga(pool, float(bracket), GAConfig(**(cfg or {})),
                             seed=seed, calib=self.engine.calib,
                             engine=client, prefilter=prefilter,
                             on_generation=on_generation,
                             device=self.engine.device)
                emit({"event": "done", "result": _ga_result_json(res),
                      "client_meta": {
                          "requests": client.stats.requests,
                          "hits": client.stats.hits,
                          "skips": client.stats.skips}})
            except Exception as exc:    # noqa: BLE001 - streamed to caller
                emit({"event": "error", "error": repr(exc)})

        worker = loop.run_in_executor(self._searches, _run_ga)
        while True:
            ev = await queue.get()
            yield ev
            if ev["event"] in ("done", "error"):
                break
        await worker

    # ------------------------------------------------------------- pipeline
    async def pipeline(self, seeds: Sequence[int] = (0, 1, 2),
                       brackets: Optional[Sequence[float]] = None,
                       samples_per_stratum: int = 64,
                       cfg: Optional[Dict[str, Any]] = None,
                       islands: Optional[int] = None,
                       migrate_every: int = 5, migrate_k: int = 2):
        """Run the fused §4 multi-seed pipeline (``dse.pipeline
        .run_pipeline``) server-side over the service engine, streaming
        per-stage events as stages complete: the ``run_pipeline``
        ``on_stage`` payloads (sweep / refine / seed_done, with the
        cumulative Pareto front JSON-ified) followed by ``{"event":
        "done", "result": ...}`` carrying the merged front, per-seed
        per-bracket GA results, and stage wall-times.

        The pipeline's refinements run against the device-resident memo
        and never surface per-genome requests, so the whole run executes
        on the dispatch executor: stages serialize with coalesced
        evaluate batches (the engine is shared state), and concurrent
        tenants resume between runs.  Requires the service engine to be
        a local ``backend="exact"`` one; its random draws are the port's
        default ``TorchDraws``.
        """
        from ..core.dse.ga import GAConfig
        from ..core.dse.objective import AREA_BRACKETS
        from ..core.dse.pipeline import run_pipeline
        queue: asyncio.Queue = asyncio.Queue()
        loop = self._loop
        brackets = tuple(AREA_BRACKETS if brackets is None else brackets)

        def emit(ev):
            loop.call_soon_threadsafe(queue.put_nowait, ev)

        def on_stage(ev):
            out = dict(ev)
            out["event"] = "stage"
            front = out.get("front")
            if front is not None:
                out["front"] = {"points": front["points"].tolist(),
                                "genomes": front["genomes"].tolist()}
            emit(out)

        def _run():
            try:
                res = run_pipeline(
                    self.engine.workloads, seeds=tuple(seeds),
                    brackets=brackets,
                    samples_per_stratum=samples_per_stratum,
                    cfg=GAConfig(**(cfg or {})), engine=self.engine,
                    islands=islands, migrate_every=migrate_every,
                    migrate_k=migrate_k, on_stage=on_stage)
                emit({"event": "done", "result": {
                    "workloads": res.workloads, "seeds": res.seeds,
                    "brackets": res.brackets,
                    "front": {"points": res.front_points.tolist(),
                              "genomes": res.front_genomes.tolist()},
                    "results": {str(s): {str(b): _ga_result_json(r)
                                         for b, r in by_b.items()}
                                for s, by_b in res.results.items()},
                    "evaluated": res.evaluated,
                    "stage_seconds": res.stage_seconds}})
            except Exception as exc:    # noqa: BLE001 - streamed to caller
                emit({"event": "error", "error": repr(exc)})

        worker = loop.run_in_executor(self._executor, _run)
        while True:
            ev = await queue.get()
            yield ev
            if ev["event"] in ("done", "error"):
                break
        await worker

    # ------------------------------------------------------------ TCP front
    def _hello(self) -> Dict[str, Any]:
        eng = self.engine
        return {"ok": True, "worker_id": self.worker_id,
                "workloads": eng.workloads, "mode": eng.mode,
                "backend": eng.backend, "fidelity": eng.fidelity,
                "aggressive_int4": eng.aggressive_int4,
                "enable_fusion": eng.enable_fusion,
                "cost_model_version": COST_MODEL_VERSION,
                "device": eng.device.type,
                "context": eng.context_key().hex(),
                "max_batch": self.max_batch,
                "max_wait_ms": self.max_wait * 1e3}

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        def send(payload):
            writer.write(_dumps(payload))

        self._conns.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                if self._faults is not None and \
                        self._faults.should_fire("tcp_drop"):
                    # chaos: drop the peer abruptly (RST, no goodbye) --
                    # the client must reconnect and retry, not hang
                    writer.transport.abort()
                    return
                try:
                    req = json.loads(line)
                    op = req.get("op")
                    if op == "hello":
                        send(self._hello())
                    elif op in ("health", "ping"):
                        send({"ok": True, **self.health()})
                    elif op == "evaluate":
                        g = np.asarray(req["genomes"], np.int64)
                        canon = req.get("canonical")
                        dl = req.get("deadline_s")
                        res = await self.evaluate(
                            g, mode=req.get("mode"),
                            canonical=None if canon is None
                            else np.asarray(canon, np.int64),
                            deadline_s=None if dl is None else float(dl))
                        send({"ok": True, "meta": res["meta"],
                              **{k: res[k].tolist()
                                 for k in ("latency", "energy", "tops_w",
                                           "area")}})
                    elif op == "shard":
                        # cluster shard dispatch: the genomes arrive
                        # already canonical (fixpoints of
                        # canonical_genomes), so they are their own
                        # canonical forms -- no area/keep handling, the
                        # coordinator owns both
                        g = np.asarray(req["genomes"], np.int64)
                        dl = req.get("deadline_s")
                        res = await self.evaluate(
                            g, mode=req.get("mode"), canonical=g,
                            deadline_s=None if dl is None else float(dl))
                        send({"ok": True, "worker_id": self.worker_id,
                              "meta": res["meta"],
                              **{k: res[k].tolist()
                                 for k in ("latency", "energy",
                                           "tops_w")}})
                    elif op == "membership":
                        send({"ok": True, "worker_id": self.worker_id,
                              "context": self.engine.context_key().hex(),
                              **self.health()})
                    elif op == "rescore":
                        g = np.asarray(req["genomes"], np.int64)
                        fn = functools.partial(
                            self.engine.rescore, g,
                            oracle=bool(req.get("oracle", False)),
                            mode=req.get("mode"))
                        res = await self._loop.run_in_executor(
                            self._executor, fn)
                        send({"ok": True, "meta": res["meta"],
                              **{k: res[k].tolist()
                                 for k in ("latency", "energy", "tops_w",
                                           "area")}})
                    elif op == "search":
                        sg = req.get("seed_genomes")
                        agen = self.search(
                            None if sg is None else np.asarray(sg, np.int64),
                            float(req["bracket"]),
                            np.asarray(req["e_homo"], np.float64),
                            cfg=req.get("cfg"), seed=int(req.get("seed", 0)),
                            prefilter=bool(req.get("prefilter", True)))
                        async for ev in agen:
                            send({"ok": True, **ev})
                            await writer.drain()
                        continue
                    elif op == "pipeline":
                        agen = self.pipeline(
                            seeds=tuple(req.get("seeds", (0, 1, 2))),
                            brackets=req.get("brackets"),
                            samples_per_stratum=int(
                                req.get("samples_per_stratum", 64)),
                            cfg=req.get("cfg"),
                            islands=req.get("islands"),
                            migrate_every=int(req.get("migrate_every", 5)),
                            migrate_k=int(req.get("migrate_k", 2)))
                        async for ev in agen:
                            send({"ok": True, **ev})
                            await writer.drain()
                        continue
                    elif op == "reserve_shapes":
                        self.engine.reserve_shapes(int(req.get("max_batch",
                                                               64)))
                        send({"ok": True})
                    elif op == "stats":
                        send({"ok": True,
                              "service": self.stats.snapshot(self.max_batch),
                              "engine": dataclasses.asdict(self.engine.stats),
                              "store": self.engine.store.stats.snapshot(),
                              "store_len": len(self.engine.store)})
                    elif op == "bye":
                        send({"ok": True})
                        break
                    else:
                        send({"ok": False, "error": f"unknown op {op!r}"})
                except Exception as exc:   # noqa: BLE001 - wire error reply
                    send({"ok": False, "error": repr(exc),
                          "error_kind": type(exc).__name__,
                          "retryable": bool(getattr(exc, "retryable",
                                                    False))})
                await writer.drain()
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:   # noqa: BLE001 - peer already gone
                pass


# =============================================================================
# the client
# =============================================================================

class DSEClient:
    """Engine-shaped client for a ``DSEService`` (in-process handle or
    TCP address).  Search frontends (sweep / GA / Bayes / hillclimb)
    take it wherever they take an ``EvalEngine``: one interface, local
    or served.  It has no ``device``: a GA driven through it runs its
    genetics where the caller's ``device=`` says.

    The ``keep`` prefilter is applied client-side from locally computed
    areas (a host function of the genome under the shared calibration,
    which the TCP handshake verifies via the engine context digest), so
    skipped genomes never travel and are never memoized -- the engine's
    own semantics.  ``stats`` mirrors ``EngineStats`` client-side; its
    hits are the service's store-hit + in-flight-merge attribution.

    ``timeout`` bounds each wait for a reply, in-process or over TCP.
    Fault tolerance: a dropped connection fails fast (EOF ->
    ``ConnectionError``) and single-reply calls reconnect and retry with
    exponential backoff + jitter, up to ``retries`` times, under an
    idempotent request id (evaluation is content-addressed, so a re-sent
    request is a store hit or an in-flight merge).  The reconnect
    handshake re-verifies the engine context digest, so a *different*
    server at the same address is rejected.  Retryable server errors
    (``OverloadedError``) back off and retry.  Streaming ops (``search``
    / ``pipeline``) fail fast on EOF and are not retried.
    """

    def __init__(self, service: Optional[DSEService] = None,
                 address: Optional[tuple] = None,
                 calib: CalibrationTable = DEFAULT_CALIB,
                 timeout: float = 600.0, retries: int = 4,
                 backoff_s: float = 0.1, backoff_max_s: float = 2.0,
                 deadline_s: Optional[float] = None):
        if (service is None) == (address is None):
            raise ValueError("pass exactly one of service= or address=")
        self._service = service
        self._address = address
        self._timeout = timeout
        self.retries = max(int(retries), 0)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        # per-request wall budget: bounds the service-side wait AND the
        # client's own reconnect/backoff loop
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self._sock = None
        self._io = None
        self._context: Optional[str] = None   # pinned on first connect
        self._lock = threading.Lock()
        self._req_ids = itertools.count()
        if service is not None:
            eng = service.engine
            self.workloads = list(eng.workloads)
            self.calib = eng.calib
            self.backend = eng.backend
            self.mode = eng.mode
            self.fidelity = eng.fidelity
        else:
            self.calib = calib
            with self._lock:
                self._connect()
        self.memoize = True
        self.stats = EngineStats(workloads=len(self.workloads))

    # ---------------------------------------------------------------- wire
    def _connect(self) -> None:
        """(Re)establish the TCP session: connect, hello, verify the
        engine context digest.  Caller holds ``self._lock``."""
        self._sock = socket.create_connection(self._address,
                                              timeout=self._timeout)
        self._io = self._sock.makefile("rwb")
        hello = self._call_once({"op": "hello"})
        if not hello.get("ok", False):
            raise ConnectionError(
                f"DSE service hello failed: {hello.get('error')}")
        self.workloads = list(hello["workloads"])
        self.backend = hello["backend"]
        self.mode = hello["mode"]
        self.fidelity = hello["fidelity"]
        # recompute the engine context digest client-side from the
        # handshake knobs + the LOCAL calibration and cost-model version
        # (the function the server's context_key() runs), so a server
        # with another calib/version hashes differently and is rejected
        digest = context_digest(self.workloads, self.calib,
                                hello["aggressive_int4"],
                                hello["enable_fusion"], self.backend,
                                self.fidelity, hello.get("device")).hex()
        if digest != hello["context"]:
            self._drop()
            raise ValueError(
                "server engine context does not match this client's "
                "workloads/calibration/cost-model version/framework -- "
                "refusing to mix incompatible metrics")
        if self._context is None:
            self._context = hello["context"]
        elif self._context != hello["context"]:
            self._drop()
            raise ValueError(
                "server at this address changed engine context between "
                "reconnects (another calibration, version or device type) "
                "-- refusing to mix incompatible metrics")

    def _drop(self) -> None:
        """Tear the dead session down so the next call reconnects.
        Caller holds ``self._lock``."""
        for closer in (self._io, self._sock):
            if closer is not None:
                try:
                    closer.close()
                except Exception:   # noqa: BLE001 - already dead
                    pass
        self._sock = None
        self._io = None

    def _call_once(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """One request/reply exchange on the live session; raises
        ``ConnectionError`` on EOF.  Caller holds ``self._lock``."""
        self._io.write(_dumps(req))
        self._io.flush()
        line = self._io.readline()
        if not line:
            raise ConnectionError("DSE service closed the connection")
        return json.loads(line)

    def _call(self, req: Dict[str, Any],
              deadline: Optional[float] = None) -> Dict[str, Any]:
        """Single-reply exchange with reconnect-and-retry.  The request
        id assigned here is reused verbatim on every retry, so a resend
        after an ambiguous failure is idempotent end to end.

        With ``deadline_s`` set, the retry loop never spends longer than
        the request's remaining budget (each backoff is checked against
        it first), and the failure surfaces as ``DeadlineExceededError``
        instead of a generic ``ConnectionError``."""
        req.setdefault("rid", f"c{id(self) & 0xffffff:x}-"
                              f"{next(self._req_ids)}")
        if deadline is None and self.deadline_s is not None:
            deadline = time.monotonic() + self.deadline_s
        tries = _Backoff(self.backoff_s, self.backoff_max_s, deadline,
                         jitter=True)
        for attempt in range(self.retries + 1):
            if attempt:
                tries.pause()
            try:
                with self._lock:
                    if self._sock is None:
                        self._connect()
                    out = self._call_once(req)
            except (ConnectionError, OSError) as exc:
                with self._lock:
                    self._drop()
                tries.last = exc
                if deadline is not None and time.monotonic() >= deadline:
                    raise DeadlineExceededError(
                        "connection lost and the request deadline has "
                        "elapsed") from exc
                continue
            if out.get("ok", False):
                return out
            err = RuntimeError(f"DSE service error: {out.get('error')}")
            if not out.get("retryable", False):
                raise err
            tries.last = err
        raise tries.last

    def _wait(self, fut: concurrent.futures.Future):
        """The result of a coroutine submitted to the in-process
        service's loop, within ``timeout`` seconds (the bound a TCP
        client's socket has); raises ``ConnectionError`` when the service
        stopped with the coroutine unfinished (a stopped loop never
        resolves it)."""
        svc = self._service
        give_up = time.monotonic() + self._timeout
        while True:
            try:
                return fut.result(timeout=0.25)
            except concurrent.futures.TimeoutError:
                if svc._loop is None:
                    fut.cancel()
                    raise ConnectionError(
                        "DSE service stopped before this request "
                        "completed") from None
                if time.monotonic() >= give_up:
                    fut.cancel()
                    raise TimeoutError(
                        f"no reply from the DSE service within "
                        f"{self._timeout} s") from None

    def _local(self, fn, *args, **kw):
        """Run an engine call of the in-process service on its dispatch
        thread (the port's engine is not reentrant) and wait for it,
        within ``timeout`` seconds as ``_wait`` does."""
        if self._service._loop is None:
            raise ConnectionError("DSE service is stopped")
        fut = self._service._executor.submit(fn, *args, **kw)
        try:
            return fut.result(timeout=self._timeout)
        except concurrent.futures.TimeoutError:
            fut.cancel()
            raise TimeoutError(
                f"no reply from the DSE service within "
                f"{self._timeout} s") from None

    def _remote_metrics(self, out: Dict[str, Any]) -> Dict[str, Any]:
        return {k: np.asarray(out[k], np.float64)
                for k in ("latency", "energy", "tops_w", "area")} | \
            {"meta": out["meta"]}

    def _evaluate_remote(self, genomes: np.ndarray, mode: Optional[str],
                         canonical: Optional[np.ndarray]) -> Dict[str, Any]:
        deadline = None if self.deadline_s is None else \
            time.monotonic() + self.deadline_s
        if self._service is not None:
            tries = _Backoff(self.backoff_s, self.backoff_max_s, deadline,
                             jitter=True)
            for attempt in range(self.retries + 1):
                if attempt:
                    tries.pause()
                loop = self._service._loop
                if loop is None:
                    raise ConnectionError("DSE service is stopped")
                remaining = None if deadline is None else \
                    max(deadline - time.monotonic(), 0.0)
                fut = asyncio.run_coroutine_threadsafe(
                    self._service.evaluate(genomes, mode, canonical,
                                           deadline_s=remaining), loop)
                try:
                    return self._wait(fut)
                except Exception as exc:    # noqa: BLE001 - maybe retryable
                    if not getattr(exc, "retryable", False):
                        raise
                    tries.last = exc
            raise tries.last
        req = {"op": "evaluate", "genomes": genomes.tolist(), "mode": mode}
        if canonical is not None:
            req["canonical"] = canonical.tolist()
        if self.deadline_s is not None:
            req["deadline_s"] = self.deadline_s
        return self._remote_metrics(self._call(req, deadline=deadline))

    # ------------------------------------------------------- cluster verbs
    def evaluate_shard(self, canonical: np.ndarray,
                       mode: Optional[str] = None) -> Dict[str, Any]:
        """Raw shard dispatch for ``serve.cluster.DSECluster``: the
        genomes arrive already canonical, flow through the worker's
        coalescing queue, and come back as bare metric arrays -- no
        client-side prefilter, no area recompute; the coordinator owns
        both.  Content-addressed, so a shard re-dispatched after a
        failover or a hedge is a store hit, never a second simulation."""
        canon = np.asarray(canonical, np.int64).reshape(-1, GENOME_LEN)
        if self._service is not None:
            res = self._evaluate_remote(canon, mode, canon)
        else:
            req = {"op": "shard", "genomes": canon.tolist(), "mode": mode}
            if self.deadline_s is not None:
                req["deadline_s"] = self.deadline_s
            out = self._call(req)
            res = {k: np.asarray(out[k], np.float64)
                   for k in ("latency", "energy", "tops_w")}
        return {k: res[k] for k in ("latency", "energy", "tops_w")}

    def membership(self) -> Dict[str, Any]:
        """Worker identity + liveness (the ``membership`` wire op):
        worker_id, engine context digest, and the ``health()``
        snapshot."""
        if self._service is not None:
            return {"worker_id": self._service.worker_id,
                    "context": self._service.engine.context_key().hex(),
                    **self._service.health()}
        out = self._call({"op": "membership"})
        out.pop("ok", None)
        return out

    # ------------------------------------------------------ engine surface
    def check_workloads(self, workloads: Sequence[str],
                        calib: Optional[CalibrationTable] = None
                        ) -> "DSEClient":
        if list(workloads) != self.workloads:
            raise ValueError(
                f"service workloads {self.workloads} != caller workloads "
                f"{list(workloads)}")
        if calib is not None and calib != self.calib:
            raise ValueError("caller calib differs from the service "
                             "engine's calib -- results would not match")
        return self

    def evaluate(self, genomes: np.ndarray, keep=None,
                 mode: Optional[str] = None,
                 canonical: Optional[np.ndarray] = None) -> Dict[str, Any]:
        t0 = time.perf_counter()
        genomes = np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN)
        n, W = len(genomes), len(self.workloads)
        area = genome_areas(genomes, self.calib)
        keep_mask = np.ones(n, bool) if keep is None else \
            np.asarray(keep(area), bool)
        lat = np.zeros((n, W))
        en = np.zeros((n, W))
        tw = np.zeros((n, W))
        self.stats.requests += n
        skip = np.flatnonzero(~keep_mask)
        lat[skip] = np.inf
        en[skip] = np.inf
        self.stats.skips += len(skip)
        sel = np.flatnonzero(keep_mask)
        meta: Dict[str, Any] = {"meta_version": META_VERSION,
                                "backend": self.backend,
                                "fidelity": self.fidelity,
                                "mode": mode or self.mode,
                                "requests": n, "skips": len(skip)}
        if len(sel):
            canon = None if canonical is None else \
                np.asarray(canonical, np.int64).reshape(-1, GENOME_LEN)[sel]
            res = self._evaluate_remote(genomes[sel], mode, canon)
            lat[sel] = res["latency"]
            en[sel] = res["energy"]
            tw[sel] = res["tops_w"]
            served = res["meta"]["store_hits"] + res["meta"]["inflight_merged"]
            served = min(served, len(sel))
            self.stats.hits += served
            self.stats.misses += len(sel) - served
            meta.update(res["meta"])
        meta["hits"] = meta.get("store_hits", 0)
        meta["misses"] = len(sel) - meta["hits"]
        meta["hit_rate"] = meta["hits"] / max(n, 1)
        self.stats.eval_seconds += time.perf_counter() - t0
        return {"latency": lat, "energy": en, "tops_w": tw, "area": area,
                "meta": meta}

    def areas(self, genomes: np.ndarray) -> np.ndarray:
        genomes = np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN)
        return genome_areas(genomes, self.calib)

    def score_batch(self, genomes: np.ndarray,
                    mode: Optional[str] = None) -> Dict[str, Any]:
        """The Evaluator core call: genomes in, metrics out, no keep
        predicate and no per-request meta.  In-process it runs the
        engine's ``score_batch`` on the service's dispatch thread; over
        TCP it flows through ``evaluate`` (the wire carries cached or
        simulated content-addressed results, bit for bit the same)."""
        if self._service is not None:
            return self._local(self._service.engine.score_batch, genomes,
                               mode=mode)
        res = self.evaluate(genomes, mode=mode)
        return {k: res[k] for k in ("latency", "energy", "tops_w", "area")}

    def context_key(self) -> bytes:
        """The served engine's content-context digest (see
        ``api.context_digest``) -- verified against the local
        recomputation at every (re)connect."""
        if self._service is not None:
            return self._service.engine.context_key()
        with self._lock:
            if self._sock is None:
                self._connect()
            return bytes.fromhex(self._context)

    def rescore(self, genomes: np.ndarray, oracle: bool = False,
                mode: Optional[str] = None) -> Dict[str, Any]:
        genomes = np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN)
        if self._service is not None:
            return self._local(self._service.engine.rescore, genomes,
                               oracle=oracle, mode=mode)
        return self._remote_metrics(self._call(
            {"op": "rescore", "genomes": genomes.tolist(), "oracle": oracle,
             "mode": mode}))

    def reserve_shapes(self, max_batch: int = 64) -> None:
        if self._service is not None:
            self._service.engine.reserve_shapes(max_batch)
        else:
            self._call({"op": "reserve_shapes", "max_batch": max_batch})

    def _stream_local(self, agen) -> Iterator[Dict[str, Any]]:
        """Drive an async generator of the in-process service from this
        thread, yielding its events up to ``done`` or ``error``."""
        loop = self._service._loop
        while True:
            try:
                ev = self._wait(asyncio.run_coroutine_threadsafe(
                    agen.__anext__(), loop))
            except StopAsyncIteration:
                return
            yield ev
            if ev["event"] in ("done", "error"):
                return

    def _stream_remote(self, req: Dict[str, Any],
                       what: str) -> Iterator[Dict[str, Any]]:
        """Send one streaming request and yield its events up to ``done``
        or ``error``; EOF fails fast (no retry: events already flowed)."""
        with self._lock:
            if self._sock is None:
                self._connect()
            self._io.write(_dumps(req))
            self._io.flush()
            while True:
                line = self._io.readline()
                if not line:
                    self._drop()
                    raise ConnectionError(f"service closed mid-{what}")
                ev = json.loads(line)
                if not ev.get("ok", False):
                    raise RuntimeError(f"DSE service error: "
                                       f"{ev.get('error')}")
                ev.pop("ok", None)
                yield ev
                if ev["event"] in ("done", "error"):
                    return

    def search(self, seed_genomes, bracket: float, e_homo,
               cfg: Optional[Dict[str, Any]] = None, seed: int = 0,
               prefilter: bool = True) -> Iterator[Dict[str, Any]]:
        """Stream a server-side GA: yields the service's generation /
        done / error events (see ``DSEService.search``)."""
        if self._service is not None:
            yield from self._stream_local(self._service.search(
                seed_genomes, bracket, e_homo, cfg=cfg, seed=seed,
                prefilter=prefilter))
            return
        req = {"op": "search", "bracket": bracket,
               "e_homo": np.asarray(e_homo, np.float64).tolist(),
               "cfg": cfg, "seed": seed, "prefilter": prefilter}
        if seed_genomes is not None:
            req["seed_genomes"] = np.asarray(seed_genomes,
                                             np.int64).tolist()
        yield from self._stream_remote(req, "search")

    def pipeline(self, seeds: Sequence[int] = (0, 1, 2),
                 brackets: Optional[Sequence[float]] = None,
                 samples_per_stratum: int = 64,
                 cfg: Optional[Dict[str, Any]] = None,
                 islands: Optional[int] = None, migrate_every: int = 5,
                 migrate_k: int = 2) -> Iterator[Dict[str, Any]]:
        """Stream the server-side fused §4 pipeline: yields the
        service's stage / done / error events (see
        ``DSEService.pipeline``)."""
        if self._service is not None:
            yield from self._stream_local(self._service.pipeline(
                seeds=seeds, brackets=brackets,
                samples_per_stratum=samples_per_stratum, cfg=cfg,
                islands=islands, migrate_every=migrate_every,
                migrate_k=migrate_k))
            return
        req = {"op": "pipeline", "seeds": list(seeds),
               "samples_per_stratum": samples_per_stratum, "cfg": cfg,
               "islands": islands, "migrate_every": migrate_every,
               "migrate_k": migrate_k}
        if brackets is not None:
            req["brackets"] = [float(b) for b in brackets]
        yield from self._stream_remote(req, "pipeline")

    def service_stats(self) -> Dict[str, Any]:
        if self._service is not None:
            return {"service":
                    self._service.stats.snapshot(self._service.max_batch),
                    "engine": dataclasses.asdict(self._service.engine.stats),
                    "store": self._service.engine.store.stats.snapshot(),
                    "store_len": len(self._service.engine.store)}
        return self._call({"op": "stats"})

    def health(self) -> Dict[str, Any]:
        """The service's liveness/pressure snapshot (see
        ``DSEService.health``)."""
        if self._service is not None:
            return self._service.health()
        out = self._call({"op": "health"})
        out.pop("ok", None)
        return out

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._call_once({"op": "bye"})
                except Exception:   # noqa: BLE001 - already closed
                    pass
            self._drop()


# =============================================================================
# CLI: --smoke (the service check) and --serve (standalone TCP server)
# =============================================================================

def _smoke(tcp: bool = True, verbose: bool = True,
           device=None) -> Dict[str, Any]:
    """Two concurrent GA clients against one coalescing service must
    (1) match the same GAs run against local exact-backend engines on
    the same device bit for bit, (2) share fused dispatches (strictly
    fewer engine dispatches than the two local runs combined, with at
    least one multi-request batch), and (3) on a second run against the
    warm persistent store, report a >50 % store hit rate; the served
    pipeline must equal a local ``run_pipeline``.  ``device`` is every
    engine's (the card unless ``"cpu"`` is asked for); the sqlite store
    lives in a fresh temporary directory, removed afterwards.  Returns
    the measured payload; raises AssertionError on any violation."""
    from ..core.dse.ga import GAConfig, run_ga
    from ..core.dse.pipeline import run_pipeline
    from ..core.dse.store import MemoryLRUStore, SqliteStore, TieredStore
    from ..core.dse.sweep import run_sweep

    workloads = ["kan", "resnet50_int8"]
    bracket = 200.0
    cfg = GAConfig(population=16, generations=4, seed_top_k=8,
                   early_stop=10_000)
    seeds = (0, 1)

    def exact(store=None):
        return EvalEngine(workloads, config=EngineConfig(backend="exact",
                                                         store=store),
                          device=device)

    sweep = run_sweep(workloads, samples_per_stratum=4, seed=0,
                      brackets=(100.0, bracket), engine=exact())
    dev = exact().device

    # ---- baseline: each client against its own local exact engine --------
    local, local_dispatches = {}, {}
    for s in seeds:
        eng = exact()
        local[s] = run_ga(sweep, bracket, cfg, seed=s, engine=eng)
        local_dispatches[s] = eng.stats.dispatches
    rescore = EvalEngine(workloads, device=dev).rescore(
        local[seeds[0]].best_genome[None, :])

    # ---- the service run: two concurrent clients, shared store -----------
    tmp = tempfile.mkdtemp(prefix="dse_store_")
    store_path = f"{tmp}/results.sqlite"
    services: List[DSEService] = []

    def fresh_service():
        svc = DSEService(exact(TieredStore(MemoryLRUStore(),
                                           SqliteStore(store_path))),
                         max_batch=256, max_wait_ms=100.0).start()
        services.append(svc)
        return svc

    try:
        service = fresh_service()
        served: Dict[int, Any] = {}
        errors: List[BaseException] = []

        def client_run(s):
            try:
                served[s] = run_ga(sweep, bracket, cfg, seed=s,
                                   engine=DSEClient(service=service),
                                   device=dev)
            except Exception as exc:    # noqa: BLE001 - surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=client_run, args=(s,))
                   for s in seeds]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads), "a tenant hung"
        if errors:
            raise errors[0]
        st = service.stats
        sum_local = sum(local_dispatches.values())

        # (1) bit for bit the local exact runs (and the exact rescore)
        for s in seeds:
            assert served[s].best_fitness == local[s].best_fitness, \
                f"seed {s}: served GA diverged from the local exact engine"
            assert np.array_equal(served[s].best_genome,
                                  local[s].best_genome)
            for k in ("latency", "energy", "tops_w"):
                assert np.array_equal(served[s].best_metrics[k],
                                      local[s].best_metrics[k]), (s, k)
        assert np.array_equal(
            served[seeds[0]].best_metrics["latency"],
            rescore["latency"][0]), \
            "service metrics diverged from the local exact rescore"

        # (2) cross-tenant coalescing actually happened
        assert st.coalesced_batches >= 1, "no batch mixed the two clients"
        assert st.engine_dispatches < sum_local, (
            f"coalesced dispatches {st.engine_dispatches} not below the "
            f"per-client sum {sum_local}")

        if tcp:  # a TCP client sees the bytes the in-process path returns
            host, port = service.listen()
            cli = DSEClient(address=(host, port))
            g = local[seeds[0]].best_genome[None, :]
            over_wire = cli.evaluate(g)
            direct = asyncio.run_coroutine_threadsafe(
                service.evaluate(g), service._loop).result(timeout=600)
            for k in ("latency", "energy", "tops_w", "area"):
                assert np.array_equal(over_wire[k], direct[k]), k
            cli.close()

        # (2b) the server-side fused pipeline streams stages and matches
        # a local run_pipeline bit for bit
        pipe_kw = dict(seeds=(0,), brackets=(100.0, bracket),
                       samples_per_stratum=4,
                       cfg=dict(population=16, generations=3, seed_top_k=8,
                                early_stop=10_000))
        events = list(DSEClient(service=service).pipeline(**pipe_kw))
        assert events[-1]["event"] == "done", events[-1]
        stages = [e["stage"] for e in events if e["event"] == "stage"]
        assert "sweep" in stages and "refine" in stages and \
            "seed_done" in stages, stages
        served_pipe = events[-1]["result"]
        local_pipe = run_pipeline(
            workloads, engine=exact(),
            **{**pipe_kw, "cfg": GAConfig(**pipe_kw["cfg"])})
        assert served_pipe["front"]["points"] == \
            local_pipe.front_points.tolist(), \
            "served pipeline front diverged from the local run"
        for b in (100.0, bracket):
            assert served_pipe["results"]["0"][str(b)]["best_fitness"] == \
                local_pipe.results[0][b].best_fitness, b
        service.stop()

        # (3) a fresh service on the warm persistent store is mostly hits
        service2 = fresh_service()
        warm = run_ga(sweep, bracket, cfg, seed=seeds[0],
                      engine=DSEClient(service=service2), device=dev)
        st2 = service2.stats
        warm_rate = st2.store_hits / max(st2.request_genomes, 1)
        assert warm.best_fitness == local[seeds[0]].best_fitness
        assert warm_rate > 0.5, f"warm-store hit rate {warm_rate:.0%} <= 50%"
        service2.stop()
    finally:
        for svc in services:
            svc.stop(drain=False)
            svc.engine.store.close()
        shutil.rmtree(tmp, ignore_errors=True)

    payload = {
        "device": dev.type,
        "local_dispatches": local_dispatches,
        "service_dispatches": st.engine_dispatches,
        "coalesced_batches": st.coalesced_batches,
        "batches": st.batches,
        "batch_occupancy": st.occupancy(256),
        "mean_queue_ms": st.mean_queue_ms(),
        "warm_store_hit_rate": warm_rate,
        "best_fitness": {s: served[s].best_fitness for s in seeds},
    }
    if verbose:
        print(f"service-smoke ({dev.type}): dispatches "
              f"{st.engine_dispatches} < {sum_local} (local sum), "
              f"{st.coalesced_batches} coalesced batches, warm-store hit "
              f"rate {warm_rate:.0%}")
    return payload


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="service check: two concurrent GA clients must "
                         "match local exact runs bit for bit while sharing "
                         "fused dispatches; exits 1 on violation")
    ap.add_argument("--no-tcp", action="store_true",
                    help="skip the TCP round-trip check in --smoke")
    ap.add_argument("--serve", metavar="HOST:PORT",
                    help="run a standalone TCP server on the given address")
    ap.add_argument("--device", default=None,
                    help="the engine's device (default: the card; 'cpu' "
                         "on a machine without one)")
    ap.add_argument("--workloads", nargs="*",
                    default=["kan", "resnet50_int8"])
    ap.add_argument("--backend", default="exact")
    ap.add_argument("--fidelity", default="aggregate",
                    choices=("aggregate", "link"),
                    help="NoC/DRAM contention tier: 'aggregate' (single "
                         "busy/bandwidth terms) or 'link' (per-link "
                         "XY-routed NoC + per-channel DRAM queues)")
    ap.add_argument("--store", default=None,
                    help="sqlite path for a persistent result store")
    ap.add_argument("--max-batch", type=int, default=1024)
    ap.add_argument("--max-wait-ms", type=float, default=10.0)
    args = ap.parse_args(argv)

    if args.smoke:
        try:
            _smoke(tcp=not args.no_tcp, device=args.device)
        except AssertionError as exc:
            print(f"service-smoke FAILED: {exc}")
            return 1
        return 0
    if args.serve:
        from ..core.dse.store import MemoryLRUStore, SqliteStore, TieredStore
        host, _, port = args.serve.rpartition(":")
        store = None
        if args.store:
            store = TieredStore(MemoryLRUStore(), SqliteStore(args.store))
        engine = EvalEngine(args.workloads, config=EngineConfig(
            backend=args.backend, fidelity=args.fidelity, store=store),
            device=args.device)
        service = DSEService(engine, max_batch=args.max_batch,
                             max_wait_ms=args.max_wait_ms).start()
        bound = service.listen(host or "127.0.0.1", int(port))
        print(f"DSE service on {bound[0]}:{bound[1]} "
              f"(workloads={engine.workloads}, backend={engine.backend}, "
              f"device={engine.device})")
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            service.stop()
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
