"""PyTorch port, the DSE evaluation service (A11, second half): served
metrics against one module-scoped exact ``EvalEngine`` of the JAX
package (in-process and over the TCP front, byte for byte), and against
the port's local engine; cross-request coalescing and in-flight dedup
accounting, a many-tenant stress case; the client's engine surface
(keep prefilter, rescore, score_batch); the served ``search`` and
``pipeline`` bit for bit the port's local ``run_ga`` / ``run_pipeline``;
resilience (stop, health, backpressure, deadlines, fail-fast) with the
deadline and overload cases gated by a ``threading.Event`` in the engine,
not by the wall clock; and the service chaos cases of the reference's
tests/test_faults.py (engine faults under two GA tenants, TCP drops)."""
import asyncio
import json
import socket
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dse.api import EngineConfig as R_EngineConfig  # noqa: E402
from repro.core.dse.engine import EvalEngine as R_EvalEngine  # noqa: E402
from repro.launch.hillclimb import dse_hillclimb as R_hillclimb  # noqa: E402
from repro_torch.core.dse.api import EngineConfig  # noqa: E402
from repro_torch.core.dse.encoding import random_genomes  # noqa: E402
from repro_torch.core.dse.engine import EvalEngine, genome_areas  # noqa: E402
from repro_torch.core.dse.faults import (FaultInjector,  # noqa: E402
                                         fault_seed_from_env,
                                         inject_engine_faults)
from repro_torch.core.dse.ga import GAConfig, run_ga  # noqa: E402
from repro_torch.core.dse.pipeline import run_pipeline  # noqa: E402
from repro_torch.core.dse.sweep import run_sweep  # noqa: E402
from repro_torch.launch import hillclimb  # noqa: E402
from repro_torch.serve import dse_service  # noqa: E402
from repro_torch.serve.cluster import DSECluster  # noqa: E402
from repro_torch.serve.dse_service import (DeadlineExceededError,  # noqa: E402
                                           DSEClient, DSEService,
                                           OverloadedError, _SeedPool)

SEED = fault_seed_from_env()
WLS = ["kan"]
METRICS = ("latency", "energy", "tops_w", "area")
WAIT_S = 120.0          # every future and join waits at most this long


def _engine():
    return EvalEngine(WLS, config=EngineConfig(backend="exact"),
                      device="cpu")


def _genomes(n=10, seed=5):
    return random_genomes(np.random.default_rng(seed), n)


def _same(a, b, keys=METRICS):
    for k in keys:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


def _on_loop(svc, coro):
    return asyncio.run_coroutine_threadsafe(coro, svc._loop).result(WAIT_S)


def _gate(engine, method="evaluate"):
    """Hold every call of ``engine.<method>`` until ``gate`` is set;
    ``entered`` is set once a call waits on it (the deadline and overload
    cases block the engine, not the clock).  Returns (gate, entered)."""
    gate, entered = threading.Event(), threading.Event()
    real = getattr(engine, method)

    def gated(*a, **kw):
        entered.set()
        assert gate.wait(WAIT_S), "gate never opened"
        return real(*a, **kw)

    setattr(engine, method, gated)
    return gate, entered


@pytest.fixture(scope="module")
def reference():
    """One exact engine of the JAX package for the whole file."""
    return R_EvalEngine(WLS, config=R_EngineConfig(backend="exact"))


@pytest.fixture(scope="module")
def service():
    svc = DSEService(_engine(), max_batch=64, max_wait_ms=20.0).start()
    yield svc
    svc.stop()


@pytest.fixture(scope="module")
def address(service):
    return service.listen()


# =============================================================================
# parity: the reference, the local engine, in-process and over the wire
# =============================================================================

@pytest.mark.parametrize("transport", ["client", "tcp"])
def test_served_metrics_equal_the_reference(transport, service, address,
                                            reference):
    """10 genomes from default_rng(5): the served rows equal the JAX
    package's exact engine and the port's local engine byte for byte
    (JSON floats round-trip float64 exactly, so the wire adds nothing),
    and a repeat is served from the store, still byte for byte."""
    g = _genomes()
    cl = (DSEClient(service=service) if transport == "client"
          else DSEClient(address=address, timeout=60.0))
    try:
        res = cl.evaluate(g)
        _same(res, reference.evaluate(g))
        _same(res, _engine().evaluate(g))
        meta = res["meta"]
        assert meta["requests"] == len(g)
        for key in ("queue_ms", "batch_occupancy", "store_hits",
                    "hit_rate", "batches", "inflight_merged"):
            assert key in meta
        again = cl.evaluate(g)
        assert again["meta"]["hit_rate"] == 1.0
        _same(res, again)
        if transport == "tcp":
            assert cl.service_stats()["service"]["requests"] >= 1
    finally:
        cl.close()


def test_concurrent_tenants_share_dispatches(service):
    g = _genomes(16, seed=7)
    st = service.stats
    d0, merged0, hits0 = (st.engine_dispatches, st.inflight_merged,
                          st.store_hits)
    barrier = threading.Barrier(2)
    out, errs = {}, []

    def tenant(i):
        try:
            barrier.wait(WAIT_S)
            out[i] = DSEClient(service=service).evaluate(g)
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=tenant, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    _same(out[0], out[1])
    # 16 unique genomes fit one engine chunk: exactly one fused dispatch
    # serves BOTH tenants -- the duplicate request rides the in-flight
    # futures or the store, never the simulator
    assert st.engine_dispatches - d0 <= 1
    assert (st.inflight_merged - merged0) + (st.store_hits - hits0) >= len(g)


def test_many_tenants_stress_no_lost_rows():
    """More tenant threads than cores, a shortened switch interval,
    overlapping genome sets: every tenant gets its local rows byte for
    byte, the service counts every genome, and nothing stays in
    flight."""
    svc = DSEService(_engine(), max_batch=32, max_wait_ms=2.0).start()
    local = _engine()
    n_tenants = 12
    sets = [_genomes(8, seed=100 + i % 5) for i in range(n_tenants)]
    out, errs = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def tenant(i):
            try:
                out[i] = DSEClient(service=svc).evaluate(sets[i])
            except Exception as e:  # pragma: no cover - surfaced below
                errs.append(e)

        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(n_tenants)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errs, errs
        for i in range(n_tenants):
            _same(out[i], local.evaluate(sets[i]))
        assert svc.stats.requests == n_tenants
        assert svc.stats.request_genomes == 8 * n_tenants
        assert not svc._inflight
    finally:
        svc.stop()


def test_client_keep_prefilter_matches_local(service):
    g = _genomes(12, seed=8)
    med = float(np.median(genome_areas(g)))

    def keep(areas):
        return areas <= med

    local = _engine().evaluate(g, keep=keep)
    res = DSEClient(service=service).evaluate(g, keep=keep)
    _same(local, res)
    skipped = ~keep(genome_areas(g))
    assert np.all(np.isinf(res["latency"][skipped]))
    assert res["meta"]["requests"] == int((~skipped).sum())


@pytest.mark.parametrize("transport", ["client", "tcp"])
def test_client_rescore_and_score_batch_match_local(transport, service,
                                                    address):
    g = _genomes(4, seed=9)
    cl = (DSEClient(service=service) if transport == "client"
          else DSEClient(address=address, timeout=60.0))
    try:
        _same(_engine().rescore(g), cl.rescore(g), METRICS[:3])
        _same(_engine().score_batch(g), cl.score_batch(g))
    finally:
        cl.close()


def test_client_requires_exactly_one_transport(service):
    with pytest.raises(ValueError):
        DSEClient()
    with pytest.raises(ValueError):
        DSEClient(service=service, address=("127.0.0.1", 1))


# =============================================================================
# served search and pipeline: bit for bit the local runs
# =============================================================================

@pytest.mark.parametrize("transport", ["client", "tcp"])
def test_search_streams_generations_and_equals_local_run_ga(
        transport, service, address):
    seeds = _genomes(8, seed=10)
    bracket = 200.0
    # a synthetic homogeneous baseline is enough to drive Eq. 8
    e_homo = np.full(len(WLS), 1e12)
    cfg = {"population": 8, "generations": 2, "seed_top_k": 4,
           "early_stop": 10_000}
    cl = (DSEClient(service=service) if transport == "client"
          else DSEClient(address=address, timeout=60.0))
    try:
        events = list(cl.search(seeds, bracket, e_homo, cfg=cfg, seed=0))
    finally:
        cl.close()
    kinds = [e["event"] for e in events]
    assert kinds[-1] == "done" and kinds[:-1] == ["generation"] * 3
    for ev in events[:-1]:
        assert ev["front_size"] == len(ev["front"]["points"])
        assert all(len(p) == 3 for p in ev["front"]["points"])
    res = events[-1]["result"]
    # the served GA's genetics ran on the service engine's device; the
    # same GA on a local engine gives the same bytes
    local = run_ga(_SeedPool(WLS, seeds, bracket, e_homo), bracket,
                   GAConfig(**cfg), seed=0, engine=_engine(), device="cpu")
    assert res["best_fitness"] == local.best_fitness
    assert res["best_genome"] == local.best_genome.tolist()
    assert res["history"] == local.history
    assert res["evaluated"] == local.evaluated
    for k in ("latency", "energy", "tops_w"):
        assert res["best_metrics"][k] == \
            np.asarray(local.best_metrics[k]).tolist(), k


def test_served_pipeline_equals_local_run_pipeline():
    """The pipeline op needs an exact engine of its own (it runs the
    whole study on the dispatch thread); its streamed result equals a
    local run_pipeline with the same seeds byte for byte."""
    svc = DSEService(_engine()).start()
    kw = dict(seeds=(0,), brackets=(100.0, 200.0), samples_per_stratum=2,
              cfg=dict(population=8, generations=2, seed_top_k=4,
                       early_stop=10_000))
    try:
        cl = DSEClient(address=svc.listen(), timeout=60.0)
        try:
            events = list(cl.pipeline(**kw))
        finally:
            cl.close()
    finally:
        svc.stop()
    assert events[-1]["event"] == "done", events[-1]
    stages = [e["stage"] for e in events if e["event"] == "stage"]
    assert stages[0] == "sweep" and "refine" in stages \
        and stages[-1] == "seed_done", stages
    served = events[-1]["result"]
    local = run_pipeline(WLS, engine=_engine(),
                         **{**kw, "cfg": GAConfig(**kw["cfg"])})
    assert served["front"]["points"] == local.front_points.tolist()
    assert served["front"]["genomes"] == local.front_genomes.tolist()
    assert served["evaluated"] == local.evaluated
    for b, r in local.results[0].items():
        got = served["results"]["0"][str(b)]
        assert got["best_fitness"] == r.best_fitness, b
        assert got["best_genome"] == r.best_genome.tolist(), b


# =============================================================================
# dse_hillclimb over any Evaluator
# =============================================================================

HILL = dict(budget_mm2=200.0, steps=3, neighbors=8, seed=0)


@pytest.mark.parametrize("surface", ["client", "tcp", "cluster"])
def test_dse_hillclimb_through_a_served_evaluator_equals_local(
        surface, service, address, reference):
    """The same walk through a client or a cluster as through a local
    engine: the same genome and metrics byte for byte; the local walk
    finds the reference's genome, its energy within rel 1e-9."""
    local = hillclimb.dse_hillclimb(WLS, engine=_engine(), **HILL)
    if surface == "cluster":
        svcs = [DSEService(_engine(), worker_id=f"hill-w{i}").start()
                for i in range(2)]
        ev = DSECluster(svcs)
    else:
        svcs = []
        ev = (DSEClient(service=service) if surface == "client"
              else DSEClient(address=address, timeout=60.0))
    try:
        served = hillclimb.dse_hillclimb(WLS, engine=ev, **HILL)
    finally:
        ev.close()
        for svc in svcs:
            svc.stop()
    for k in ("best_genome", "mean_energy_pj", "area_mm2",
              "per_workload_latency_s", "workloads"):
        assert served[k] == local[k], k
    want = R_hillclimb(WLS, engine=reference, **HILL)
    assert local["best_genome"] == want["best_genome"]
    assert abs(local["mean_energy_pj"] - want["mean_energy_pj"]) <= \
        1e-9 * abs(want["mean_energy_pj"])


def test_hillclimb_cli_dse_mode_and_the_unported_cell_mode(tmp_path,
                                                           capsys):
    hillclimb.main(["--dse", "--workloads", "kan", "--steps", "2",
                    "--device", "cpu", "--tag", "t", "--out",
                    str(tmp_path)])
    assert (tmp_path / "dse_hillclimb_t.json").exists()
    assert "mean_energy_pj" in capsys.readouterr().out
    # the cell mode is ported: one full-size cell on the fake mesh (the
    # 500k-token decode of mamba2-780m traces in a few seconds)
    hillclimb.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                    "--tag", "c", "--out", str(tmp_path)])
    assert (tmp_path / "mamba2-780m_long_500k_c.json").exists()
    assert '"dominant"' in capsys.readouterr().out


# =============================================================================
# resilience: stop/health/backpressure/deadline/fail-fast
# =============================================================================

def test_stop_is_idempotent_and_close_is_an_alias():
    svc = DSEService(_engine()).start()
    assert svc.health()["status"] == "ok"
    svc.stop()
    svc.stop()                  # second stop: silent no-op
    svc.close()                 # alias, also a no-op now
    assert svc.health()["status"] == "stopped"
    assert svc._loop is None and svc._thread is None


def test_health_in_process_and_over_the_wire(service, address):
    h = service.health()
    assert h["status"] == "ok" and h["uptime_s"] >= 0
    assert {"queue_depth", "max_queue", "inflight"} <= set(h)
    cl = DSEClient(address=address, timeout=60.0)
    try:
        assert cl.health()["status"] == "ok"
        assert cl.membership()["context"] == service.engine.context_key().hex()
    finally:
        cl.close()


def test_tcp_reads_a_request_line_longer_than_64_kib():
    """asyncio's default line limit (64 KiB, about 500 genomes with their
    canonical forms) would drop the connection on a micro-batch; the
    front reads lines up to ``_LINE_LIMIT``."""
    assert dse_service._LINE_LIMIT >= 1 << 20
    svc = DSEService(_engine()).start()
    try:
        with socket.create_connection(svc.listen(), timeout=WAIT_S) as s:
            io = s.makefile("rwb")
            io.write(json.dumps({"op": "health",
                                 "pad": "x" * (1 << 17)}).encode() + b"\n")
            io.flush()
            reply = json.loads(io.readline())
    finally:
        svc.stop()
    assert reply["ok"] and reply["status"] == "ok"


@pytest.mark.parametrize("case", ["oversized", "backlog"])
def test_overload_rejects_with_retryable_error(case):
    """``oversized``: 4 genomes never fit a 1-slot queue.  ``backlog``:
    with the engine gated, a first request holds the dispatch and a
    second fills 3 of 4 queue slots, so 4 more genomes are rejected
    before anything enqueues (they would fit an empty queue); opening
    the gate lets the first two finish."""
    eng = _engine()
    gate, entered = _gate(eng)
    svc = DSEService(eng, max_queue=1 if case == "oversized" else 4,
                     max_wait_ms=0.0).start()
    pending = []
    try:
        if case == "backlog":
            pending.append(asyncio.run_coroutine_threadsafe(
                svc.evaluate(_genomes(1, seed=20)), svc._loop))
            assert entered.wait(WAIT_S)    # the batcher is blocked
            pending.append(asyncio.run_coroutine_threadsafe(
                svc.evaluate(_genomes(3, seed=21)), svc._loop))
            deadline = time.monotonic() + WAIT_S
            while svc._queue.qsize() < 3:
                assert time.monotonic() < deadline
                time.sleep(0.001)
        with pytest.raises(OverloadedError) as ei:
            # rejected at admission, and the client's retry sees the
            # same overload
            DSEClient(service=svc, retries=1,
                      backoff_s=0.01).evaluate(_genomes(4, seed=11))
        assert getattr(ei.value, "retryable", False)
        assert svc._queue.qsize() == (3 if case == "backlog" else 0)
        gate.set()
        assert [f.result(WAIT_S)["latency"].shape[0] for f in pending] == \
            ([1, 3] if case == "backlog" else [])
    finally:
        gate.set()
        svc.stop()


def test_deadline_bounds_the_wait_not_the_work():
    """With the dispatch gated, a request with a deadline times out
    while its rows stay in flight; once the gate opens an unbounded
    follow-up gets the full rows, byte for byte the local engine's."""
    eng = _engine()
    gate, _ = _gate(eng)
    svc = DSEService(eng, max_wait_ms=1.0).start()
    g = _genomes(6, seed=12)
    try:
        with pytest.raises(DeadlineExceededError):
            _on_loop(svc, svc.evaluate(g, deadline_s=0.05))
        assert svc._inflight                  # the work kept running
        gate.set()
        out = _on_loop(svc, svc.evaluate(g))
        _same(_engine().evaluate(g), out)
    finally:
        gate.set()
        svc.stop()


def test_dead_server_fails_fast_not_600s():
    svc = DSEService(_engine()).start()
    host, port = svc.listen()
    cl = DSEClient(address=(host, port), retries=2, backoff_s=0.01)
    cl.evaluate(_genomes(3, seed=13))
    svc.stop()
    t0 = time.time()
    with pytest.raises((ConnectionError, OSError)):
        cl.evaluate(_genomes(3, seed=13))
    # EOF/refused surfaces through the bounded retry loop in seconds --
    # never a silent hang until the 600 s socket timeout
    assert time.time() - t0 < 30
    cl.close()


def test_client_deadline_caps_reconnect_storm():
    """A client with ``deadline_s`` never spends longer reconnecting than
    the request's remaining budget, and the failure surfaces as
    ``DeadlineExceededError``."""
    svc = DSEService(_engine()).start()
    host, port = svc.listen()
    # a generous retry policy that would spend many seconds reconnecting
    # without the deadline: 8 retries, backoff up to 5 s per attempt
    cl = DSEClient(address=(host, port), retries=8, backoff_s=0.2,
                   backoff_max_s=5.0, deadline_s=0.5)
    res = cl.evaluate(_genomes(3, seed=14))    # healthy round trip first
    assert res["latency"].shape == (3, len(WLS))
    svc.stop()
    t0 = time.time()
    with pytest.raises(DeadlineExceededError):
        cl.evaluate(_genomes(3, seed=15))
    assert time.time() - t0 < 3.0
    cl.close()


def test_client_without_deadline_keeps_connectionerror_contract():
    svc = DSEService(_engine()).start()
    host, port = svc.listen()
    cl = DSEClient(address=(host, port), retries=1, backoff_s=0.01)
    cl.evaluate(_genomes(2, seed=16))
    svc.stop()
    with pytest.raises((ConnectionError, OSError)):
        cl.evaluate(_genomes(2, seed=16))
    cl.close()


def test_stop_fails_undrained_futures_loudly():
    svc = DSEService(_engine()).start()
    planted = threading.Event()
    box = {}

    def plant():       # a future the batcher will never resolve
        box["fut"] = svc._loop.create_future()
        svc._inflight[b"orphan"] = box["fut"]
        planted.set()

    svc._loop.call_soon_threadsafe(plant)
    assert planted.wait(WAIT_S)
    svc.stop(drain=False)
    # nothing hangs forever: stop() failed the orphan with a clear error
    assert isinstance(box["fut"].exception(), ConnectionError)


@pytest.mark.parametrize("verb", ["evaluate", "score_batch", "rescore"])
def test_in_process_wait_is_bounded_by_the_client_timeout(verb):
    """A reply that never comes (the engine call gated shut) surfaces as
    ``TimeoutError`` after the client's ``timeout``, as a TCP client's
    socket timeout would: through the batcher (``evaluate``) and on the
    dispatch thread directly (``score_batch``, ``rescore``)."""
    eng = _engine()
    gate, _ = _gate(eng, verb)
    svc = DSEService(eng).start()
    try:
        with pytest.raises(TimeoutError):
            getattr(DSEClient(service=svc, timeout=0.5, retries=0), verb)(
                _genomes(2, seed=18))
    finally:
        gate.set()
        svc.stop()


def test_in_process_waiter_fails_when_the_service_stops():
    """A tenant blocked on a gated dispatch gets ``ConnectionError``
    when the service stops without draining, not a wait forever."""
    eng = _engine()
    gate, entered = _gate(eng)
    svc = DSEService(eng).start()
    errs = []

    def tenant():
        try:
            DSEClient(service=svc, retries=0).evaluate(_genomes(2, seed=17))
        except Exception as e:    # noqa: BLE001 - inspected below
            errs.append(e)

    t = threading.Thread(target=tenant)
    t.start()
    assert entered.wait(WAIT_S)
    svc.stop(drain=False)
    t.join(WAIT_S)
    gate.set()
    assert not t.is_alive()
    assert len(errs) == 1 and isinstance(errs[0], ConnectionError)


# =============================================================================
# service chaos (the reference's tests/test_faults.py): tenants stay bit
# for bit correct, nothing hangs
# =============================================================================

@pytest.mark.chaos
def test_two_tenant_gas_bitwise_equal_under_service_chaos():
    """Two concurrent GA tenants against a service whose engine raises
    and NaN-poisons on an injected schedule: the batcher loop survives,
    the clients' retries converge, no future hangs, and both tenants'
    results equal clean local runs byte for byte."""
    cfg = GAConfig(population=12, generations=3, seed_top_k=6,
                   early_stop=10_000)
    sweep = run_sweep(WLS, samples_per_stratum=4, seed=0,
                      brackets=(100.0, 200.0), engine=_engine())
    bracket = 200.0
    local = {s: run_ga(sweep, bracket, cfg, seed=s, engine=_engine())
             for s in (0, 1)}
    inj = FaultInjector(seed=SEED, at={"engine_exc": (1,),
                                       "nan_metrics": (3,)})
    svc = DSEService(inject_engine_faults(_engine(), inj), max_batch=256,
                     max_wait_ms=50.0).start()
    served, errs = {}, []

    def tenant(s):
        try:
            served[s] = run_ga(sweep, bracket, cfg, seed=s,
                               engine=DSEClient(service=svc, retries=6,
                                                backoff_s=0.01),
                               device="cpu")
        except Exception as exc:    # pragma: no cover - surfaced below
            errs.append(exc)

    ts = [threading.Thread(target=tenant, args=(s,)) for s in (0, 1)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in ts), "a tenant hung under chaos"
        assert not errs, errs
        assert inj.fired()["engine_exc"] == 1
        assert inj.fired()["nan_metrics"] == 1
        for s in (0, 1):
            assert served[s].best_fitness == local[s].best_fitness, s
            assert served[s].best_genome.tobytes() == \
                local[s].best_genome.tobytes(), s
            _same(served[s].best_metrics, local[s].best_metrics,
                  METRICS[:3])
        assert not svc._inflight, "leaked in-flight futures"
    finally:
        svc.stop()


@pytest.mark.chaos
def test_tcp_drops_are_survived_bitwise():
    """A TCP tenant whose connection the service keeps dropping
    reconnects and retries idempotently to the bytes a clean evaluation
    returns."""
    g = _genomes(6, seed=3)
    clean = _engine().evaluate(g)
    inj = FaultInjector(seed=SEED, at={"tcp_drop": (1, 3)})
    svc = DSEService(_engine(), fault_injector=inj).start()
    cli = DSEClient(address=svc.listen(), retries=6, backoff_s=0.01,
                    timeout=30.0)
    try:
        for _ in range(3):          # rides through both scheduled drops
            _same(clean, cli.evaluate(g))
        assert inj.fired()["tcp_drop"] == 2
    finally:
        cli.close()
        svc.stop()
    assert not svc._inflight
