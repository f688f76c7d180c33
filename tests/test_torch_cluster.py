"""PyTorch port, the cluster chaos suite (A11, second half, ``-m
chaos``): the sharded ``DSECluster`` coordinator under deterministic
worker loss.

Every injected fault is transient and value-preserving, so a 3-worker
cluster losing one or two workers mid-study must return results byte
for byte equal to an unfaulted single-engine run.  ``FAULT_SEED`` seeds
the injector, as in the reference's tests/test_cluster.py; the ``at=``
schedules used here are seed-independent, so every seed must pass
identically.  The sites fire at deterministic points (``worker_kill`` and
``shard_timeout`` while the caller's thread forms shards,
``heartbeat_drop`` in the sequential ``heartbeat()`` probe loop).  Every
comparison is against the port's local engine (tests/test_torch_service.py
holds that engine against the JAX package's).
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dse.api import EngineConfig  # noqa: E402
from repro_torch.core.dse.encoding import random_genomes  # noqa: E402
from repro_torch.core.dse.engine import EvalEngine  # noqa: E402
from repro_torch.core.dse.faults import (FaultInjector,  # noqa: E402
                                         fault_seed_from_env)
from repro_torch.core.dse.ga import GAConfig, run_ga  # noqa: E402
from repro_torch.core.dse.pipeline import run_pipeline  # noqa: E402
from repro_torch.core.dse.sweep import run_sweep  # noqa: E402
from repro_torch.serve.cluster import ClusterError, DSECluster  # noqa: E402
from repro_torch.serve.dse_service import DSEService  # noqa: E402

pytestmark = pytest.mark.chaos

SEED = fault_seed_from_env()
WLS = ["kan"]
METRICS = ("latency", "energy", "tops_w", "area")


def _genomes(n=8, seed=3):
    return random_genomes(np.random.default_rng(seed), n)


def _engine():
    return EvalEngine(WLS, config=EngineConfig(backend="exact"),
                      device="cpu")


def _cluster(n=3, injector=None, **kw):
    svcs = [DSEService(_engine(), max_batch=256, max_wait_ms=5.0,
                       worker_id=f"chaos-w{i}").start() for i in range(n)]
    kw.setdefault("backoff_s", 0.01)
    kw.setdefault("rejoin_backoff_s", 0.01)
    return DSECluster(svcs, fault_injector=injector, **kw), svcs


def _stop(cluster, svcs):
    cluster.close()
    for s in svcs:
        s.stop(drain=False)


def _same(a, b, keys=METRICS):
    for k in keys:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


def _same_ga(a, b):
    assert a.best_fitness == b.best_fitness
    assert a.best_genome.tobytes() == b.best_genome.tobytes()
    assert a.history == b.history and a.evaluated == b.evaluated
    _same(a.best_metrics, b.best_metrics, METRICS[:3])


def _ga_setup():
    cfg = GAConfig(population=12, generations=3, seed_top_k=6,
                   early_stop=10_000)
    sweep = run_sweep(WLS, samples_per_stratum=4, seed=0,
                      brackets=(100.0, 200.0), engine=_engine())
    return cfg, sweep


# =============================================================================
# rendezvous sharding: deterministic, minimal movement
# =============================================================================

def test_rendezvous_ranking_is_stable_and_minimal_movement():
    """Each genome's worker ranking is a deterministic permutation, and
    losing a worker moves only the keys that worker owned."""
    cl, svcs = _cluster(3)
    try:
        keys = [b"latency:" + g.tobytes()
                for g in np.ascontiguousarray(_genomes(64), np.int64)]
        ranks = [cl._rank(k) for k in keys]
        assert ranks == [cl._rank(k) for k in keys]      # stable
        assert all(sorted(r) == [0, 1, 2] for r in ranks)
        owners = [r[0] for r in ranks]
        assert len(set(owners)) == 3                     # spread, not piled
        # drop worker 0: its keys fail over to their rank-2 worker,
        # everyone else's owner is untouched
        cl._workers[0].dead = True
        for k, r in zip(keys, ranks):
            w = cl._pick(cl._rank(k))
            assert w.index == (r[1] if r[0] == 0 else r[0])
    finally:
        _stop(cl, svcs)


def test_cluster_evaluate_bitwise_equal_to_local_engine():
    g = _genomes(24, seed=7)
    cl, svcs = _cluster(3)
    try:
        res = cl.evaluate(g)
        _same(_engine().evaluate(g), res)
        assert res["meta"]["shards"] >= 2       # genuinely sharded
        assert res["meta"]["requests"] == len(g)
    finally:
        _stop(cl, svcs)


# =============================================================================
# worker loss mid-GA: bit for bit the unfaulted run
# =============================================================================

@pytest.mark.parametrize("kills,timeouts,bracket,seed", [
    ((5,), (), 200.0, 0),           # one worker lost mid-GA
    ((2, 6), (3, 7), 100.0, 1),     # two of three lost, plus timeouts
], ids=["one_kill", "two_kills_and_timeouts"])
def test_ga_bitwise_under_worker_kills(kills, timeouts, bracket, seed):
    """A 3-worker cluster losing workers mid-GA (their services stop for
    real) fails the dead workers' shards over to the survivors and
    finishes bit for bit a clean single-engine run; the genetics run on
    the caller's device."""
    cfg, sweep = _ga_setup()
    clean = run_ga(sweep, bracket, cfg, seed=seed, engine=_engine())
    inj = FaultInjector(seed=SEED, at={"worker_kill": kills,
                                       "shard_timeout": timeouts})
    cl, svcs = _cluster(3, injector=inj)
    try:
        served = run_ga(sweep, bracket, cfg, seed=seed, engine=cl,
                        device="cpu")
        assert inj.fired()["worker_kill"] == len(kills)
        assert inj.fired()["shard_timeout"] == len(timeouts)
        if timeouts:
            assert cl.cluster_stats.retried_shards >= len(timeouts)
        _same_ga(served, clean)
        statuses = [m["status"] for m in cl.membership()]
        assert statuses.count("dead") == len(kills)
        # the survivors still serve fresh work after the carnage
        g = _genomes(6, seed=8)
        _same(_engine().evaluate(g), cl.evaluate(g))
        assert not cl._inflight, "leaked in-flight futures"
    finally:
        _stop(cl, svcs)


def test_all_workers_dead_raises_cluster_error_fast():
    cl, svcs = _cluster(2, shard_retries=2)
    try:
        for w in cl._workers:
            cl._kill_worker(w)
        t0 = time.time()
        with pytest.raises(ClusterError):
            cl.evaluate(_genomes(4, seed=9))
        assert time.time() - t0 < 30        # terminal, not a hang
        assert not cl._inflight
    finally:
        _stop(cl, svcs)


# =============================================================================
# pipeline through the cluster (+ checkpoint composition)
# =============================================================================

def test_pipeline_through_faulted_cluster_bitwise(tmp_path):
    """``run_pipeline(cluster=...)`` under worker loss and a shard
    timeout, checkpointed: the merged Pareto front, the per-seed
    results and ``evaluated`` are byte for byte a plain local run's, and
    the checkpoint the clustered run wrote replays on a local run with
    no engine work (the run digest is the same)."""
    kw = dict(seeds=(0, 1), brackets=(100.0, 200.0),
              samples_per_stratum=4,
              cfg=GAConfig(population=12, generations=2, seed_top_k=6,
                           early_stop=10_000))
    ref = run_pipeline(WLS, engine=_engine(), **kw)

    inj = FaultInjector(seed=SEED, at={"worker_kill": (3,),
                                       "shard_timeout": (1,)})
    cl, svcs = _cluster(3, injector=inj)
    ck = str(tmp_path / "ck")
    try:
        res = run_pipeline(WLS, engine=_engine(), cluster=cl,
                           checkpoint=ck, **kw)
    finally:
        _stop(cl, svcs)
    assert inj.fired()["worker_kill"] == 1
    assert inj.fired()["shard_timeout"] == 1
    for a, b in ((ref, res),):
        assert a.front_points.tobytes() == b.front_points.tobytes()
        assert a.front_genomes.tobytes() == b.front_genomes.tobytes()
        assert a.evaluated == b.evaluated
        for s in kw["seeds"]:
            assert a.results[s].keys() == b.results[s].keys()
            for br, r in a.results[s].items():
                _same_ga(r, b.results[s][br])
    # resume the clustered run's checkpoint locally: every stage replays
    events = []
    local = _engine()
    again = run_pipeline(WLS, engine=local, checkpoint=ck,
                         on_stage=events.append, **kw)
    assert events and all(e.get("resumed") for e in events)
    assert local.stats.dispatches == 0
    assert again.front_points.tobytes() == ref.front_points.tobytes()
    assert again.evaluated == ref.evaluated


# =============================================================================
# health: heartbeat ejection + backoff-gated rejoin
# =============================================================================

def test_heartbeat_ejects_and_rejoins_deterministically():
    """Dropping worker 0's heartbeat ``eject_after`` times in a row
    ejects it; once the probes succeed again after the rejoin backoff,
    it rejoins and takes traffic."""
    # 3 workers probed in order each round: indices 0, 3, 6 are w0's
    # first three probes -- exactly eject_after consecutive failures
    inj = FaultInjector(seed=SEED, at={"heartbeat_drop": (0, 3, 6)})
    cl, svcs = _cluster(3, injector=inj, eject_after=3)
    try:
        cl.heartbeat()
        cl.heartbeat()
        assert [m["status"] for m in cl.membership()] == ["ok"] * 3
        cl.heartbeat()                       # third drop: ejected
        assert inj.fired()["heartbeat_drop"] == 3
        assert cl.membership()[0]["status"] in ("ejected", "rejoining")
        assert cl.cluster_stats.ejections == 1
        # an ejected worker takes no traffic, the survivors do
        res = cl.evaluate(_genomes(12, seed=10))
        assert res["meta"]["workers"] == 2
        time.sleep(0.05)                     # rejoin backoff (0.01 s)
        cl.heartbeat()                       # clean probe: rejoined
        assert [m["status"] for m in cl.membership()] == ["ok"] * 3
        assert cl.cluster_stats.rejoins == 1
        g = _genomes(12, seed=10)
        _same(_engine().evaluate(g), cl.evaluate(g))
    finally:
        _stop(cl, svcs)


# =============================================================================
# TCP workers: same invariants over the wire
# =============================================================================

def test_tcp_worker_cluster_bitwise_under_faults():
    """A mixed cluster (one TCP worker, two in-process) with an
    injected shard timeout still returns local-engine bytes."""
    svcs = [DSEService(_engine(), max_batch=256, max_wait_ms=5.0,
                       worker_id=f"tcp-w{i}").start() for i in range(3)]
    workers = [svcs[0].listen(), svcs[1], svcs[2]]
    inj = FaultInjector(seed=SEED, at={"shard_timeout": (1,)})
    cl = DSECluster(workers, fault_injector=inj, backoff_s=0.01)
    g = _genomes(18, seed=11)
    try:
        res = cl.evaluate(g)
        _same(_engine().evaluate(g), res)
        assert inj.fired()["shard_timeout"] == 1
        assert cl.cluster_stats.retried_shards >= 1
        assert not cl._inflight
    finally:
        cl.close()
        for s in svcs:
            s.stop(drain=False)
