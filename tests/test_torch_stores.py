"""PyTorch port, the result stores and the fault injector: the JAX
package's store and fault cases that touch no service, on the port's
``SqliteStore``/``TieredStore``/``FaultInjector``; the row encoding and
the fault schedule bit for bit the reference's; the engine's
``score_batch`` bit for bit ``evaluate``'s rows, ``export_memo``/
``import_memo`` round trips, and the context digest keeping port rows
apart from the reference's and from other devices'."""
import os
import sqlite3
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dse import faults as R_faults  # noqa: E402
from repro.core.dse import store as R_store  # noqa: E402
from repro_torch.core.dse import faults as P_faults  # noqa: E402
from repro_torch.core.dse.api import EngineConfig, context_digest  # noqa: E402
from repro_torch.core.dse.encoding import GENOME_LEN, random_genomes  # noqa: E402
from repro_torch.core.dse.engine import (EvalEngine,  # noqa: E402
                                         NonFiniteMetricsError,
                                         canonical_genomes)
from repro_torch.core.dse.faults import (FAULT_SITES, FaultInjector,  # noqa: E402
                                         FaultyStore, InjectedEngineError,
                                         inject_engine_faults)
from repro_torch.core.dse.store import (COST_MODEL_VERSION,  # noqa: E402
                                        MemoryLRUStore, SqliteStore,
                                        StoreStats, TieredStore)

W = 3          # metric-row width of the synthetic rows
WLS = ["kan"]
KEYS = ("latency", "energy", "tops_w", "area")


def _row(seed: int):
    rng = np.random.default_rng(seed)
    # adversarial float64 payloads: denormals, huge, negative zero, inf
    lat = rng.random(W) * np.array([5e-324, 1e308, -0.0])
    return (lat, rng.standard_normal(W), np.array([np.inf, 0.0, 1e-30]))


def _bitwise(a, b) -> bool:
    return all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
               for x, y in zip(a, b))


def _engine(**kw):
    return EvalEngine(WLS, config=EngineConfig(backend="exact", **kw),
                      device="cpu")


def _genomes(n=6, seed=3):
    return random_genomes(np.random.default_rng(seed), n)


# ------------------------------------------------------------ the reference

@pytest.mark.parametrize("seed", range(4))
def test_row_encoding_byte_for_byte_the_reference(seed):
    row = _row(seed)
    got = SqliteStore._encode(row)
    want = R_store.SqliteStore._encode(row)
    assert got[0] == want[0] and got[1] == want[1]
    assert _bitwise(SqliteStore._decode(*got),
                    R_store.SqliteStore._decode(*want))
    assert _bitwise(SqliteStore._decode(*got), row)


@pytest.mark.parametrize("fault_seed", [0, 1])
def test_fault_schedule_bit_for_bit_the_reference(fault_seed):
    assert FAULT_SITES == R_faults.FAULT_SITES
    rates = {s: 0.3 for s in FAULT_SITES}
    at = {"tcp_drop": (0, 5), "sqlite_lock": (2,)}
    ours = FaultInjector(seed=fault_seed, rates=rates, at=at)
    ref = R_faults.FaultInjector(seed=fault_seed, rates=rates, at=at)
    for i in range(64):
        for s in FAULT_SITES[(i % 3):]:
            assert ours.should_fire(s) == ref.should_fire(s), (s, i)
    assert ours.calls() == ref.calls()
    assert ours.fired() == ref.fired()
    for s in FAULT_SITES:
        for n in range(32):
            assert P_faults._u01(fault_seed, s, n) == \
                R_faults._u01(fault_seed, s, n)


def test_context_digest_keeps_framework_and_device_apart(tmp_path):
    """A port engine's rows never serve the reference, nor the port on
    another device, even through one sqlite file."""
    from repro.core.dse.api import context_digest as r_digest
    from repro_torch.core.calibrate.asap7 import DEFAULT_CALIB
    args = (WLS, DEFAULT_CALIB, False, True, "exact", "aggregate")
    cpu = context_digest(*args, "cpu")
    assert cpu != context_digest(*args, "cuda")
    from repro.core.calibrate.asap7 import DEFAULT_CALIB as R_CALIB
    assert cpu != r_digest(WLS, R_CALIB, False, True, "exact", "aggregate")
    path = str(tmp_path / "r.sqlite")
    a = SqliteStore(path).bind(cpu)
    b = SqliteStore(path).bind(context_digest(*args, "cuda"))
    a.put(b"latency:k", _row(1))
    assert a.peek(b"latency:k") and not b.peek(b"latency:k")
    a.close()
    b.close()


# -------------------------------------------------- the reference's cases

def test_memory_lru_recency_and_eviction():
    st = MemoryLRUStore(max_entries=3)
    rows = {bytes([i]): _row(i) for i in range(4)}
    for k in list(rows)[:3]:
        st.put(k, rows[k])
    assert len(st) == 3
    assert st.get(b"\x00") is not None        # refresh: 0 is now newest
    st.put(b"\x03", rows[b"\x03"])            # evicts 1 (oldest), not 0
    assert st.peek(b"\x00") and not st.peek(b"\x01")
    assert st.stats.evictions == 1
    gets = st.stats.gets
    st.peek(b"\x00")
    assert st.stats.gets == gets
    st.put(b"\x00", _row(99))                 # put-if-absent
    assert _bitwise(st.get(b"\x00"), rows[b"\x00"])


def test_sqlite_round_trip_bitwise(tmp_path):
    path = str(tmp_path / "r.sqlite")
    st = SqliteStore(path).bind(b"ctx")
    rows = {f"k{i}".encode(): _row(i) for i in range(8)}
    for k, r in rows.items():
        st.put(k, r)
    st.close()
    st2 = SqliteStore(path).bind(b"ctx")
    assert len(st2) == len(rows)
    for k, r in rows.items():
        assert st2.peek(k)
        assert _bitwise(st2.get(k), r)
    assert st2.stats.hit_rate() == 1.0
    st2.close()


def test_sqlite_reads_the_references_file(tmp_path):
    """The on-disk layout is the reference's: a row the reference wrote
    under a context is served bit for bit by the port under that same
    context (and the address is the same 32-byte digest)."""
    path = str(tmp_path / "r.sqlite")
    ref = R_store.SqliteStore(path).bind(b"ctx")
    ref.put(b"k", _row(5))
    ours = SqliteStore(path).bind(b"ctx")
    assert ours._addr(b"k") == ref._addr(b"k")
    assert _bitwise(ours.get(b"k"), _row(5))
    ref.close()
    ours.close()


def test_sqlite_context_partitions_the_file(tmp_path):
    path = str(tmp_path / "r.sqlite")
    a = SqliteStore(path).bind(b"engine-A")
    b = SqliteStore(path).bind(b"engine-B")
    a.put(b"k", _row(1))
    assert a.peek(b"k") and not b.peek(b"k")
    b.put(b"k", _row(2))
    assert _bitwise(a.get(b"k"), _row(1))
    assert _bitwise(b.get(b"k"), _row(2))
    with pytest.raises(ValueError):
        a.bind(b"engine-C")                   # one instance, one context
    a.close()
    b.close()


def test_sqlite_concurrent_writers(tmp_path):
    path = str(tmp_path / "r.sqlite")
    rows = {f"k{i}".encode(): _row(i) for i in range(32)}
    stores = [SqliteStore(path).bind(b"ctx") for _ in range(4)]
    errs = []

    def hammer(st):
        try:
            for k, r in rows.items():
                st.put(k, r)
                got = st.get(k)
                assert got is not None and _bitwise(got, rows[k])
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=hammer, args=(s,))
               for s in stores for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(stores[0]) == len(rows)        # first-write-wins, no dupes
    for k, r in rows.items():
        assert _bitwise(stores[0].get(k), r)
    for s in stores:
        s.close()


def test_cost_model_version_invalidates(tmp_path):
    path = str(tmp_path / "r.sqlite")
    old = SqliteStore(path, version="0.test").bind(b"ctx")
    old.put(b"k", _row(1))
    new = SqliteStore(path, version="1.test").bind(b"ctx")
    assert not new.peek(b"k") and new.get(b"k") is None
    new.put(b"k", _row(2))
    assert _bitwise(new.get(b"k"), _row(2))
    assert new.version_counts() == {"0.test": 1, "1.test": 1}
    assert new.purge_stale() == 1
    assert new.version_counts() == {"1.test": 1}
    assert not old.peek(b"k")
    old.close()
    new.close()
    assert SqliteStore(path).version == COST_MODEL_VERSION


def test_tiered_layering_and_promotion(tmp_path):
    front = MemoryLRUStore(max_entries=2)
    back = SqliteStore(str(tmp_path / "r.sqlite"))
    st = TieredStore(front, back).bind(b"ctx")
    rows = {bytes([i]): _row(i) for i in range(5)}
    for k, r in rows.items():
        st.put(k, r)                          # write-through
    assert len(front) == 2 and len(back) == 5 and len(st) == 5
    assert not front.peek(b"\x00") and st.peek(b"\x00")
    hits_back = back.stats.hits
    assert _bitwise(st.get(b"\x00"), rows[b"\x00"])
    assert back.stats.hits == hits_back + 1
    assert front.peek(b"\x00")                # promoted
    assert _bitwise(st.get(b"\x00"), rows[b"\x00"])
    assert back.stats.hits == hits_back + 1   # second get: front only
    assert st.stats.hit_rate() == 1.0
    assert st.lru_dict() is front.data
    st.close()


def test_sqlite_close_is_idempotent_and_checkpoints_wal(tmp_path):
    path = str(tmp_path / "r.sqlite")
    st = SqliteStore(path).bind(b"ctx")
    for i in range(8):
        st.put(f"k{i}".encode(), _row(i))
    assert os.path.exists(path + "-wal")      # WAL mode is active
    st.close()
    st.close()                                # second close: no-op
    assert os.path.getsize(path + "-wal") == 0 \
        if os.path.exists(path + "-wal") else True
    st2 = SqliteStore(path).bind(b"ctx")
    assert len(st2) == 8
    assert _bitwise(st2.get(b"k3"), _row(3))
    st2.close()


class _DeadBack:
    """A back tier whose every data op fails."""

    def __init__(self):
        self.stats = StoreStats()

    def bind(self, context):
        return self

    def get(self, key):
        raise OSError("disk on fire")

    def put(self, key, row):
        raise OSError("disk on fire")

    def peek(self, key):
        raise OSError("disk on fire")

    def __len__(self):
        raise OSError("disk on fire")

    def close(self):
        raise OSError("disk on fire")


def test_tiered_survives_back_tier_failure_lru_only():
    st = TieredStore(MemoryLRUStore(), _DeadBack()).bind(b"ctx")
    rows = {bytes([i]): _row(i) for i in range(3)}
    with pytest.warns(RuntimeWarning, match="LRU-only"):
        for k, r in rows.items():
            st.put(k, r)                      # warned once, not thrice
    for k, r in rows.items():
        assert _bitwise(st.get(k), r)
    assert st.peek(b"\x00")
    assert len(st) == 3
    assert st.stats.errors >= 3
    st.close()                                # dead back close absorbed


def test_tiered_back_tier_recovery_resumes_writes(tmp_path):
    sql = SqliteStore(str(tmp_path / "r.sqlite"))
    inj = FaultInjector(seed=0, at={"store_put": (0, 1)})
    st = TieredStore(MemoryLRUStore(), FaultyStore(sql, inj)).bind(b"ctx")
    rows = {bytes([i]): _row(i) for i in range(4)}
    with pytest.warns(RuntimeWarning, match="LRU-only"):
        st.put(b"\x00", rows[b"\x00"])
        st.put(b"\x01", rows[b"\x01"])
    errs = st.stats.errors
    assert errs == 2
    assert not sql.peek(b"\x00") and not sql.peek(b"\x01")
    st.put(b"\x02", rows[b"\x02"])
    st.put(b"\x03", rows[b"\x03"])
    assert st.stats.errors == errs
    assert sql.peek(b"\x02") and sql.peek(b"\x03")
    assert _bitwise(st.get(b"\x00"), rows[b"\x00"])
    st.put(b"\x00", rows[b"\x00"])
    assert sql.peek(b"\x00")
    assert st.stats.errors == errs
    st.close()


def test_injector_exact_schedule_counters_and_thread_safety():
    inj = FaultInjector(seed=0, at={"sqlite_lock": (0, 2)})
    fires = [inj.should_fire("sqlite_lock") for _ in range(4)]
    assert fires == [True, False, True, False]
    assert inj.calls()["sqlite_lock"] == 4
    assert inj.fired()["sqlite_lock"] == 2
    with pytest.raises(ValueError):
        FaultInjector(rates={"bogus_site": 1.0})
    inj = FaultInjector(seed=1, rates={"store_get": 0.5})
    hits = []

    def spin():
        hits.append(sum(inj.should_fire("store_get") for _ in range(200)))

    ts = [threading.Thread(target=spin) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert inj.calls()["store_get"] == 800
    assert inj.fired()["store_get"] == sum(hits)


def test_sqlite_lock_retry_and_exhaustion(tmp_path):
    inj = FaultInjector(seed=0, at={"sqlite_lock": (0, 1)})
    st = SqliteStore(str(tmp_path / "a.sqlite"),
                     fault_injector=inj).bind(b"ctx")
    row = (np.arange(3.0), np.arange(3.0) * 2, np.arange(3.0) * 3)
    st.put(b"k", row)           # retried through two injected locks
    assert _bitwise(st.get(b"k"), row)
    assert inj.fired()["sqlite_lock"] >= 2
    st.close()
    inj = FaultInjector(seed=0, rates={"sqlite_lock": 1.0})
    st = SqliteStore(str(tmp_path / "b.sqlite"), lock_retries=3,
                     fault_injector=inj).bind(b"ctx")
    with pytest.raises(sqlite3.OperationalError):
        st.put(b"k", (np.zeros(1), np.zeros(1), np.zeros(1)))


def test_tiered_degrades_to_lru_only_under_back_faults(tmp_path):
    inj = FaultInjector(seed=0, rates={"store_get": 1.0, "store_put": 1.0})
    back = FaultyStore(SqliteStore(str(tmp_path / "r.sqlite")), inj)
    st = TieredStore(MemoryLRUStore(), back).bind(b"ctx")
    row = (np.arange(3.0), np.arange(3.0) * 2, np.arange(3.0) * 3)
    with pytest.warns(RuntimeWarning, match="LRU-only"):
        st.put(b"k", row)
    st.put(b"k2", row)          # second failure: counted, not re-warned
    assert _bitwise(st.get(b"k"), row)
    assert st.stats.errors >= 2
    assert st.peek(b"k")


# --------------------------------------------------------------- the engine

@pytest.fixture(scope="module")
def clean():
    """The exact engine's rows for the genomes the engine cases share."""
    g = _genomes(8)
    return g, _engine().evaluate(g)


def test_engine_store_served_results_bitwise(tmp_path, clean):
    g, fresh = clean
    path = str(tmp_path / "r.sqlite")
    cold = _engine(store=TieredStore(MemoryLRUStore(), SqliteStore(path)))
    first = cold.evaluate(g)
    assert first["meta"]["dispatches"] >= 1
    warm = _engine(store=TieredStore(MemoryLRUStore(), SqliteStore(path)))
    served = warm.evaluate(g)
    assert served["meta"]["dispatches"] == 0
    assert served["meta"]["hit_rate"] == 1.0
    for k in KEYS:
        assert fresh[k].tobytes() == served[k].tobytes(), k
    other = EvalEngine(["resnet50_int8"], config=EngineConfig(
        backend="exact", store=TieredStore(MemoryLRUStore(),
                                           SqliteStore(path))), device="cpu")
    assert other.evaluate(g[:2])["meta"]["dispatches"] >= 1


@pytest.mark.parametrize("fault_seed", [0, 1])
def test_engine_results_bitwise_under_store_chaos(tmp_path, clean,
                                                  fault_seed):
    g, want = clean
    inj = FaultInjector(seed=fault_seed, rates={"store_get": 0.4,
                                                "store_put": 0.4})
    back = FaultyStore(SqliteStore(str(tmp_path / "r.sqlite")), inj)
    eng = _engine(store=TieredStore(MemoryLRUStore(), back))
    with pytest.warns(RuntimeWarning):
        chaotic = eng.evaluate(g)
        again = eng.evaluate(g)
    for k in KEYS:
        assert want[k].tobytes() == chaotic[k].tobytes(), k
        assert want[k].tobytes() == again[k].tobytes(), k


def test_injected_engine_exception_and_nan_retry_bitwise(clean):
    g, want = clean
    eng = inject_engine_faults(_engine(),
                               FaultInjector(at={"engine_exc": (0,)}))
    with pytest.raises(InjectedEngineError) as ei:
        eng.evaluate(g)
    assert ei.value.retryable
    retried = eng.evaluate(g)   # nothing memoized from the failed try
    eng = inject_engine_faults(_engine(),
                               FaultInjector(at={"nan_metrics": (0,)}))
    with pytest.raises(NonFiniteMetricsError) as ni:
        eng.evaluate(g)
    assert ni.value.retryable and ni.value.canon.shape == (GENOME_LEN,)
    again = eng.evaluate(g)
    for k in KEYS:
        assert want[k].tobytes() == retried[k].tobytes(), k
        assert want[k].tobytes() == again[k].tobytes(), k


@pytest.mark.parametrize("batch", [3, 1024])
def test_score_batch_is_evaluates_rows(clean, batch):
    g, want = clean
    eng = _engine(batch=batch)
    got = eng.score_batch(g)
    assert set(got) == set(KEYS)
    for k in KEYS:
        assert got[k].tobytes() == want[k].tobytes(), k
    assert eng.stats.requests == 0 and len(eng.store) == 0
    assert eng.stats.dispatches == -(-len(g) // batch)
    with pytest.raises(ValueError):
        eng.score_batch(g, mode="bogus")


def test_export_import_memo_round_trip(clean):
    g, want = clean
    eng = _engine()
    eng.evaluate(g)
    canon, rows = eng.export_memo()
    assert canon.shape == (len(g), GENOME_LEN) and rows.shape == (len(g), 3,
                                                                  1)
    assert np.array_equal(canon, canonical_genomes(g))
    assert rows[:, 0].tobytes() == want["latency"].tobytes()
    assert eng.export_memo() is eng.export_memo()   # stamp-cached view
    assert eng.export_memo("throughput")[0].shape == (0, GENOME_LEN)
    cold = _engine()
    assert cold.import_memo(canon, rows) == len(g)
    served = cold.evaluate(g)
    assert served["meta"]["hits"] == len(g) and served["meta"]["misses"] == 0
    for k in KEYS:
        assert served[k].tobytes() == want[k].tobytes(), k
    with pytest.raises(ValueError):
        cold.import_memo(canon, rows[:, :2])


def test_memo_max_caps_a_tiered_front(tmp_path):
    st = TieredStore(MemoryLRUStore(), SqliteStore(str(tmp_path / "r.db")))
    eng = _engine(store=st, memo_max=2048)
    assert st.front.max_entries == 2048 and eng.store is st
    with pytest.raises(ValueError, match="LRU tier"):
        _engine(store=SqliteStore(str(tmp_path / "s.db")), memo_max=2048)
