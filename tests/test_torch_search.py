"""PyTorch port, the exact search (A6): ``search_population`` and
``search_and_simulate`` equal the port's ``map_and_simulate`` bit for bit
on every mappable candidate, in both schedule modes; ``EvalEngine(
backend="exact")`` equals the port's batched engine bit for bit and the
JAX package's exact engine within rel 1e-9, and keeps the engine's
contract (rescore, a store shared with a batched engine, the workload
guard, reserve_shapes / warmup, the refusals)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.dse import api as R_api  # noqa: E402
from repro.core.dse import engine as R_engine  # noqa: E402
from repro_torch.core.compiler import batched_mapper as P_bm  # noqa: E402
from repro_torch.core.dse import api as P_api  # noqa: E402
from repro_torch.core.dse import engine as P_engine  # noqa: E402
from repro_torch.core.dse.encoding import random_genomes  # noqa: E402
from repro_torch.core.dse.store import MemoryLRUStore  # noqa: E402

WORKLOADS = ["kan", "snn_vgg9", "gnn_gat"]
MODES = ["latency", "throughput"]
REL_TOL = 1e-9


@pytest.fixture(scope="module")
def genomes():
    return random_genomes(np.random.default_rng(77), 16)


@pytest.fixture(scope="module")
def cfgs(genomes):
    return P_engine.genomes_to_configs(genomes)


def _engine(backend="exact", mode="latency", **kw):
    return P_engine.EvalEngine(
        WORKLOADS, config=P_api.EngineConfig(backend=backend, mode=mode,
                                             **kw), device="cpu")


def _assert_equal(got, want, what):
    for k in ("latency", "energy", "tops_w", "area"):
        assert np.array_equal(got[k], want[k]), (what, k)


@pytest.mark.parametrize("mode", MODES)
def test_search_population_equals_map_and_simulate(cfgs, mode):
    ws_list = [P_engine.prepared_workload(w) for w in WORKLOADS]
    found = P_bm.search_population(ws_list, cfgs, mode=mode, device="cpu")
    assert len(found) == len(WORKLOADS)
    for w, ws, got in zip(WORKLOADS, ws_list, found):
        want = P_bm.map_and_simulate(ws, cfgs, mode=mode, device="cpu",
                                     placements=False)
        one = P_bm.search_and_simulate(ws, cfgs, mode=mode, device="cpu")
        ok = want["ok"]
        assert ok.any(), w
        for res in (got, one):
            assert np.array_equal(res["ok"], ok), w
            assert res["mode"] == mode
            for k in P_bm.SEARCH_KEYS:
                assert np.array_equal(res[k][ok], want[k][ok]), (w, k)
            for k in ("area_mm2", "peak_tops"):
                assert np.array_equal(res[k], want[k]), (w, k)


def test_search_surface_and_out_keys(cfgs):
    ws = P_engine.prepared_workload("kan")
    whole = P_bm.search_and_simulate(ws, cfgs, device="cpu")
    assert set(whole) == set(P_bm.SEARCH_KEYS) | {"ok", "area_mm2",
                                                 "peak_tops", "mode"}
    assert all(whole[k].shape == (len(cfgs["chip"]["chip_area"]),)
               for k in P_bm.SEARCH_KEYS)
    keys = ("ii_s", "energy_ss_pj", "achieved_tops_ss")
    lean = P_bm.search_population([ws], cfgs, mode="throughput",
                                  out_keys=keys, device="cpu")[0]
    assert set(lean) == set(keys) | {"ok", "area_mm2", "peak_tops", "mode"}
    for k in keys + ("ok",):
        assert np.array_equal(lean[k], whole[k]), k


@pytest.mark.parametrize("mode", MODES)
def test_exact_engine_equals_batched_engine(genomes, mode):
    got = _engine("exact", mode).evaluate(genomes)
    want = _engine("batched", mode).evaluate(genomes)
    _assert_equal(got, want, mode)
    assert np.isfinite(got["latency"]).all()
    assert got["meta"]["backend"] == "exact"
    assert got["meta"]["dispatches"] == 1


@pytest.fixture(scope="module")
def reference_exact(genomes):
    """The JAX package's exact engine, both modes (one compile)."""
    return {m: R_engine.EvalEngine(WORKLOADS, config=R_api.EngineConfig(
        backend="exact", mode=m)).evaluate(genomes) for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_exact_engine_matches_jax_exact_engine(genomes, reference_exact,
                                               mode):
    got, want = _engine("exact", mode).evaluate(genomes), \
        reference_exact[mode]
    assert np.array_equal(got["area"], want["area"])
    for k in ("latency", "energy", "tops_w"):
        a, b = got[k], want[k]
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), (mode, k)   # ok masks
        assert np.array_equal(a[~fin], b[~fin]), (mode, k)
        err = np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1e-300)
        assert err.max(initial=0.0) <= REL_TOL, (mode, k, err.max())
    for k in ("backend", "mode", "requests", "hits", "misses", "skips"):
        assert got["meta"][k] == want["meta"][k], k


def test_rescore_on_exact_engine_equals_evaluate(genomes):
    eng = _engine("exact", "throughput")
    res = eng.rescore(genomes)
    _assert_equal(res, eng.evaluate(genomes), "rescore")
    assert res["meta"]["backend"] == "batched"
    assert res["meta"]["mapper"] == "batched"
    assert res["meta"]["mode"] == "throughput"


def test_exact_and_batched_engines_share_one_store(genomes):
    """Both backends key their rows alike (``context_digest`` maps both to
    the exact mapping class), so one store serves either; rows computed
    by one are the other's, bit for bit."""
    store = MemoryLRUStore()
    first = _engine("exact", store=store).evaluate(genomes)
    n = len(store)
    assert n == len(genomes)
    second = _engine("batched", store=store).evaluate(genomes)
    assert second["meta"]["hits"] == len(genomes)
    assert second["meta"]["dispatches"] == 0
    _assert_equal(second, first, "shared store")
    # a batched engine's own store holds the same rows
    other = MemoryLRUStore()
    _engine("batched", store=other).evaluate(genomes)
    assert set(other.lru_dict()) == set(store.lru_dict())
    for key, row in other.lru_dict().items():
        for a, b in zip(row, store.lru_dict()[key]):
            assert np.array_equal(a, b)


def test_check_workloads_guards_the_shared_engine():
    from repro_torch.core.calibrate.asap7 import DEFAULT_CALIB
    import dataclasses

    eng = _engine()
    assert eng.check_workloads(list(WORKLOADS)) is eng
    assert eng.check_workloads(WORKLOADS, DEFAULT_CALIB) is eng
    with pytest.raises(ValueError, match="workloads"):
        eng.check_workloads(WORKLOADS[::-1])
    with pytest.raises(ValueError, match="workloads"):
        eng.check_workloads(WORKLOADS[:2])
    other = dataclasses.replace(DEFAULT_CALIB, e_noc_pj_per_byte_hop=
                                DEFAULT_CALIB.e_noc_pj_per_byte_hop * 2)
    with pytest.raises(ValueError, match="calib"):
        eng.check_workloads(WORKLOADS, other)


def test_reserve_shapes_and_warmup_leave_results_unchanged(genomes):
    cold = _engine().evaluate(genomes)
    eng = _engine()
    eng.reserve_shapes(64)
    eng.warmup()
    assert eng.stats.dispatches == 1 and eng.stats.requests == 0
    assert len(eng.store) == 0            # warmup memoizes nothing
    _assert_equal(eng.evaluate(genomes), cold, "after warmup")


def test_search_refusals(cfgs):
    ws = [P_engine.prepared_workload("kan")]
    with pytest.raises(ValueError, match="schedule mode"):
        P_bm.search_population(ws, cfgs, mode="serving", device="cpu")
    with pytest.raises(ValueError, match="fidelity"):
        P_bm.search_and_simulate(ws[0], cfgs, fidelity="exact",
                                 device="cpu")
