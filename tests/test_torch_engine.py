"""PyTorch port, engine: ``EvalEngine(backend="batched")`` on the CPU
scores what the JAX engine scores (latency bitwise, the other columns
within rel 1e-9), ``rescore(oracle=True)`` bit for bit, keeps the memo
and ``meta`` contract, keys its store apart from the reference, runs
every backend x mode x fidelity cell, refuses what is not ported, and
refuses to run without a card unless ``device="cpu"`` is asked for."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dse import api as R_api
from repro.core.dse import engine as R_engine
from repro_torch.core.dse import api as P_api
from repro_torch.core.dse import engine as P_engine
from repro_torch.core.dse.encoding import random_genomes

WORKLOADS = ["kan", "snn_vgg9", "gnn_gat"]
REL_TOL = 1e-9
META_KEYS = {"meta_version", "backend", "mode", "fidelity", "requests",
             "hits", "misses", "skips", "nonfinite", "dispatches",
             "hit_rate"}


def _port(mode="latency", **kw):
    return P_engine.EvalEngine(
        WORKLOADS, config=P_api.EngineConfig(backend="batched", mode=mode,
                                             **kw), device="cpu")


def _ref(mode="latency"):
    return R_engine.EvalEngine(
        WORKLOADS, config=R_api.EngineConfig(backend="batched", mode=mode))


@pytest.fixture(scope="module")
def genomes():
    g = random_genomes(np.random.default_rng(77), 16)
    g[3] = g[0]          # a duplicate inside one call
    return g


def _assert_metrics(got, want, what):
    assert np.array_equal(got["latency"], want["latency"]), what
    assert np.array_equal(got["area"], want["area"]), what
    for k in ("energy", "tops_w"):
        a, b = got[k], want[k]
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), (what, k)
        assert np.array_equal(a[~fin], b[~fin]), (what, k)
        err = np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1e-300)
        assert err.max(initial=0.0) <= REL_TOL, (what, k, err.max())


@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_evaluate_and_rescore_match_jax(genomes, mode):
    port, ref = _port(mode), _ref(mode)
    got, want = port.evaluate(genomes), ref.evaluate(genomes)
    _assert_metrics(got, want, ("evaluate", mode))
    assert np.isfinite(got["latency"]).any()
    assert set(got["meta"]) == set(want["meta"]) == META_KEYS
    for k in ("meta_version", "backend", "mode", "fidelity", "requests",
              "hits", "misses", "skips", "nonfinite"):
        assert got["meta"][k] == want["meta"][k], k
    assert got["meta"]["meta_version"] == P_api.META_VERSION == 1
    _assert_metrics(port.rescore(genomes), ref.rescore(genomes),
                    ("rescore", mode))
    r = port.rescore(genomes)
    assert set(r["meta"]) == set(ref.rescore(genomes[:1])["meta"])


def test_second_call_is_all_hits(genomes):
    port = _port()
    first = port.evaluate(genomes)
    assert first["meta"]["misses"] == len(genomes) - 1   # one duplicate
    again = port.evaluate(genomes)
    assert again["meta"]["hits"] == len(genomes)
    assert again["meta"]["misses"] == 0
    assert again["meta"]["dispatches"] == 0
    for k in ("latency", "energy", "tops_w", "area"):
        assert np.array_equal(again[k], first[k]), k
    # the other schedule mode is keyed apart
    assert port.evaluate(genomes, mode="throughput")["meta"]["hits"] == 1


def test_keep_predicate_skips_and_does_not_memoize(genomes):
    port = _port()
    res = port.evaluate(genomes, keep=lambda a: a < np.median(a))
    skipped = ~(res["area"] < np.median(res["area"]))
    assert res["meta"]["skips"] == int(skipped.sum())
    assert np.isinf(res["latency"][skipped]).all()
    assert port.evaluate(genomes)["meta"]["misses"] > 0


def test_context_key_differs_from_reference():
    port, ref = _port(), _ref()
    assert port.context_key() != ref.context_key()
    assert port.context_key() == _port().context_key()
    assert P_api.context_digest(WORKLOADS, port.calib, False, True,
                                "batched", "aggregate", "cuda") \
        != port.context_key()


@pytest.mark.parametrize("kw", [dict(backend="batched", shard=True)])
def test_unported_configurations_raise(kw, genomes):
    """Every configuration is ported: ``shard=True``, the last one that
    raised, now builds and, on one device, scores bit for bit as the
    unsharded engine."""
    eng = P_engine.EvalEngine(WORKLOADS, config=P_api.EngineConfig(**kw),
                              device="cpu")
    one = P_engine.EvalEngine(WORKLOADS, config=P_api.EngineConfig(
        **dict(kw, shard=False)), device="cpu")
    got, want = eng.evaluate(genomes), one.evaluate(genomes)
    for k in ("latency", "energy", "tops_w", "area"):
        assert np.array_equal(got[k], want[k]), k


_CELLS = [(b, m, f) for b in P_api.BACKENDS
          for m in ("latency", "throughput") for f in ("aggregate", "link")]


@pytest.mark.parametrize("backend,mode,fidelity", _CELLS)
def test_every_backend_mode_fidelity_cell_evaluates(genomes, backend, mode,
                                                    fidelity):
    """README's matrix of backends x modes x fidelity tiers: each cell
    constructs and scores on the CPU, its meta naming it."""
    eng = P_engine.EvalEngine(["kan"], config=P_api.EngineConfig(
        backend=backend, mode=mode, fidelity=fidelity), device="cpu")
    res = eng.evaluate(genomes[:4])
    assert np.isfinite(res["latency"]).all()
    assert (res["energy"] > 0).all() and (res["tops_w"] >= 0).all()
    assert (res["meta"]["backend"], res["meta"]["mode"],
            res["meta"]["fidelity"]) == (backend, mode, fidelity)


def test_rescore_oracle_raises(genomes):
    """``rescore(oracle=True)`` runs (it raised until the oracle was
    ported): the ChipSim walk, bit for bit the reference's in both modes,
    its ``meta`` naming the oracle and the host mapper; it raises only
    for a schedule mode the oracle cannot model."""
    for mode in ("latency", "throughput"):
        got = _port(mode).rescore(genomes[:4], oracle=True)
        want = _ref(mode).rescore(genomes[:4], oracle=True)
        for k in ("latency", "energy", "tops_w", "area"):
            assert np.array_equal(got[k], want[k]), (mode, k)
        assert got["meta"] == want["meta"]
        assert (got["meta"]["backend"], got["meta"]["mapper"]) == \
            ("oracle", "python")
    with pytest.raises(ValueError, match="burst"):
        _port().rescore(genomes[:2], oracle=True, mode="burst")


def test_construction_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P_engine.EvalEngine(WORKLOADS,
                            config=P_api.EngineConfig(backend="batched"))
    # the explicit CPU request still works
    assert _port().device.type == "cpu"


def test_engine_config_matches_reference():
    import dataclasses
    pf = {f.name: f.default for f in dataclasses.fields(P_api.EngineConfig)}
    rf = {f.name: f.default for f in dataclasses.fields(R_api.EngineConfig)}
    assert pf == rf
    assert P_api.BACKENDS == R_api.BACKENDS
    with pytest.raises(ValueError):
        P_api.EngineConfig(backend="nope")
