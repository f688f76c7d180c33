"""PyTorch port, the engine API (A11, second half): ``EngineConfig`` as
the one knob surface, the ``Evaluator`` conformance suite over every
scoring surface of the port (the local ``EvalEngine``, an in-process
``DSEClient``, a TCP ``DSEClient`` and a ``DSECluster``), each held
byte for byte against the port's local engine on the same genomes (the
service file holds that engine against the JAX package's), the
legacy-kwarg deprecation shim, the ``result["meta"]`` schema stamp, and
the device type in the context digest, which keeps the port's digest
apart from the reference's."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dse.api import EngineConfig as R_EngineConfig  # noqa: E402
from repro_torch.core.calibrate.asap7 import DEFAULT_CALIB  # noqa: E402
from repro_torch.core.dse.api import (BACKENDS, META_VERSION,  # noqa: E402
                                      EngineConfig, Evaluator,
                                      context_digest)
from repro_torch.core.dse.encoding import random_genomes  # noqa: E402
from repro_torch.core.dse.engine import EvalEngine  # noqa: E402
from repro_torch.core.dse.pipeline import run_pipeline  # noqa: E402
from repro_torch.serve.cluster import DSECluster  # noqa: E402
from repro_torch.serve.dse_service import DSEClient, DSEService  # noqa: E402

WLS = ["kan"]
METRICS = ("latency", "energy", "tops_w", "area")
EXACT = EngineConfig(backend="exact")


def _engine(config=EXACT, **kw):
    return EvalEngine(WLS, config=config, device="cpu", **kw)


def _service(worker_id=None):
    return DSEService(_engine(), max_batch=64, max_wait_ms=20.0,
                      worker_id=worker_id).start()


@pytest.fixture(scope="module")
def service():
    svc = _service()
    yield svc
    svc.stop()


@pytest.fixture(scope="module", params=["engine", "client", "tcp",
                                        "cluster"])
def evaluator(request, service):
    """One fixture per scoring surface; each must satisfy the full
    ``Evaluator`` contract below."""
    if request.param == "engine":
        yield _engine()
        return
    if request.param == "client":
        cl = DSEClient(service=service)
        yield cl
        cl.close()
        return
    if request.param == "cluster":
        svcs = [_service(f"api-w{i}") for i in range(3)]
        cl = DSECluster(svcs)
        yield cl
        cl.close()
        for svc in svcs:
            svc.stop()
        return
    host, port = service.listen()
    cl = DSEClient(address=(host, port), timeout=60.0)
    yield cl
    cl.close()


def _genomes(n=8, seed=11):
    return random_genomes(np.random.default_rng(seed), n)


# =============================================================================
# Evaluator protocol conformance (shared across all four surfaces)
# =============================================================================

def test_satisfies_protocol(evaluator):
    assert isinstance(evaluator, Evaluator)
    assert list(evaluator.workloads) == WLS
    assert evaluator.stats is not None
    assert not hasattr(evaluator, "device") or \
        isinstance(evaluator, EvalEngine)


def test_evaluate_contract(evaluator):
    g = _genomes()
    res = evaluator.evaluate(g)
    for k in ("latency", "energy", "tops_w"):
        assert res[k].shape == (len(g), len(WLS)), k
        assert res[k].dtype == np.float64, k
    assert res["area"].shape == (len(g),)
    meta = res["meta"]
    assert meta["meta_version"] == META_VERSION
    assert meta["backend"] in BACKENDS
    assert meta["fidelity"] in ("aggregate", "link")
    assert meta["mode"] in ("latency", "throughput")
    assert meta["requests"] == len(g)
    want = _engine().evaluate(g)
    for k in METRICS:
        assert res[k].tobytes() == want[k].tobytes(), k


def test_rescore_contract(evaluator):
    g = _genomes(4)
    res = evaluator.rescore(g)
    for k in METRICS:
        assert k in res
    assert res["meta"]["meta_version"] == META_VERSION
    assert res["meta"]["fidelity"] in ("aggregate", "link")
    want = _engine().rescore(g)
    for k in METRICS:
        assert res[k].tobytes() == want[k].tobytes(), k


def test_score_batch_matches_evaluate(evaluator):
    g = _genomes(6, seed=12)
    ref = evaluator.evaluate(g)
    got = evaluator.score_batch(g)
    assert set(got) == set(METRICS)   # metrics only, no meta
    for k in METRICS:
        assert got[k].tobytes() == ref[k].tobytes(), k


def test_context_key_matches_local_engine(evaluator):
    key = evaluator.context_key()
    assert isinstance(key, bytes) and len(key) == 32
    assert key == _engine().context_key()


# =============================================================================
# EngineConfig: validation, digest coverage, immutability
# =============================================================================

def test_config_is_frozen_and_comparable():
    a, b = EngineConfig(backend="exact"), EngineConfig(backend="exact")
    assert a == b
    assert a != EngineConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.backend = "scan"
    # store is wiring, not identity: excluded from equality and repr
    assert EngineConfig(store=object()) == EngineConfig()
    assert "store" not in repr(EngineConfig())


@pytest.mark.parametrize("kw", [
    {"backend": "cuda"},
    {"mode": "speed"},
    {"fidelity": "cycle"},
    {"exact_mapper": "rust"},
    {"nonfinite": "ignore"},
    {"batch": 0},
    {"backend": "exact", "exact_mapper": "python"},
])
def test_config_rejects_invalid_knobs(kw):
    with pytest.raises(ValueError):
        EngineConfig(**kw)


def test_every_metric_knob_lands_in_the_digest():
    """All knobs flow through EngineConfig's context digest -- fidelity,
    the compile flags and the device type change it, the exact-family
    backends share one digest class, scan gets its own -- and the port's
    digest never equals the reference's (it adds the framework)."""
    def digest(device="cpu", **kw):
        return EngineConfig(**kw).context_digest(WLS, DEFAULT_CALIB, device)

    base = digest()
    assert digest(fidelity="link") != base
    assert digest(aggressive_int4=True) != base
    assert digest(enable_fusion=False) != base
    assert digest("cuda") != base
    assert digest(torch.device("cpu")) == base
    exact = digest(backend="exact")
    assert exact != base                     # scan maps approximately
    for b in ("batched", "oracle"):
        assert digest(backend=b) == exact    # one exact mapping class
    # non-metric knobs (batch size, memo sizing, store) don't invalidate
    assert digest(batch=7, memo_max=9, memoize=False) == base
    assert context_digest(WLS, DEFAULT_CALIB, False, True, "scan",
                          "aggregate", "cpu") == base
    assert base != R_EngineConfig().context_digest(WLS, DEFAULT_CALIB)


def test_engine_context_key_delegates_to_config():
    cfg = EngineConfig(backend="exact", fidelity="link")
    eng = _engine(cfg)
    assert eng.context_key() == cfg.context_digest(WLS, DEFAULT_CALIB,
                                                   "cpu")
    assert eng.config == cfg
    assert eng.fidelity == "link"


# =============================================================================
# legacy-kwarg deprecation shim
# =============================================================================

def test_config_path_emits_no_warnings():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _engine()


def test_legacy_kwargs_warn_and_still_work():
    with pytest.warns(DeprecationWarning, match=r"backend.*nonfinite") as rec:
        eng = EvalEngine(WLS, device="cpu", backend="exact",
                         nonfinite="skip")
    assert len(rec) == 1                     # one warning per call
    assert eng.config == EngineConfig(backend="exact", nonfinite="skip")
    assert eng.backend == "exact"
    g = _genomes(3, seed=13)
    want = _engine(EngineConfig(backend="exact",
                                nonfinite="skip")).evaluate(g)
    got = eng.evaluate(g)
    for k in METRICS:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_memo_limit_warns_specifically():
    # two warnings fire: the specific memo_limit-alias one, then the
    # aggregated legacy-kwargs one for the memo_max it maps to
    with pytest.warns(DeprecationWarning) as rec:
        eng = EvalEngine(WLS, device="cpu", memo_limit=2048)
    assert any("memo_limit" in str(w.message) for w in rec)
    assert eng.config.memo_max == 2048
    with pytest.raises(ValueError, match="memo_limit"):
        with pytest.warns(DeprecationWarning):
            EvalEngine(WLS, device="cpu", memo_limit=2048, memo_max=4096)


@pytest.mark.parametrize("legacy", [{"backend": "exact"}, {"shard": False}])
def test_config_plus_legacy_kwargs_is_an_error(legacy):
    with pytest.raises(ValueError, match="config"):
        EvalEngine(WLS, config=EngineConfig(), device="cpu", **legacy)


def test_legacy_kwargs_are_keyword_only_and_shard_still_refused():
    with pytest.raises(TypeError):
        EvalEngine(WLS, DEFAULT_CALIB, None, "cpu", 64)
    # shard=True is served now: through the deprecated keyword it warns
    # and builds the sharded config, which on one device keeps the
    # one-device path
    with pytest.warns(DeprecationWarning):
        eng = EvalEngine(WLS, device="cpu", shard=True)
    assert eng.config.shard and eng._devices is None


# =============================================================================
# the device type in the context: mixed memberships are refused
# =============================================================================

def test_cluster_and_pipeline_refuse_another_device_type():
    """A worker whose engine reports another device type serves another
    context: the cluster refuses it at construction, and run_pipeline
    refuses a cluster whose workers' device type differs from the local
    engine's.  (The engine's device is only read for the digest here, so
    a CPU engine stands in for a card one.)"""
    cpu, other = _service("cpu-w"), _service("other-w")
    other.engine.device = torch.device("cuda")
    try:
        with pytest.raises(ValueError, match="device type"):
            DSECluster([cpu, other])
        cl = DSECluster([other])
        try:
            with pytest.raises(ValueError, match="device type"):
                run_pipeline(WLS, seeds=(0,), brackets=(100.0,),
                             samples_per_stratum=1, engine=_engine(),
                             cluster=cl)
        finally:
            cl.close()
    finally:
        cpu.stop()
        other.stop()
