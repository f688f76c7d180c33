"""PyTorch port, the scan backend (A8): ``batch_eval.batch_evaluate`` (the
approximate in-scan mapping, ported as the same approximation) within rel
1e-9 of the JAX package's on the same candidates, in both fidelity tiers,
with equal inf/finite patterns; ``EvalEngine(backend="scan")`` against the
reference's scan engine in both modes; ``rescore`` on a scan engine through
the exact path; the scan's own store context; the scan-path helpers of
``dse.sweep``; and the reference's own error band of the scan against the
port's oracle (tests/test_batch_eval.py)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.dse import api as R_api  # noqa: E402
from repro.core.dse import batch_eval as R_be  # noqa: E402
from repro.core.dse import engine as R_engine  # noqa: E402
from repro.core.dse import sweep as R_sweep  # noqa: E402
from repro_torch.core.arch import (hetero_bl, hetero_bls,  # noqa: E402
                                   homogeneous_baseline)
from repro_torch.core.compiler.mapper import UnmappableError  # noqa: E402
from repro_torch.core.compiler.pipeline import compile_workload  # noqa: E402
from repro_torch.core.dse import api as P_api  # noqa: E402
from repro_torch.core.dse import batch_eval as P_be  # noqa: E402
from repro_torch.core.dse import engine as P_engine  # noqa: E402
from repro_torch.core.dse import sweep as P_sweep  # noqa: E402
from repro_torch.core.dse.encoding import decode, random_genomes  # noqa: E402
from repro_torch.core.dse.store import MemoryLRUStore  # noqa: E402
from repro_torch.core.simulator.orchestrator import simulate  # noqa: E402
from repro_torch.core.workloads import build  # noqa: E402

WORKLOADS = ["kan", "snn_vgg9", "gnn_gat"]
MODES = ["latency", "throughput"]
REL_TOL = 1e-9
_COLS = ("latency", "energy", "tops_w")

# (workload, tier): the engine's workloads in both tiers, and resnet50_int8
# (whose MAC ops split) in the aggregate tier
_CASES = [(w, f) for w in WORKLOADS for f in ("aggregate", "link")] \
    + [("resnet50_int8", "aggregate")]


@pytest.fixture(scope="module")
def genomes():
    return random_genomes(np.random.default_rng(2026), 16)


@pytest.fixture(scope="module")
def cfgs(genomes):
    chips = [decode(g, f"g{i}") for i, g in enumerate(genomes)]
    chips += [homogeneous_baseline(4), hetero_bl(), hetero_bls()]
    return P_be.prepare_configs(chips)


def _close(got, want, what):
    """Equal inf/finite patterns (and equal non-finite values), finite
    values within rel REL_TOL."""
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)), what
    assert np.array_equal(got[~fin], want[~fin]), what
    err = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]),
                                                    1e-300)
    assert err.max(initial=0.0) <= REL_TOL, (what, err.max())


@pytest.mark.parametrize("wname,fidelity", _CASES)
def test_batch_evaluate_matches_reference(cfgs, wname, fidelity):
    ws = P_engine.prepared_workload(wname)
    got = P_be.batch_evaluate(ws, cfgs, fidelity=fidelity, device="cpu")
    want = R_be.batch_evaluate(R_engine.prepared_workload(wname), cfgs,
                               fidelity=fidelity)
    assert set(got) == set(want)
    for k in P_be.SCAN_KEYS:
        _close(got[k], want[k], (wname, fidelity, k))
    for k in ("area_mm2", "peak_tops"):
        assert np.array_equal(got[k], want[k]), k
    assert np.isfinite(got["latency_s"]).all()
    with pytest.raises(ValueError, match="fidelity"):
        P_be.batch_evaluate(ws, cfgs, fidelity="cycle", device="cpu")


def _port(mode, **kw):
    return P_engine.EvalEngine(
        WORKLOADS, config=P_api.EngineConfig(mode=mode, **kw), device="cpu")


@pytest.fixture(scope="module")
def reference_scan(genomes):
    """The JAX package's scan engine (its default config), both modes."""
    return {m: R_engine.EvalEngine(WORKLOADS, config=R_api.EngineConfig(
        mode=m)).evaluate(genomes) for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_scan_engine_matches_reference(genomes, reference_scan, mode):
    eng = _port(mode)
    assert eng.backend == "scan" and eng.fidelity == "aggregate"
    got, want = eng.evaluate(genomes), reference_scan[mode]
    for k in _COLS:
        _close(got[k], want[k], (mode, k))
    assert np.array_equal(got["area"], want["area"])
    assert got["meta"] == want["meta"]
    again = eng.evaluate(genomes)
    assert again["meta"]["hits"] == len(genomes)
    for k in _COLS:
        assert np.array_equal(again[k], got[k]), k


def test_rescore_on_scan_engine_is_the_exact_engine(genomes):
    """``rescore`` bypasses the scan: bit for bit the port's exact engine
    (and differs from the scan's approximation somewhere)."""
    scan = _port("throughput")
    res = scan.rescore(genomes)
    exact = _port("throughput", backend="exact").evaluate(genomes)
    for k in _COLS + ("area",):
        assert np.array_equal(res[k], exact[k]), k
    assert (res["meta"]["backend"], res["meta"]["mapper"]) == \
        ("batched", "batched")
    approx = scan.evaluate(genomes)
    assert any(not np.array_equal(approx[k], exact[k]) for k in _COLS)
    assert len(scan.store) == len(genomes)     # rescore memoized nothing


def test_scan_and_exact_engines_never_share_store_rows(genomes):
    scan, exact = _port("latency"), _port("latency", backend="exact")
    assert scan.context_key() != exact.context_key()
    store = MemoryLRUStore()
    _port("latency", store=store).evaluate(genomes)
    with pytest.raises(ValueError, match="context"):
        _port("latency", backend="exact", store=store)
    with pytest.raises(ValueError, match="context"):
        _port("latency", backend="batched", store=store)
    # a second scan engine serves the first one's rows
    hit = _port("latency", store=store).evaluate(genomes)
    assert hit["meta"]["hits"] == len(genomes)


def test_evaluate_genomes_and_reference_loop_match_reference(genomes):
    g = genomes[:8]
    got = P_sweep.evaluate_genomes(g, WORKLOADS, batch=4, device="cpu")
    want = R_sweep.evaluate_genomes(g, WORKLOADS, batch=4)
    got_ref = P_sweep.evaluate_genomes_reference(g, WORKLOADS, batch=4,
                                                 device="cpu")
    want_ref = R_sweep.evaluate_genomes_reference(g, WORKLOADS, batch=4)
    assert got["meta"]["dispatches"] == 2 and got["meta"]["backend"] == "scan"
    for a, b in ((got, want), (got_ref, want_ref), (got_ref, got)):
        for k in _COLS:
            _close(a[k], b[k], k)
    # the decode stack's areas (the vectorized engine's may differ in the
    # last bit, ROADMAP C)
    assert np.array_equal(got_ref["area"], want_ref["area"])


@pytest.mark.parametrize("seed", [0, 1])
def test_run_sweep_default_matches_reference(seed):
    got = P_sweep.run_sweep(WORKLOADS, samples_per_stratum=1, seed=seed,
                            device="cpu")
    want = R_sweep.run_sweep(WORKLOADS, samples_per_stratum=1, seed=seed)
    assert np.array_equal(got.genomes, want.genomes)
    assert np.array_equal(got.family, want.family)
    assert np.array_equal(got.bracket, want.bracket)
    assert np.array_equal(got.area, want.area)
    for k in ("latency", "energy", "tops_w"):
        _close(getattr(got, k), getattr(want, k), k)


def _band_chips(n=12, seed=3):
    rng = np.random.default_rng(seed)
    return [homogeneous_baseline(4), hetero_bl(), hetero_bls()] + \
        [decode(g, f"d{i}") for i, g in enumerate(random_genomes(rng, n))]


@pytest.mark.parametrize("wname", WORKLOADS)
def test_scan_within_reference_band_of_oracle(wname):
    """The reference's own hold of the scan against its oracle
    (tests/test_batch_eval.py::test_batch_matches_reference), here the
    port's scan against the port's oracle: median relative error below
    1e-9, every error below 0.10."""
    chips = _band_chips()
    g = build(wname)
    res = P_be.batch_evaluate(P_be.prepare_workload(g),
                              P_be.prepare_configs(chips), device="cpu")
    lat_errs, en_errs = [], []
    for i, chip in enumerate(chips):
        try:
            r = simulate(chip, compile_workload(g, chip))
        except UnmappableError:
            continue
        lat_errs.append(abs(res["latency_s"][i] / r.latency_s - 1))
        en_errs.append(abs(res["energy_pj"][i] / r.energy_pj - 1))
    assert len(lat_errs) >= 8
    assert np.median(lat_errs) < 1e-9
    assert np.median(en_errs) < 1e-9
    assert max(lat_errs) < 0.10
    assert max(en_errs) < 0.10
