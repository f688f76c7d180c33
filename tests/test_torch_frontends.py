"""PyTorch port, the search frontends (A9): ``objective`` and ``pareto``
bit for bit against the JAX package's on seeded points with ties and
duplicate rows (``pareto_mask_device`` on the CPU equal to
``pareto_mask``); the host logic of ``run_sweep``, ``run_ga(loop="host")``
and ``run_bayes`` bit for bit against the reference's through one
deterministic stub engine; the sweep and the GA end to end on real exact
engines (genomes equal, metrics within rel 1e-9); the defaults (the scan
engine) on the CPU; and the GA loops that ported with A10: the device
loop on the stub engine, the fused loop refusing it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dse import api as R_api  # noqa: E402
from repro.core.dse import bayes as R_bayes  # noqa: E402
from repro.core.dse import engine as R_engine  # noqa: E402
from repro.core.dse import ga as R_ga  # noqa: E402
from repro.core.dse import objective as R_obj  # noqa: E402
from repro.core.dse import pareto as R_pareto  # noqa: E402
from repro.core.dse import sweep as R_sweep  # noqa: E402
from repro_torch.core.dse import api as P_api  # noqa: E402
from repro_torch.core.dse import bayes as P_bayes  # noqa: E402
from repro_torch.core.dse import engine as P_engine  # noqa: E402
from repro_torch.core.dse import ga as P_ga  # noqa: E402
from repro_torch.core.dse import objective as P_obj  # noqa: E402
from repro_torch.core.dse import pareto as P_pareto  # noqa: E402
from repro_torch.core.dse import sweep as P_sweep  # noqa: E402
from repro_torch.core.dse.encoding import GENOME_LEN  # noqa: E402

WORKLOADS = ["kan", "snn_vgg9"]
REL_TOL = 1e-9


# ------------------------------------------------------------ pure functions

def test_objective_matches_reference():
    rng = np.random.default_rng(11)
    areas = np.concatenate([rng.uniform(0, 1000, 200),
                            np.asarray(R_obj.AREA_BRACKETS),
                            np.nextafter(R_obj.AREA_BRACKETS, np.inf)])
    assert P_obj.AREA_BRACKETS == R_obj.AREA_BRACKETS
    assert P_obj.ALPHA == R_obj.ALPHA
    assert [P_obj.area_bracket(a) for a in areas] == \
        [R_obj.area_bracket(a) for a in areas]
    e_c = rng.uniform(1, 10, (32, 4))
    e_h = rng.uniform(1, 10, 4)
    e_c[3] = e_h                                    # ties: zero savings
    e_c[5, 1] = np.inf
    assert np.array_equal(P_obj.iso_area_savings(e_c, e_h),
                          R_obj.iso_area_savings(e_c, e_h))
    for e, tw in zip(e_c, rng.uniform(0, 5, 32)):
        assert P_obj.fitness(e, e_h, tw, 5.0) == R_obj.fitness(e, e_h, tw,
                                                               5.0)
    ii = rng.uniform(0, 2e-3, (32, 4))
    for target in (1e-3, rng.uniform(0, 2e-3, 4)):
        assert np.array_equal(P_obj.serving_fitness(e_c, ii, target),
                              R_obj.serving_fitness(e_c, ii, target))


@pytest.mark.parametrize("n,d", [(0, 3), (1, 3), (40, 2), (200, 3)])
def test_pareto_matches_reference(n, d):
    rng = np.random.default_rng(n + d)
    pts = rng.integers(0, 6, (n, d)).astype(np.float64)   # many ties
    if n > 1:
        pts[n // 2] = pts[0]                              # duplicate rows
        pts[-1] = pts[1]
        pts[n // 3, 0] = np.inf
    want = R_pareto.pareto_mask(pts)
    got = P_pareto.pareto_mask(pts)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(P_pareto.pareto_front(pts),
                          R_pareto.pareto_front(pts))
    dev = P_pareto.pareto_mask_device(pts, device="cpu")
    assert dev.dtype == torch.bool and dev.device.type == "cpu"
    assert np.array_equal(dev.numpy(), want)
    assert np.array_equal(
        P_pareto.pareto_mask_device(torch.from_numpy(pts), "cpu").numpy(),
        want)


# -------------------------------------------------- host logic, stub engine

class StubEngine:
    """A deterministic engine from numpy: metrics are a function of the
    genome (some rows unmappable), areas are the engine's vectorized
    ``genome_areas``; implements what the frontends call."""

    backend = "exact"

    def __init__(self, workloads):
        self.workloads = list(workloads)
        self.w = np.random.default_rng(5).integers(
            1, 1000, (len(self.workloads), GENOME_LEN))
        self.calls = 0

    def check_workloads(self, workloads, calib=None):
        assert list(workloads) == self.workloads
        return self

    def areas(self, genomes):
        return P_engine.genome_areas(
            np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN))

    def evaluate(self, genomes, keep=None, canonical=None):
        self.calls += 1
        g = np.asarray(genomes, np.int64).reshape(-1, GENOME_LEN)
        area = self.areas(g)
        h = (g @ self.w.T) % 9973
        lat = 1e-3 * (1.0 + h / 9973.0)
        en = 1e6 * (1.0 + ((h * 7) % 9973) / 9973.0) \
            * (1.0 + area[:, None] / 400.0)
        tw = 1.0 + ((h * 13) % 9973) / 997.0
        bad = (h % 11 == 0).any(axis=1)
        if keep is not None:
            bad |= ~np.asarray(keep(area), bool)
        lat[bad], en[bad], tw[bad] = np.inf, np.inf, 0.0
        return {"latency": lat, "energy": en, "tops_w": tw, "area": area,
                "meta": {"requests": len(g)}}


def _eq8(e_homo):
    def objective(m):
        tw = m["tops_w"].max(axis=1)
        return np.asarray([P_obj.fitness(e, e_homo, t, tw.max())
                           for e, t in zip(m["energy"], tw)])
    return objective


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    nan = a.dtype.kind == "f"
    assert a.shape == b.shape and np.array_equal(a, b, equal_nan=nan), what


def _same_sweep(p, r):
    for f in ("genomes", "family", "bracket", "area", "latency", "energy",
              "tops_w"):
        _same(getattr(p, f), getattr(r, f), f)
    _same(p.fitness(), r.fitness(), "fitness")
    _same(p.savings(), r.savings(), "savings")
    assert p.homo_baseline().keys() == r.homo_baseline().keys()


@pytest.fixture(scope="module")
def stub_sweeps():
    kw = dict(samples_per_stratum=2, exact=True)
    p = P_sweep.run_sweeps(WORKLOADS, seeds=(0, 1),
                           engine=StubEngine(WORKLOADS), **kw)
    r = R_sweep.run_sweeps(WORKLOADS, seeds=(0, 1),
                           engine=StubEngine(WORKLOADS), **kw)
    return p, r


def test_sweep_host_logic_matches_reference(stub_sweeps):
    p, r = stub_sweeps
    assert list(p) == list(r) == [0, 1]
    for s in p:
        _same_sweep(p[s], r[s])
        assert np.isfinite(p[s].fitness()).any()
        assert not np.isfinite(p[s].latency).all()


@pytest.mark.parametrize("bracket", [100.0, 200.0])
def test_ga_host_loop_matches_reference(stub_sweeps, bracket):
    p, r = stub_sweeps
    cfg = dict(population=12, generations=5, seed_top_k=6, early_stop=3)
    gens = {"p": [], "r": []}
    got = P_ga.run_ga(p[0], bracket, P_ga.GAConfig(**cfg), seed=3,
                      loop="host", engine=StubEngine(WORKLOADS),
                      on_generation=lambda *a: gens["p"].append(a[1]))
    want = R_ga.run_ga(r[0], bracket, R_ga.GAConfig(**cfg), seed=3,
                       loop="host", engine=StubEngine(WORKLOADS),
                       on_generation=lambda *a: gens["r"].append(a[1]))
    assert got is not None and want is not None
    assert got.history == want.history
    _same(got.best_genome, want.best_genome, "best genome")
    assert got.best_fitness == want.best_fitness
    assert got.evaluated == want.evaluated and got.bracket == bracket
    _same(got.best_savings_per_wl, want.best_savings_per_wl, "savings")
    assert got.best_metrics.keys() == want.best_metrics.keys()
    for k in got.best_metrics:
        _same(got.best_metrics[k], want.best_metrics[k], k)
    assert len(gens["p"]) == len(gens["r"]) > 1
    for a, b in zip(gens["p"], gens["r"]):
        _same(a, b, "population")


def test_bayes_matches_reference(stub_sweeps):
    e_homo = stub_sweeps[0][0].homo_baseline()[200.0]
    cfg = dict(init_samples=16, rounds=3, batch_per_round=4,
               candidate_pool=64)
    got = P_bayes.run_bayes(WORKLOADS, _eq8(e_homo), P_bayes.BayesConfig(
        **cfg), seed=4, engine=StubEngine(WORKLOADS))
    want = R_bayes.run_bayes(WORKLOADS, _eq8(e_homo), R_bayes.BayesConfig(
        **cfg), seed=4, engine=StubEngine(WORKLOADS))
    assert got.keys() == want.keys()
    assert got["history"] == want["history"]
    for k in ("best_genome", "genomes", "scores"):
        _same(got[k], want[k], k)
    assert got["best_score"] == want["best_score"]
    assert got["best_score_exact"] == want["best_score_exact"]
    for k in want["metrics"]:
        _same(got["metrics"][k], want["metrics"][k], k)
        if k in want["best_metrics_exact"]:
            _same(got["best_metrics_exact"][k],
                  want["best_metrics_exact"][k], k)


# ------------------------------------------------------------- end to end

def test_sweep_and_ga_end_to_end_match_reference():
    """Real exact engines on both sides (micro-batches of 16, so the JAX
    engine compiles one shape): the sweep's genomes are equal, its metrics
    within rel 1e-9, and the GA picks the same genomes."""
    port = P_engine.EvalEngine(WORKLOADS, config=P_api.EngineConfig(
        backend="exact", batch=16), device="cpu")
    ref = R_engine.EvalEngine(WORKLOADS, config=R_api.EngineConfig(
        backend="exact", batch=16))
    p = P_sweep.run_sweep(WORKLOADS, samples_per_stratum=2, exact=True,
                          engine=port)
    r = R_sweep.run_sweep(WORKLOADS, samples_per_stratum=2, exact=True,
                          engine=ref)
    for f in ("genomes", "family", "bracket", "area"):
        _same(getattr(p, f), getattr(r, f), f)
    for f in ("latency", "energy", "tops_w"):
        a, b = getattr(p, f), getattr(r, f)
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), f
        err = np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1e-300)
        assert err.max(initial=0.0) <= REL_TOL, (f, err.max())
    cfg = dict(population=8, generations=2, seed_top_k=4, early_stop=4)
    got = P_ga.run_ga(p, 200.0, P_ga.GAConfig(**cfg), loop="host",
                      engine=port)
    want = R_ga.run_ga(r, 200.0, R_ga.GAConfig(**cfg), loop="host",
                       engine=ref)
    assert got is not None and want is not None
    _same(got.best_genome, want.best_genome, "best genome")
    assert got.evaluated == want.evaluated
    np.testing.assert_allclose(got.history, want.history, rtol=REL_TOL,
                               atol=0)


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("loop", ["device", "fused"])
def test_ga_device_loops_raise_naming_a10(stub_sweeps, loop):
    """A10 is ported: the device loop scores through any object with the
    engine's scoring surface (the stub here; its genetics on the CPU as
    asked), the fused loop needs a local exact ``EvalEngine`` and refuses
    the stub before any scoring; an unknown loop is refused."""
    eng = StubEngine(WORKLOADS)
    cfg = P_ga.GAConfig(population=8, generations=2, seed_top_k=4)
    if loop == "device":
        res = P_ga.run_ga(stub_sweeps[0][0], 200.0, cfg, engine=eng,
                          loop=loop, device="cpu")
        assert res is not None and res.evaluated == 24
        assert eng.calls == 3 and len(res.history) == 3
    else:
        with pytest.raises(ValueError, match="local EvalEngine"):
            P_ga.run_ga(stub_sweeps[0][0], 200.0, cfg, engine=eng,
                        loop=loop)
        assert eng.calls == 0               # refused before any scoring
    with pytest.raises(ValueError, match="loop"):
        P_ga.run_ga(stub_sweeps[0][0], 200.0, engine=eng, loop="gpu")


def test_scan_defaults_raise_naming_a8(stub_sweeps):
    """The frontends' defaults build the reference's default engine, the
    scan backend, which runs on the CPU when asked for it (and on the
    card otherwise: without one they raise instead of falling back)."""
    s = P_sweep.run_sweep(WORKLOADS, samples_per_stratum=1, device="cpu")
    assert len(s.genomes) == 15 and np.isfinite(s.latency).all()
    g = s.genomes[:3]
    one = P_sweep.evaluate_genomes(g, WORKLOADS, device="cpu")
    assert one["meta"]["backend"] == "scan"
    for k in ("latency", "energy", "tops_w"):
        assert np.array_equal(one[k], getattr(s, k)[:3]), k
    loop = P_sweep.evaluate_genomes_reference(g, WORKLOADS, device="cpu")
    for k in ("latency", "energy", "tops_w"):
        err = np.abs(loop[k] - one[k]) / np.maximum(np.abs(one[k]), 1e-300)
        assert err.max() <= REL_TOL, k
    res = P_ga.run_ga(stub_sweeps[0][0], 200.0, P_ga.GAConfig(
        population=4, generations=1, seed_top_k=2), loop="host",
        device="cpu")                                      # no engine
    assert np.isfinite(res.best_fitness) and res.evaluated == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P_sweep.evaluate_genomes(g, WORKLOADS)
    # exact=True without an engine builds the exact one, which runs
    s = P_sweep.run_sweep(["kan"], samples_per_stratum=1, exact=True,
                          device="cpu")
    assert np.isfinite(s.latency).all() and len(s.genomes) == 15
