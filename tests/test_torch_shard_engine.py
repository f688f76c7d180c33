"""PyTorch port, the sharded DSE engine and the island placement of the
fused GA (``EngineConfig(shard=True)``, ``launch.mesh``'s placements,
``ga_device.run_ga_fused``) with the local devices patched to four CPU
entries: the sharded engine scores bit for bit as the unsharded one
(and within rel 1e-9 of the JAX package's single-device engine), an
uneven batch is padded to the device count, and a four-island refinement
with one island block per device equals the one-device run bit for
bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dse import api as R_api  # noqa: E402
from repro.core.dse import engine as R_engine  # noqa: E402
from repro_torch.core.dse.api import EngineConfig  # noqa: E402
from repro_torch.core.dse.encoding import random_genomes  # noqa: E402
from repro_torch.core.dse.engine import EvalEngine  # noqa: E402
from repro_torch.core.dse.ga import GAConfig  # noqa: E402
from repro_torch.core.dse.ga_device import run_ga_fused  # noqa: E402
from repro_torch.core.dse.sweep import run_sweep  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

WLS = ["kan"]
KEYS = ("latency", "energy", "tops_w", "area")
FOUR = [torch.device("cpu")] * 4


@pytest.fixture
def four_devices(monkeypatch):
    monkeypatch.setattr(M, "local_devices", lambda device=None: FOUR)


@pytest.fixture(scope="module")
def genomes():
    return random_genomes(np.random.default_rng(2026), 16)


def _engine(shard, backend="scan"):
    return EvalEngine(WLS, config=EngineConfig(backend=backend, shard=shard),
                      device="cpu")


def test_placements_read_the_local_devices(four_devices):
    assert M.candidate_sharding("cpu") == FOUR
    assert M.population_sharding("cpu") == FOUR
    assert M.island_sharding(8, "cpu") == FOUR
    assert M.island_sharding(6, "cpu") is None
    assert M.default_islands(16, "cpu") == 4
    assert M.default_islands(6, "cpu") == 1      # 6 does not split in 4
    assert M.default_islands(4, "cpu") == 1      # one genome an island
    assert _engine(True)._pad_size(13) == 16


def test_one_device_placements_are_none():
    assert M.candidate_sharding("cpu") is None
    assert M.island_sharding(4, "cpu") is None
    assert M.default_islands(16, "cpu") == 1
    assert _engine(True)._pad_size(13) == 13


def _close(got, want):
    for k in KEYS:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        fin = np.isfinite(b)
        assert np.array_equal(np.isfinite(a), fin), k
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=0)


def test_sharded_evaluate_is_bit_for_bit(four_devices, genomes):
    sharded = _engine(True)
    assert sharded._devices == FOUR
    got = sharded.evaluate(genomes)
    want = _engine(False).evaluate(genomes)
    for k in KEYS:
        assert np.array_equal(got[k], want[k]), k
    assert got["meta"]["dispatches"] == want["meta"]["dispatches"] == 1
    _close(got, R_engine.EvalEngine(WLS, config=R_api.EngineConfig())
           .evaluate(genomes))


def test_sharded_rescore_of_an_uneven_batch(four_devices, genomes):
    """13 genomes pad to 16 rows, four a device; the padding rows leave no
    trace in the result."""
    g = genomes[:13]
    got = _engine(True, "exact").rescore(g)
    want = _engine(False, "exact").rescore(g)
    for k in KEYS:
        assert got[k].shape[0] == 13
        assert np.array_equal(got[k], want[k]), k
    _close(got, R_engine.EvalEngine(WLS, config=R_api.EngineConfig(
        backend="exact")).rescore(g))


@pytest.fixture(scope="module")
def sweep():
    return run_sweep(WLS, samples_per_stratum=4, seed=0,
                     brackets=(100.0, 200.0), device="cpu")


@pytest.mark.parametrize("shard", [False, True])
def test_four_island_blocks_equal_the_one_device_run(sweep, monkeypatch,
                                                     shard):
    """islands=4: one block a device under the patch (a sharded engine
    also splits the search), one logical block without it."""
    cfg = GAConfig(population=16, generations=2, seed_top_k=8,
                   early_stop=100)
    kw = dict(islands=4, migrate_every=1, migrate_k=2, seed=3)

    def run():
        return run_ga_fused(sweep, 200.0, cfg, engine=_engine(shard,
                                                              "exact"), **kw)

    want = run()
    monkeypatch.setattr(M, "local_devices", lambda device=None: FOUR)
    got = run()
    assert got.result.history == want.result.history
    assert np.array_equal(got.population, want.population)
    assert np.array_equal(got.result.best_genome, want.result.best_genome)
    for k in KEYS:
        assert np.array_equal(got.pop_metrics[k], want.pop_metrics[k]), k


def test_default_islands_follow_the_devices(sweep, monkeypatch):
    """islands=None: one island on one device, one a device under the
    patch (a population of 16 splits in four)."""
    cfg = GAConfig(population=16, generations=1, seed_top_k=8,
                   early_stop=100)
    one = run_ga_fused(sweep, 200.0, cfg, engine=_engine(False, "exact"))
    four = run_ga_fused(sweep, 200.0, cfg, engine=_engine(False, "exact"),
                        islands=4)
    monkeypatch.setattr(M, "local_devices", lambda device=None: FOUR)
    auto = run_ga_fused(sweep, 200.0, cfg, engine=_engine(False, "exact"))
    assert np.array_equal(auto.population, four.population)
    assert not np.array_equal(auto.population, one.population)
