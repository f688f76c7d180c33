"""PyTorch port, the fused refinement's islands on one device: two
logical islands with ring migration every generation against the JAX
package's ``run_ga_fused`` with the reference's ``jax.random`` draws
replayed (the same best genome, population and ``evaluated``, history
within rel 1e-9); seeded island runs replay bit for bit; migration moves
each island's best rows into the next island's worst slots."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dse import api as R_api  # noqa: E402
from repro.core.dse import engine as R_engine  # noqa: E402
from repro.core.dse import ga as R_ga  # noqa: E402
from repro.core.dse import ga_device as R_gd  # noqa: E402
from repro.core.dse import sweep as R_sweep  # noqa: E402
from repro_torch.core.dse.api import EngineConfig  # noqa: E402
from repro_torch.core.dse.engine import EvalEngine  # noqa: E402
from repro_torch.core.dse.ga import GAConfig  # noqa: E402
from repro_torch.core.dse.ga_device import _migrate, run_ga_fused  # noqa: E402
from repro_torch.core.dse.sweep import run_sweep  # noqa: E402

from test_torch_device_search import JaxDraws  # noqa: E402

WLS = ["kan"]
CFG = dict(population=16, generations=3, seed_top_k=8, early_stop=100)
ISLANDS = dict(islands=2, migrate_every=1, migrate_k=2)


def _exact():
    return EvalEngine(WLS, config=EngineConfig(backend="exact"),
                      device="cpu")


@pytest.fixture(scope="module")
def sweep():
    return run_sweep(WLS, samples_per_stratum=4, seed=0,
                     brackets=(100.0, 200.0), engine=_exact())


def test_two_islands_match_the_reference(sweep):
    ref_sw = R_sweep.SweepResult(**{f.name: getattr(sweep, f.name)
                                    for f in dataclasses.fields(sweep)})
    got = run_ga_fused(sweep, 200.0, GAConfig(**CFG), seed=3,
                       engine=_exact(), draws=JaxDraws, **ISLANDS)
    want = R_gd.run_ga_fused(ref_sw, 200.0, R_ga.GAConfig(**CFG), seed=3,
                             engine=R_engine.EvalEngine(
                                 WLS, config=R_api.EngineConfig(
                                     backend="exact")), **ISLANDS)
    assert np.array_equal(got.result.best_genome, want.result.best_genome)
    assert got.result.evaluated == want.result.evaluated
    assert got.generations_run == want.generations_run
    assert np.array_equal(got.population, want.population)
    np.testing.assert_allclose(got.result.history, want.result.history,
                               rtol=1e-9, atol=0)


def test_island_runs_replay_bit_for_bit(sweep):
    a, b = (run_ga_fused(sweep, 200.0, GAConfig(**CFG), seed=3,
                         engine=_exact(), **ISLANDS) for _ in range(2))
    assert a.result.history == b.result.history
    assert a.result.best_genome.tobytes() == b.result.best_genome.tobytes()
    assert np.array_equal(a.population, b.population)
    assert np.isfinite(a.result.best_fitness)


@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_ring_migration(blocks):
    """The four islands held as ``blocks`` device blocks (one block: the
    one-card layout) migrate around the same ring."""
    pop = torch.arange(4 * 6, dtype=torch.int32).reshape(4, 6)
    pop = pop[:, :, None].expand(4, 6, 3).reshape(24, 3)
    fit = torch.tensor([5., 1., 3., 0., 4., 2.] * 4, dtype=torch.float64)
    fit[6:12] += 10.0                            # island 1 is the best
    new_pops, new_fits = _migrate(list(pop.chunk(blocks)),
                                  list(fit.chunk(blocks)), 4 // blocks, 2)
    new_pop, new_fit = torch.cat(new_pops), torch.cat(new_fits)
    P = new_pop.reshape(4, 6, 3)[:, :, 0]
    F = new_fit.reshape(4, 6)
    for i in range(4):
        src = (i - 1) % 4
        # the worst two of island i (slots 3 and 1) take island i-1's
        # best two (slots 0 and 4), fitness travelling with them
        assert P[i, 3] == 6 * src + 4 and P[i, 1] == 6 * src + 0
        assert F[i, 3] == fit[6 * src + 4] and F[i, 1] == fit[6 * src]
        keep = [0, 2, 4, 5]
        assert torch.equal(P[i, keep], torch.tensor(keep) + 6 * i)
