"""PyTorch port, the device search (A10): the device memo's tables and
hash, the device canonicalizer, Eq. 8 on the device, the genetics step
(given the reference's replayed ``jax.random`` draws), the device configs
and the bracket band bit for bit against the JAX package; the
device loop against the reference's on ``kan`` with replayed draws (the
fused loop's in tests/test_torch_{pipeline,islands}.py); and the port's
own invariants (the fused loop walks the device loop's genome stream, a
warm memo is inert), on the CPU."""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.dse import api as R_api  # noqa: E402
from repro.core.dse import device_memo as R_memo  # noqa: E402
from repro.core.dse import engine as R_engine  # noqa: E402
from repro.core.dse import ga as R_ga  # noqa: E402
from repro.core.dse import ga_device as R_gd  # noqa: E402
from repro.core.dse import sweep as R_sweep  # noqa: E402
from repro_torch.core.dse import device_memo as P_memo  # noqa: E402
from repro_torch.core.dse import ga_device as P_gd  # noqa: E402
from repro_torch.core.dse.api import EngineConfig  # noqa: E402
from repro_torch.core.dse.encoding import (GENOME_LEN,  # noqa: E402
                                           genome_bounds, random_genomes)
from repro_torch.core.dse.engine import (EvalEngine,  # noqa: E402
                                         canonical_genomes,
                                         genomes_to_configs)
from repro_torch.core.dse.ga import GAConfig, run_ga  # noqa: E402
from repro_torch.core.dse.objective import AREA_BRACKETS  # noqa: E402
from repro_torch.core.dse.sweep import run_sweep  # noqa: E402

WLS = ["kan"]
CFG = dict(population=16, generations=3, seed_top_k=8, early_stop=100)
REL_TOL = 1e-9
W = 2           # workload-row width of the synthetic memo tables


class JaxDraws:
    """A draw source replaying the reference's ``jax.random`` key chain:
    ``PRNGKey(seed + bracket)``, one ``split`` per generation, one more
    per island, then ``_genetics_kernel``'s seven draws."""

    def __init__(self, key):
        self.key = jax.random.PRNGKey(key)

    def __call__(self, islands, population, tournament, n_elite, device):
        self.key, sub = jax.random.split(self.key)
        subs = [sub] if islands == 1 else list(jax.random.split(sub,
                                                                islands))
        return [replay(s, population, tournament, n_elite, device)
                for s in subs]


def replay(key, population, tournament, n_elite, device="cpu"):
    """``_genetics_kernel``'s draws for one key, as ``GeneticDraws``."""
    n_pairs = max(-(-(population - n_elite) // 2), 0)
    nc = 2 * n_pairs
    k = jax.random.split(key, 7)
    m = P_gd.MUT_GENES_MAX
    arrs = (jax.random.randint(k[0], (nc, tournament), 0, population),
            jax.random.uniform(k[1], (n_pairs,)),
            jax.random.uniform(k[2], (n_pairs, GENOME_LEN)),
            jax.random.uniform(k[3], (nc,)),
            jax.random.poisson(k[4], 2.0, (nc,)),
            jax.random.randint(k[5], (nc, m), 0, GENOME_LEN),
            jax.random.uniform(k[6], (nc, m)))
    return P_gd.GeneticDraws(*(torch.tensor(np.asarray(a), device=device)
                               for a in arrs))


def _exact(**kw):
    return EvalEngine(WLS, config=EngineConfig(backend="exact", **kw),
                      device="cpu")


def _ref_exact():
    return R_engine.EvalEngine(WLS, config=R_api.EngineConfig(
        backend="exact"))


def ref_sweep(p):
    """The reference's ``SweepResult`` holding the port's sweep (the same
    genomes as the reference's own; its metrics are held against the
    reference's in tests/test_torch_frontends.py), so both loops start
    from the same seed population."""
    return R_sweep.SweepResult(**{f.name: getattr(p, f.name)
                                  for f in dataclasses.fields(p)})


@pytest.fixture(scope="module")
def sweeps():
    p = run_sweep(WLS, samples_per_stratum=4, seed=0,
                  brackets=(100.0, 200.0), engine=_exact())
    return p, ref_sweep(p)


def _same(got, want, exact=True):
    assert got is not None and want is not None
    assert np.array_equal(got.best_genome, want.best_genome)
    assert got.evaluated == want.evaluated
    h, w = np.asarray(got.history), np.asarray(want.history)
    assert h.shape == w.shape
    if exact:
        assert got.history == want.history
        assert got.best_fitness == want.best_fitness
    else:
        np.testing.assert_allclose(h, w, rtol=REL_TOL, atol=0)


# ------------------------------------------------------------- device memo

def _keys(n, seed=0):
    g = np.random.default_rng(seed).integers(0, 100, (n, GENOME_LEN))
    g = g.astype(np.int32)
    g[:, 0] = np.arange(n)              # distinct rows
    return g


def _vals(n, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 3, W))


def _both_insert(state, keys, vals, update=None):
    """One insert on each package's table; returns both states."""
    r, p = state
    upd = np.ones(len(keys), bool) if update is None else update
    r = R_memo._insert_jit(r, jnp.asarray(keys), jnp.asarray(vals),
                           jnp.asarray(upd))
    p = P_memo.memo_insert(p, torch.as_tensor(keys), torch.as_tensor(vals),
                           None if update is None else torch.as_tensor(
                               update))
    return r, p


_lookup_jit = jax.jit(R_memo.memo_lookup)


def _tables_equal(state):
    r, p = state
    for a, b in zip(r, p):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


def _fresh(cap):
    return R_memo.memo_init(cap, W), P_memo.memo_init(cap, W, "cpu")


@pytest.mark.parametrize("cap,n", [(128, 32), (8, 64), (1, 5)])
def test_memo_hash_and_tables_equal_the_reference(cap, n):
    keys = _keys(n)
    assert np.array_equal(np.asarray(R_memo._hash(jnp.asarray(keys), cap)),
                          P_memo._hash(torch.as_tensor(keys), cap).numpy())
    state = _both_insert(_fresh(cap), keys, _vals(n))
    _tables_equal(state)
    # a second wave (put-if-absent, drops at full load) lands alike
    state = _both_insert(state, _keys(n, seed=7) + 3, _vals(n, seed=3))
    _tables_equal(state)
    for probe in (keys, _keys(n, seed=7) + 3, _keys(n, seed=99) + 1000):
        hr, vr = _lookup_jit(state[0], jnp.asarray(probe))
        hp, vp = P_memo.memo_lookup(state[1], torch.as_tensor(probe))
        assert np.array_equal(np.asarray(hr), hp.numpy())
        assert np.array_equal(np.asarray(vr)[np.asarray(hr)],
                              vp.numpy()[hp.numpy()])


def test_memo_in_batch_duplicates_and_update_mask():
    keys, vals = _keys(16), _vals(16, seed=3)
    keys[5] = keys[2]                   # rows 2 and 5 share a key...
    keys[9] = keys[2]
    vals[5] += 1.0                      # ...with different rows
    upd = np.arange(16) % 3 != 1
    state = _both_insert(_fresh(64), keys, vals, upd)
    _tables_equal(state)
    assert P_memo.memo_fill(state[1]) == R_memo.memo_fill(state[0])
    _, out = P_memo.memo_lookup(state[1], torch.as_tensor(keys[2:3]))
    assert out[0].numpy().tobytes() == vals[2].tobytes()  # first copy won
    hit, _ = P_memo.memo_lookup(state[1], torch.as_tensor(keys))
    assert not hit[1] and not hit[4] and hit[0]


def test_memo_full_table_drops_without_corruption():
    cap = 8
    first_k, first_v = _keys(cap), _vals(cap, seed=0)
    state = _both_insert(_fresh(cap), first_k, first_v)
    assert P_memo.memo_fill(state[1]) == cap
    second = _both_insert(state, _keys(64, seed=7) + 1000, _vals(64, 7))
    _tables_equal(second)
    assert P_memo.memo_fill(second[1]) == cap
    hit, out = P_memo.memo_lookup(second[1], torch.as_tensor(first_k))
    assert bool(hit.all()) and out.numpy().tobytes() == first_v.tobytes()
    hit2, _ = P_memo.memo_lookup(second[1],
                                 torch.as_tensor(_keys(64, seed=7) + 1000))
    assert not bool(hit2.any())


def test_memo_engine_sync_round_trip():
    genomes = random_genomes(np.random.default_rng(5), 8)
    eng = _exact()
    m = eng.evaluate(genomes)
    memo = P_memo.memo_from_store(eng, 64)
    assert not bool(memo.fresh.any())
    canon = torch.as_tensor(canonical_genomes(genomes))
    hit, vals = P_memo.memo_lookup(memo, canon)
    assert bool(hit.all())
    for j, k in enumerate(("latency", "energy", "tops_w")):
        assert vals[:, j].numpy().tobytes() == m[k].tobytes()
    assert P_memo.drain_to_store(memo, eng) == 0    # nothing fresh
    cold = _exact()
    memo2 = P_memo.memo_insert(P_memo.memo_init(64, 1, "cpu"), canon, vals)
    assert P_memo.drain_to_store(memo2, cold) == P_memo.memo_fill(memo2)
    keys, rows = P_memo.memo_to_arrays(memo2)
    assert keys.dtype == np.int64 and rows.shape == (8, 3, 1)
    m2 = cold.evaluate(genomes)
    assert m2["meta"]["hits"] == len(genomes) and m2["meta"]["misses"] == 0
    for k in ("latency", "energy", "tops_w"):
        assert m2[k].tobytes() == m[k].tobytes()
    assert not bool(P_memo.clear_fresh(memo2).fresh.any())


# ------------------------------------------- canonicals, Eq. 8, the band

def _population(seed=11, n=32):
    rng = np.random.default_rng(seed)
    return np.concatenate([random_genomes(rng, n, family=f)
                           for f in (None, "homo", "hetero_bl",
                                     "hetero_bls")])


def test_canonical_device_bit_for_bit():
    g = _population()
    got = P_gd.canonical_genomes_device(g, "cpu")
    assert np.array_equal(got, R_gd.canonical_genomes_device(g))
    assert np.array_equal(got, canonical_genomes(g))
    g32 = torch.as_tensor(g.astype(np.int32))
    assert P_gd._canonical_device(g32).dtype == torch.int32


@pytest.mark.parametrize("w", [1, 2, 3, 5, 20])
def test_fitness_device_bit_for_bit(w):
    rng = np.random.default_rng(31 + w)
    n = 64
    m = {"energy": rng.uniform(1.0, 5.0, (n, w)),
         "tops_w": rng.uniform(0.1, 2.0, (n, w)),
         "latency": rng.uniform(1e-4, 1e-2, (n, w)),
         "area": rng.uniform(60.0, 900.0, n)}
    m["latency"][0, 0] = np.inf             # invalid rows
    m["energy"][1] = np.inf
    m["latency"][2, -1] = 0.0
    e_homo = rng.uniform(2.0, 4.0, w)
    for b in AREA_BRACKETS + (123.0,):
        for alpha in (0.05, 0.3):
            got = P_gd.fitness_device(m, e_homo, b, alpha, "cpu")
            want = R_gd.fitness_device(m, e_homo, b, alpha)
            assert got.tobytes() == want.tobytes(), (b, alpha)


def test_fma_is_correctly_rounded():
    rng = np.random.default_rng(3)
    a = rng.standard_normal(2000) * rng.choice([1.0, 1e-6, 1e6], 2000)
    c = rng.standard_normal(2000) * rng.choice([1.0, 1e-9, 1e9], 2000)
    for w in (3, 7, 20):
        got = P_gd._fma(torch.as_tensor(a), 1.0 / w, torch.as_tensor(c))
        want = [float(Fraction(x) * Fraction(1.0 / w) + Fraction(y))
                for x, y in zip(a, c)]
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_bracket_bounds_match_the_reference():
    for b in AREA_BRACKETS + (123.0,):
        got, want = P_gd.bracket_bounds(b), R_gd.bracket_bounds(b)
        assert np.array_equal(got, want, equal_nan=True)


# ------------------------------------------------------ the genetics step

@pytest.mark.parametrize("population,n_elite,tournament",
                         [(12, 2, 5), (13, 1, 3)])
def test_genetics_step_bit_for_bit_given_replayed_draws(population, n_elite,
                                                        tournament):
    rng = np.random.default_rng(population)
    pop = random_genomes(rng, population).astype(np.int32)
    fit = rng.normal(size=population)
    fit[3], fit[5] = -np.inf, fit[6]        # -inf rows and ties
    fit[7] = -np.inf
    kernel = R_gd._genetics_kernel(population, tournament, n_elite, 0.8, 0.2)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want, want_canon = (np.asarray(a) for a in kernel(pop, fit, key))
        got, canon = P_gd.genetics_step(
            torch.as_tensor(pop), torch.as_tensor(fit),
            replay(key, population, tournament, n_elite), n_elite, 0.8, 0.2)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(canon.numpy(), want_canon)
        assert (got.numpy() < genome_bounds()[None, :]).all()


def test_torch_draws_are_keyed_and_per_island():
    a = P_gd.TorchDraws(7)(2, 12, 5, 1, "cpu")
    b = P_gd.TorchDraws(7)(2, 12, 5, 1, "cpu")
    c = P_gd.TorchDraws(7)(1, 12, 5, 1, "cpu")
    assert len(a) == 2
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for x, y in zip(a[0], c[0]):            # island 0: the key alone
        assert torch.equal(x, y)
    assert not torch.equal(a[0].swap, a[1].swap)
    d = a[0]
    assert d.tournament.shape == (12, 5) and d.swap.shape == (6, GENOME_LEN)
    assert d.genes.dtype == torch.int64 and d.values.dtype == torch.float64


# ---------------------------------------------------------- device configs

def test_device_configs_bit_for_bit():
    g = _population(17)
    host = genomes_to_configs(g)
    tile, chip, area = P_gd._configs_device(torch.as_tensor(
        g.astype(np.int32)))
    for k, v in tile.items():
        assert v.numpy().tobytes() == np.ascontiguousarray(
            host["tile"][k], np.float64).tobytes(), k
    for k, v in chip.items():
        assert v.numpy().tobytes() == np.ascontiguousarray(
            host["chip"][k], np.float64).tobytes(), k
    ref = R_engine.genome_areas(g)
    assert area.numpy().tobytes() == ref.tobytes()
    assert P_gd._chip_area_device(torch.as_tensor(g)).numpy().tobytes() \
        == ref.tobytes()
    for a, b in zip(P_gd._area_tables_host(R_engine.DEFAULT_CALIB),
                    R_gd._area_tables_host(R_engine.DEFAULT_CALIB)):
        assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------ whole loops

def test_device_loop_matches_the_reference(sweeps):
    p, r = sweeps
    got = P_gd.run_ga_device(p, 200.0, GAConfig(**CFG), seed=1,
                             engine=_exact(), draws=JaxDraws)
    want = R_ga.run_ga(r, 200.0, R_ga.GAConfig(**CFG), seed=1,
                       engine=_ref_exact(), loop="device")
    _same(got, want, exact=False)


def test_fused_walks_the_device_loops_stream(sweeps):
    p, _ = sweeps
    dev = run_ga(p, 200.0, GAConfig(**CFG), seed=1, engine=_exact(),
                 loop="device")
    fused = run_ga(p, 200.0, GAConfig(**CFG), seed=1, engine=_exact(),
                   loop="fused")
    _same(fused, dev)


def test_fused_warm_memo_is_inert(sweeps):
    p, _ = sweeps
    eng = _exact()
    cold = P_gd.run_ga_fused(p, 200.0, GAConfig(**CFG), seed=2, engine=eng)
    warm = P_gd.run_ga_fused(p, 200.0, GAConfig(**CFG), seed=2, engine=eng)
    _same(cold.result, warm.result)
    assert cold.searches > 0 and warm.searches == 0    # all-hit replay
    assert warm.memo_hits == CFG["population"] * (warm.generations_run + 1)
    assert np.array_equal(cold.population, warm.population)
    for k in cold.pop_metrics:
        assert cold.pop_metrics[k].tobytes() == warm.pop_metrics[k].tobytes()
    assert np.isfinite(cold.result.best_fitness)


def test_oversized_seed_set_truncates_to_population():
    sw = run_sweep(WLS, samples_per_stratum=8, seed=0, brackets=(200.0,),
                   engine=_exact())
    cfg = GAConfig(population=6, generations=2, seed_top_k=50,
                   early_stop=100)
    fit = sw.fitness(cfg.alpha)
    assert ((sw.bracket == 200.0) & np.isfinite(fit)).sum() > cfg.population
    dev = run_ga(sw, 200.0, cfg, seed=1, engine=_exact(), loop="device")
    fused = run_ga(sw, 200.0, cfg, seed=1, engine=_exact(), loop="fused")
    _same(fused, dev)


def test_early_stop_and_generation_hook(sweeps):
    p, _ = sweeps
    cfg = GAConfig(population=8, generations=6, seed_top_k=4, early_stop=1)
    seen = []
    dev = run_ga(p, 100.0, cfg, seed=4, engine=_exact(), loop="device",
                 on_generation=lambda g, pop, fit, m: seen.append(g))
    fused = run_ga(p, 100.0, cfg, seed=4, engine=_exact(), loop="fused")
    _same(fused, dev)
    assert seen == list(range(len(dev.history)))
    assert len(dev.history) <= cfg.generations + 1


def test_fused_validation(sweeps):
    p, _ = sweeps
    with pytest.raises(ValueError, match="fused"):
        run_ga(p, 200.0, GAConfig(**CFG), loop="fused", engine=_exact(),
               on_generation=lambda *a: None)
    with pytest.raises(ValueError, match="exact"):
        P_gd.run_ga_fused(p, 200.0, GAConfig(**CFG), engine=EvalEngine(
            WLS, config=EngineConfig(backend="scan"), device="cpu"))
    assert 50.0 not in p.homo_baseline()
    assert P_gd.run_ga_fused(p, 50.0, GAConfig(**CFG),
                             engine=_exact()) is None
    assert P_gd.run_ga_device(p, 50.0, GAConfig(**CFG),
                              engine=_exact()) is None
    with pytest.raises(ValueError, match="divisible"):
        P_gd.run_ga_fused(p, 200.0, GAConfig(**CFG), engine=_exact(),
                          islands=3)
    with pytest.raises(ValueError, match="elites"):
        P_gd.run_ga_fused(p, 200.0, GAConfig(population=4, generations=1,
                                             seed_top_k=2),
                          engine=_exact(), islands=4)


def test_default_loops_need_the_card_or_an_explicit_cpu(sweeps):
    p, _ = sweeps
    cfg = GAConfig(population=4, generations=1, seed_top_k=2)
    res = run_ga(p, 200.0, cfg, device="cpu")            # no engine
    assert res is not None and res.evaluated == 8
    assert P_gd.run_ga_fused(p, 200.0, cfg, device="cpu") is not None
    if not torch.cuda.is_available():
        for loop in ("device", "fused"):
            with pytest.raises(RuntimeError, match="CUDA"):
                run_ga(p, 200.0, cfg, loop=loop)
        with pytest.raises(RuntimeError, match="CUDA"):
            P_memo.memo_init(8, 1)
        with pytest.raises(RuntimeError, match="CUDA"):
            P_gd.fitness_device({"energy": np.ones((1, 1)),
                                 "tops_w": np.ones((1, 1)),
                                 "latency": np.ones((1, 1)),
                                 "area": np.ones(1)}, np.ones(1), 200.0)
