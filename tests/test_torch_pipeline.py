"""PyTorch port, the §4 pipeline (A11, first half): ``run_pipeline`` on a
tiny study (kan, seed 0, two brackets) against the JAX package's with
the reference's ``jax.random`` draws replayed -- the same stage events,
best genomes and front genomes, points within rel 1e-9 -- and the fused
loop (one island) against the reference's; then the checkpoints on the
port alone: an interrupted then resumed study bit for bit an
uninterrupted one, a complete directory replaying with no engine work, a
changed study refused, and ``run_digest`` sensitive to every parameter."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.dse import api as R_api  # noqa: E402
from repro.core.dse import engine as R_engine  # noqa: E402
from repro.core.dse import ga as R_ga  # noqa: E402
from repro.core.dse import ga_device as R_gd  # noqa: E402
from repro.core.dse import pipeline as R_pipe  # noqa: E402
from repro.core.dse import sweep as R_sweep  # noqa: E402
from repro_torch.core.dse.api import EngineConfig  # noqa: E402
from repro_torch.core.dse.checkpoint import (CheckpointMismatch,  # noqa: E402
                                             PipelineCheckpoint, run_digest)
from repro_torch.core.dse.encoding import GENOME_LEN  # noqa: E402
from repro_torch.core.dse.engine import EvalEngine  # noqa: E402
from repro_torch.core.dse.ga import GAConfig  # noqa: E402
from repro_torch.core.dse.ga_device import run_ga_fused  # noqa: E402
from repro_torch.core.dse.pareto import pareto_mask  # noqa: E402
from repro_torch.core.dse.pipeline import run_pipeline  # noqa: E402
from repro_torch.core.dse.store import SqliteStore  # noqa: E402

from test_torch_device_search import JaxDraws  # noqa: E402

WLS = ["kan"]
CFG = dict(population=16, generations=3, seed_top_k=8, early_stop=100)
KW = dict(seeds=(0,), brackets=(100.0, 200.0), samples_per_stratum=4)
REL_TOL = 1e-9


def _exact():
    return EvalEngine(WLS, config=EngineConfig(backend="exact",
                                               nonfinite="skip"),
                      device="cpu")


def _brief(ev):
    return (ev["stage"], ev.get("seed"), ev.get("bracket"),
            ev.get("configs"), ev.get("generations"), ev.get("drained"),
            ev.get("skipped"), ev.get("resumed"))


@pytest.fixture(scope="module")
def studies():
    """The tiny study on both packages, one island each."""
    ev_p, ev_r = [], []
    p = run_pipeline(WLS, cfg=GAConfig(**CFG), engine=_exact(), islands=1,
                     on_stage=ev_p.append, draws=JaxDraws, **KW)
    r = R_pipe.run_pipeline(WLS, cfg=R_ga.GAConfig(**CFG),
                            engine=R_engine.EvalEngine(
                                WLS, config=R_api.EngineConfig(
                                    backend="exact", nonfinite="skip")),
                            islands=1, on_stage=ev_r.append, **KW)
    return p, ev_p, r, ev_r


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300),
                        initial=0.0))


def test_pipeline_matches_the_reference(studies):
    p, ev_p, r, ev_r = studies
    assert [_brief(e) for e in ev_p] == [_brief(e) for e in ev_r]
    for a, b in zip(ev_p, ev_r):
        if "best_fitness" in b:
            assert _rel(a["best_fitness"], b["best_fitness"]) <= REL_TOL
            assert np.array_equal(a["front"]["genomes"],
                                  b["front"]["genomes"])
            assert _rel(a["front"]["points"], b["front"]["points"]) \
                <= REL_TOL
    assert np.array_equal(p.sweeps[0].genomes, r.sweeps[0].genomes)
    assert p.results[0].keys() == r.results[0].keys()
    for b, want in r.results[0].items():
        got = p.results[0][b]
        assert np.array_equal(got.best_genome, want.best_genome), b
        assert got.evaluated == want.evaluated
        assert _rel(got.history, want.history) <= REL_TOL
    assert np.array_equal(p.front_genomes, r.front_genomes)
    assert p.front_points.shape == r.front_points.shape
    assert _rel(p.front_points, r.front_points) <= REL_TOL
    assert p.evaluated == r.evaluated


def test_pipeline_front_and_accounting(studies):
    res, events, _, _ = studies
    stages = [e["stage"] for e in events]
    assert stages == ["sweep", "refine", "refine", "seed_done"]
    assert res.front_points.shape[1] == 3
    assert res.front_genomes.shape == (len(res.front_points), GENOME_LEN)
    assert np.all(np.diff(res.front_points[:, 0]) >= 0)
    assert pareto_mask(res.front_points).all()
    last = [e for e in events if e["stage"] == "refine"][-1]
    assert np.array_equal(last["front"]["points"], res.front_points)
    for b in KW["brackets"]:
        assert res.best(b) is res.results[0][b]
    assert res.evaluated == sum(r.evaluated
                                for r in res.results[0].values())
    assert events[-1]["drained"] > 0
    assert set(res.stage_seconds) == {"sweep", "refine", "merge"}


def test_fused_loop_matches_the_reference(studies):
    p, _, _, _ = studies
    sw = p.sweeps[0]
    ref_sw = R_sweep.SweepResult(**{f.name: getattr(sw, f.name)
                                    for f in dataclasses.fields(sw)})
    got = run_ga_fused(sw, 200.0, GAConfig(**CFG), seed=1, engine=_exact(),
                       islands=1, draws=JaxDraws)
    want = R_gd.run_ga_fused(ref_sw, 200.0, R_ga.GAConfig(**CFG), seed=1,
                             engine=R_engine.EvalEngine(
                                 WLS, config=R_api.EngineConfig(
                                     backend="exact")), islands=1)
    assert np.array_equal(got.result.best_genome, want.result.best_genome)
    assert got.result.evaluated == want.result.evaluated
    assert _rel(got.result.history, want.result.history) <= REL_TOL
    assert np.array_equal(got.population, want.population)
    for k in ("latency", "energy", "tops_w", "area"):
        assert _rel(got.pop_metrics[k][np.isfinite(want.pop_metrics[k])],
                    want.pop_metrics[k][np.isfinite(want.pop_metrics[k])]) \
            <= REL_TOL


def test_pipeline_validation():
    with pytest.raises(ValueError, match="exact"):
        run_pipeline(WLS, seeds=(0,), brackets=(200.0,),
                     samples_per_stratum=2,
                     engine=EvalEngine(WLS, device="cpu"))

    class OtherContext:         # a cluster whose workers serve elsewhere
        def check_workloads(self, workloads, calib=None):
            return self

        def context_key(self):
            return bytes(32)

    with pytest.raises(ValueError, match="context"):
        run_pipeline(WLS, seeds=(0,), cluster=OtherContext(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_pipeline(WLS, seeds=(0,), brackets=(200.0,),
                         samples_per_stratum=2)


# ------------------------------------------------------------- checkpoints

CK = dict(seeds=(0, 1), brackets=(100.0, 200.0), samples_per_stratum=2,
          cfg=GAConfig(population=8, generations=2, seed_top_k=4,
                       early_stop=10_000), device="cpu")


def _same_study(ref, res):
    assert ref.front_points.tobytes() == res.front_points.tobytes()
    assert ref.front_genomes.tobytes() == res.front_genomes.tobytes()
    assert ref.evaluated == res.evaluated
    for s in CK["seeds"]:
        assert ref.sweeps[s].genomes.tobytes() == res.sweeps[s].genomes.tobytes()
        assert set(ref.results[s]) == set(res.results[s])
        for b, r in ref.results[s].items():
            q = res.results[s][b]
            assert r.best_fitness == q.best_fitness, (s, b)
            assert r.best_genome.tobytes() == q.best_genome.tobytes()
            assert r.history == q.history, (s, b)
            for k in ("latency", "energy", "tops_w"):
                assert np.asarray(r.best_metrics[k]).tobytes() == \
                    np.asarray(q.best_metrics[k]).tobytes(), (s, b, k)


class _Interrupt(Exception):
    pass


@pytest.fixture(scope="module")
def uninterrupted():
    return run_pipeline(WLS, **CK)


@pytest.mark.parametrize("stop_after", [1, 3, 5])
def test_interrupted_resume_bit_for_bit(tmp_path, uninterrupted,
                                        stop_after):
    ck = str(tmp_path / "ck")
    seen = []

    def tripwire(ev):
        seen.append(ev["stage"])
        if len(seen) == stop_after:
            raise _Interrupt

    with pytest.raises(_Interrupt):
        run_pipeline(WLS, checkpoint=ck, on_stage=tripwire, **CK)
    assert not [f for f in os.listdir(ck) if f.endswith(".tmp")]
    events = []
    res = run_pipeline(WLS, checkpoint=ck, on_stage=events.append, **CK)
    resumed = [e["stage"] for e in events if e.get("resumed")]
    assert resumed[:len(seen)] == seen        # record before emit
    _same_study(uninterrupted, res)
    # a complete directory replays every stage: no engine work at all
    eng = EvalEngine(WLS, config=EngineConfig(backend="exact",
                                              nonfinite="skip"),
                     device="cpu")
    replay_events = []
    replay = run_pipeline(WLS, engine=eng, checkpoint=ck,
                          on_stage=replay_events.append, **CK)
    assert eng.stats.dispatches == 0
    assert all(e.get("resumed") for e in replay_events)
    _same_study(uninterrupted, replay)
    st = SqliteStore(os.path.join(ck, "results.sqlite"))
    assert len(st) > 0 and set(st.version_counts()) == {st.version}
    st.close()


def test_checkpoint_digest_guards_study_identity(tmp_path):
    ck = str(tmp_path / "ck")
    small = dict(CK, seeds=(0,), brackets=(200.0,))
    run_pipeline(WLS, checkpoint=ck, **small)
    run_pipeline(WLS, checkpoint=ck, **small)       # same study: resumes
    with pytest.raises(CheckpointMismatch):
        run_pipeline(WLS, checkpoint=ck, **dict(small, seeds=(1,)))
    with pytest.raises(CheckpointMismatch):
        run_pipeline(WLS, checkpoint=ck, **dict(small, cfg=GAConfig(
            population=10, generations=2, seed_top_k=4, early_stop=10_000)))


def test_checkpoint_record_load_round_trip(tmp_path):
    ck = PipelineCheckpoint(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError):
        ck.record("sweep:0", x=np.arange(3))        # open() must run first
    ck.open("digest-a")
    arr = np.array([5e-324, 1e308, -0.0, np.inf])
    ck.record("refine:0:100", vals=arr, n=np.int64(4))
    assert ck.has("refine:0:100") and not ck.has("sweep:0")
    ck2 = PipelineCheckpoint(ck.path).open("digest-a")
    assert ck2.completed() == ["refine:0:100"]
    got = ck2.load("refine:0:100")
    assert got["vals"].tobytes() == arr.tobytes() and int(got["n"]) == 4
    with pytest.raises(CheckpointMismatch):
        PipelineCheckpoint(ck.path).open("digest-b")
    assert isinstance(ck.open_store().back, SqliteStore)


def test_run_digest_sensitivity():
    eng = _exact()
    cfg = GAConfig(**CFG)
    args = ((0, 1), (100.0,), 4, cfg, None, 5, 2)
    base = run_digest(eng, *args)
    assert base == run_digest(eng, *args)
    changed = [((0, 2), (100.0,), 4, cfg, None, 5, 2),
               ((0, 1), (200.0,), 4, cfg, None, 5, 2),
               ((0, 1), (100.0,), 8, cfg, None, 5, 2),
               ((0, 1), (100.0,), 4, dataclasses.replace(cfg, tournament=3),
                None, 5, 2),
               ((0, 1), (100.0,), 4, cfg, 2, 5, 2),
               ((0, 1), (100.0,), 4, cfg, None, 4, 2),
               ((0, 1), (100.0,), 4, cfg, None, 5, 1)]
    digests = {run_digest(eng, *a) for a in changed}
    assert base not in digests and len(digests) == len(changed)
    other = EvalEngine(["resnet50_int8"], config=EngineConfig(
        backend="exact"), device="cpu")
    assert base != run_digest(other, *args)
    thr = EvalEngine(WLS, config=EngineConfig(backend="exact",
                                              mode="throughput"),
                     device="cpu")
    assert base != run_digest(thr, *args)
