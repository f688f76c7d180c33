"""The harness on the CPU at a tiny size: the plain reference agrees with
the port, a traced run reads its spans, the control and every fault the
cells can have come out not correct, and the profiler's reduction."""
import numpy as np
import pytest
import torch

from bench import control, devtrace, harness

SEED = 2 ** 33 + 3
TINY_MIX = {"genomes_per_call": 24, "pool_calls": 2}
TINY_CHECK = {"check": {"per_call": 6, "genomes": 12}}
CELLS = ("hpu4-exact.sweep-64k", "hpu4-scan.sweep-64k")


def tiny_run(cell, trace=False, seconds=0.2):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            mix_override=TINY_MIX,
                            config_override=TINY_CHECK)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    r = tiny_run(cell)
    assert r["correct"], r["checks"]
    assert list(r["checks"]) == ["max_rel_err", "mask_mismatch"]
    assert r["attempted"] % (24 * 4) == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"evals_per_s", "peak_gib", "setup_s"}
    assert list(r)[-1] == "checks"


def test_traced_run_reads_its_spans():
    r = tiny_run("hpu4-exact.sweep-64k", trace=True)
    assert r["correct"]
    assert {"engine_host_ms", "search_ms_per_row"} <= set(r["metrics"])
    assert "scan_ms_per_row" not in r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _break(monkeypatch, cell, how):
    """Plant one fault underneath the timed path."""
    from repro_torch.core.dse import engine as eng
    if how == "answer_altered":
        name = "batch_evaluate" if "scan" in cell else "search_population"
        fn = getattr(eng, name)

        def altered(*a, **kw):
            out = fn(*a, **kw)
            for res in out if isinstance(out, list) else [out]:
                res["latency_s"] = res["latency_s"] * (1 + 1e-5)
            return out
        monkeypatch.setattr(eng, name, altered)
    elif how == "half_batch_left_out":
        sim = eng.EvalEngine._simulate

        def half(self, cfgs, genomes, mode, **kw):
            n = len(genomes)
            keep = np.arange((n + 1) // 2)
            lat, en, tw = sim(self, self._take(cfgs, keep), genomes[keep],
                              mode, **kw)
            fill = np.resize(np.arange(len(keep)), n)
            return lat[fill], en[fill], tw[fill]
        monkeypatch.setattr(eng.EvalEngine, "_simulate", half)
    elif how == "pairs_dropped":
        sim = eng.EvalEngine._simulate

        def dropped(self, cfgs, genomes, mode, **kw):
            lat, en, tw = sim(self, cfgs, genomes, mode, **kw)
            lat, en, tw = lat.copy(), en.copy(), tw.copy()
            lat[::2], en[::2], tw[::2] = np.inf, np.inf, 0.0
            return lat, en, tw
        monkeypatch.setattr(eng.EvalEngine, "_simulate", dropped)
    elif how == "stale_answers":
        ev = eng.EvalEngine.evaluate
        last = {}

        def stale(self, genomes, *a, **kw):
            out = ev(self, genomes, *a, **kw)
            prev = last.get("out")
            last["out"] = out
            if prev is None:
                return out
            return {**out, **{k: prev[k] for k in
                              ("latency", "energy", "tops_w")}}
        monkeypatch.setattr(eng.EvalEngine, "evaluate", stale)


@pytest.mark.parametrize("how, fails", [
    ("answer_altered", "max_rel_err"),
    ("half_batch_left_out", "max_rel_err"),
    ("pairs_dropped", "mask_mismatch"),
    ("stale_answers", "max_rel_err")])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(monkeypatch, cell, how, fails):
    _break(monkeypatch, cell, how)
    r = tiny_run(cell, seconds=0.5)
    assert not r["correct"], r["checks"]
    c = r["checks"][fails]
    assert c["value"] > c["limit"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_is_not_correct(cell):
    r = control.readings(cell, SEED, device="cpu",
                         mix_override={"genomes_per_call": 64},
                         config_override={"check": {"per_call": 8,
                                                    "genomes": 32}})
    assert harness.passed(r["program"]), r["program"]
    assert not harness.passed(r["control"]), r["control"]


def test_control_computes_in_float32():
    r = control.readings("hpu4-scan.sweep-64k", SEED, device="cpu",
                         mix_override={"genomes_per_call": 16},
                         config_override={"check": {"per_call": 4,
                                                    "genomes": 4}})
    assert r["checked"] == 4 and r["seconds"]["control"] > 0
    assert r["control"]["max_rel_err"]["value"] > 1e-7


def test_rate_counts_the_window_share_of_the_call_past_its_end():
    calls = [{"pairs": 100, "wall_s": 4.0, "start_s": 0.0, "end_s": 4.0},
             {"pairs": 100, "wall_s": 8.0, "start_s": 4.5, "end_s": 12.5}]
    rate = harness.reader("evals_per_s").read({"window_s": 10.0,
                                               "calls": calls})
    assert rate == pytest.approx((100 + 100 * 5.5 / 8.0) / 10.0)


def test_summarize_busy_union_and_gaps():
    host = [(0, 1000, "bench.evaluate"), (100, 600, "bench.search_population"),
            (150, 400, "aten::item")]
    device = [(200, 300, "k1"), (250, 350, "k2"), (500, 700, "k1")]
    out = devtrace.summarize(device, host, 1e-6)
    assert out["busy_s"] == pytest.approx(350e-9)
    assert out["device_s"] == pytest.approx(400e-9)
    assert out["ops"] == 3
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({
        "bench.evaluate > bench.evaluate": 400e-9,
        "bench.search_population > bench.search_population": 100e-9,
        "bench.search_population > aten::item": 150e-9})
    assert dict(out["breakdown"]["device_ops"])["k1"] == \
        pytest.approx(300e-9)


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = harness.run_cell("hpu4-scan.sweep-64k", SEED, 1.0, False,
                         mix_override={"pool_calls": 2})
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
