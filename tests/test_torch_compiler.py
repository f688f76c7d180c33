"""PyTorch port, the host compiler and the plan-table executor:
``map_graph``'s placements equal the reference's and the port's
``batched_map`` on all 20 workloads; the deterministic mapping rules of
tests/test_compiler.py hold; ``lower_plan``'s ``PlanTensor`` equals the
reference's and ``plan_from_arrays`` round-trips; ``simulate_plans`` on
the CPU is bit for bit the port's ``map_and_simulate`` and within rel 1e-9
of the reference's ``simulate_plans`` (a batch mixing two workloads of one
bucket included); and ``EvalEngine(exact_mapper="python")`` is bit for bit
the port's batched backend."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.compiler import mapper as R_mapper
from repro.core.compiler import pipeline as R_pipeline
from repro.core.dse import engine as R_engine
from repro.core.dse.encoding import decode as R_decode
from repro.core.simulator import batched as R_batched
from repro.core.workloads import build as R_build
from repro_torch.core import compiler as P_compiler
from repro_torch.core.arch import (ChipConfig, TileTemplate, hetero_bls,
                                   homogeneous_baseline)
from repro_torch.core.compiler import batched_mapper as P_bm
from repro_torch.core.compiler.mapper import UnmappableError, map_graph
from repro_torch.core.compiler.pipeline import (compile_to_table,
                                                compile_workload, lower_plan,
                                                plan_from_arrays)
from repro_torch.core.compiler.schedule import emit_schedule
from repro_torch.core.dse import api as P_api
from repro_torch.core.dse import engine as P_engine
from repro_torch.core.dse.encoding import decode, random_genomes
from repro_torch.core.ir import (OpNode, OpType, Precision, WorkloadGraph,
                                 placement_rows)
from repro_torch.core.simulator import batched as P_batched
from repro_torch.core.workloads import build, workload_names

REL_TOL = 1e-9
# three workloads of one op-table bucket (64 rows): the reference's jitted
# executor compiles once for all of this file's calls (one batch size too)
SMALL = ["kan", "snn_vgg9", "gnn_gat"]
JAX_BATCH = 16


GENOMES = random_genomes(np.random.default_rng(2026), 16)


@pytest.fixture(scope="module")
def genomes():
    return GENOMES


def _placements(pl):
    return {i: (tuple(p.tiles), p.axis) for i, p in pl.items()}


# ---------------------------------------------------------------- map_graph

@pytest.mark.parametrize("wname", workload_names())
def test_map_graph_matches_reference_and_batched_map(genomes, wname):
    g2 = genomes[:2]
    bm = P_bm.batched_map(
        P_engine.prepared_workload(wname), P_engine.genomes_to_configs(g2),
        device="cpu")
    pg = P_engine._prepared_graph(wname)
    rg = R_engine._prepared_graph(wname)
    for i, genome in enumerate(g2):
        port = _placements(map_graph(pg, decode(genome)))
        ref = _placements(R_mapper.map_graph(rg, R_decode(genome)))
        assert port == ref, (wname, i)
        assert bool(bm["ok"][i])
        assert port == placement_rows(bm["owner"][i], bm["n_split"][i],
                                      bm["split_axis"][i],
                                      bm["split_mask"][i])


def test_mapper_routes_fft_to_special_function_tile():
    g = WorkloadGraph("t", model_precision=Precision.FP16)
    g.add(OpNode("fft", OpType.FFT, elems=4096, fft_n=512,
                 precision=Precision.FP16))
    chip = hetero_bls()
    plan = compile_workload(g, chip)
    sfu_idx = [i for i, t in enumerate(chip.instances()) if t.sfu_mask]
    assert plan.placements[0].tiles[0] in sfu_idx


def test_mapper_raises_on_unmappable():
    # a chip with no DSP anywhere cannot run vector ops
    t = TileTemplate(name="macsonly", rows=8, cols=8, dsp_count=0,
                     precisions=frozenset({Precision.INT8}))
    chip = ChipConfig(name="x", tiles=((t, 2),))
    g = WorkloadGraph("t")
    g.dsp("softmax", OpType.SOFTMAX, elems=100)
    with pytest.raises(UnmappableError):
        map_graph(g, chip)
    assert P_compiler.UnmappableError is UnmappableError


def test_split_only_when_it_helps():
    # big matmul on a 2-big-tile chip should split; tiny one should not
    g = WorkloadGraph("t", model_precision=Precision.INT8)
    g.matmul("big", 4096, 4096, 4096)
    g.matmul("tiny", 8, 8, 8)
    chip = homogeneous_baseline(4)
    plan = compile_workload(g, chip)
    assert len(plan.placements[0].tiles) > 1
    assert plan.placements[0].axis in ("OC", "B", "IC")
    assert len(plan.placements[1].tiles) == 1
    nosplit = compile_workload(g, chip, enable_split=False)
    assert len(nosplit.placements[0].tiles) == 1


def test_schedule_covers_all_unfused_ops():
    g = build("resnet50_int8")
    plan = compile_workload(g, homogeneous_baseline(4))
    for i, nd in enumerate(plan.graph.nodes):
        if nd.fused_into < 0:
            assert i in plan.placements
    with pytest.raises(ValueError, match="schedule mode"):
        emit_schedule(plan.graph, plan.placements, mode="burst")
    missing = dict(plan.placements)
    missing.pop(0)
    with pytest.raises(ValueError, match="no placement"):
        emit_schedule(plan.graph, missing)


# ----------------------------------------------------- plan lowering

@functools.lru_cache(maxsize=None)
def _tables(wname, mode, n):
    """(chips, port tables, reference chips, reference tables) for the
    first ``n`` genomes."""
    gs = GENOMES[:n]
    chips = [decode(g, f"x{i}") for i, g in enumerate(gs)]
    rchips = [R_decode(g, f"x{i}") for i, g in enumerate(gs)]
    tabs = [compile_to_table(build(wname), c, mode=mode) for c in chips]
    rtabs = [R_pipeline.compile_to_table(R_build(wname), c, mode=mode)
             for c in rchips]
    return chips, tabs, rchips, rtabs


@pytest.mark.parametrize("wname", ["resnet50_int8", "hyena_1_3b"] + SMALL)
def test_lower_plan_matches_reference(genomes, wname):
    _, tabs, _, rtabs = _tables(wname, "latency", 2)
    for got, want in zip(tabs, rtabs):
        assert got.mode == want.mode and got.num_tiles == want.num_tiles
        assert got.name == want.name and got.max_ops == want.max_ops
        for f in ("owner", "n_split", "split_axis", "split_mask"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert got.ops.arrays.keys() == want.ops.arrays.keys()
        for f, a in got.ops.arrays.items():
            assert np.array_equal(a, want.ops.arrays[f]), f
        assert np.array_equal(got.ops.preds, want.ops.preds)
        assert got.aux.keys() == want.aux.keys()
        for f, a in got.aux.items():
            assert np.array_equal(a, want.aux[f]), f


def test_plan_from_arrays_round_trips():
    chip = homogeneous_baseline(4)
    for g in (build("resnet50_int8"), build("hyena_1_3b")):
        plan = compile_workload(g, chip)
        t = lower_plan(plan, chip.num_tiles)
        back = plan_from_arrays(plan.graph, t.owner, t.n_split, t.split_axis,
                                t.split_mask, mode="throughput")
        assert back.mode == "throughput"
        assert _placements(back.placements) == _placements(plan.placements)
    assert any(len(p.tiles) > 1 for p in plan.placements.values())


# ------------------------------------------------ the plan-table executor

def _assert_close(got, want, what, rel=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if np.array_equal(got, want):
        return
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert err.max() <= rel, (what, float(err.max()))


@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_simulate_plans_matches_map_and_simulate_and_jax(genomes, mode):
    """One workload per call, and a batch mixing two workloads of one
    bucket (kan, snn_vgg9) in alternating rows."""
    runs = {}
    for w in SMALL:
        chips, tabs, rchips, rtabs = _tables(w, mode, len(genomes))
        got = P_batched.simulate_plans(chips, tabs, device="cpu")
        want = P_bm.map_and_simulate(P_engine.prepared_workload(w),
                                     P_engine.genomes_to_configs(genomes),
                                     mode=mode, device="cpu")
        stack = P_batched.stack_chip_configs(chips)
        assert got["mode"] == mode
        for k, v in got.items():
            if k in ("mode", "area_mm2", "peak_tops"):
                continue
            if k in ("energy_pj", "energy_leakage_pj", "energy_ss_pj",
                     "tile_leakage_pj"):
                # leakage reads the tile areas of ``stack_chip_configs``,
                # the engine's vectorized stack differs in the last bit
                continue
            assert np.array_equal(v, want[k]), (w, mode, k)
        assert np.array_equal(got["area_mm2"], stack["chip"]["chip_area"])
        # with the engine's config stack, every key is bit for bit
        same = P_batched.batch_simulate(
            P_batched.stack_plan_tables(tabs),
            P_engine.genomes_to_configs(genomes), device="cpu")
        for k, v in same.items():
            if k != "mode":
                assert np.array_equal(v, want[k]), (w, mode, k)
        runs[w] = (chips, tabs, rchips, rtabs, got)
    # the mixed batch: kan on even rows, snn_vgg9 on odd rows
    pick = [(("kan", "snn_vgg9")[i % 2], i) for i in range(JAX_BATCH)]
    chips = [runs[w][0][i] for w, i in pick]
    tabs = [runs[w][1][i] for w, i in pick]
    mixed = P_batched.simulate_plans(chips, tabs, device="cpu")
    for k, v in mixed.items():
        if k == "mode":
            continue
        for row, (w, i) in enumerate(pick):
            assert np.array_equal(v[row], runs[w][4][k][i]), (k, row)
    want = R_batched.simulate_plans([runs[w][2][i] for w, i in pick],
                                    [runs[w][3][i] for w, i in pick])
    for k, v in mixed.items():
        if k != "mode":
            _assert_close(v, want[k], (mode, k))
    # and the gnn_gat batch against the reference's
    chips, tabs, rchips, rtabs, got = runs["gnn_gat"]
    want = R_batched.simulate_plans(rchips, rtabs)
    for k, v in got.items():
        if k != "mode":
            _assert_close(v, want[k], ("gnn_gat", mode, k))


def test_split_row_that_cannot_split_raises(genomes):
    """A plan table that splits a row ``map_graph``'s Eq. 3 test never
    splits (not a splittable MAC op) raises instead of running it on one
    tile."""
    chips, tabs, _, _ = _tables("resnet50_int8", "latency",
                                2)
    plans = P_batched.stack_plan_tables(tabs)
    cfgs = P_batched.stack_chip_configs(chips)
    dsp = int(np.flatnonzero((plans["op_cls"][0] == 1)
                             & (plans["valid"][0] > 0)
                             & (plans["fused"][0] == 0))[0])
    plans["n_split"][1, dsp] = 2
    plans["split_axis"][1, dsp] = 0
    plans["split_mask"][1, dsp, :2] = 1
    with pytest.raises(ValueError, match="Eq. 3"):
        P_batched.batch_simulate(plans, cfgs, device="cpu")
    plans = P_batched.stack_plan_tables(tabs)
    plans["owner"][0, dsp] = -1
    with pytest.raises(ValueError, match="owner"):
        P_batched.batch_simulate(plans, cfgs, device="cpu")


def test_stack_plan_tables_and_batch_simulate_refusals(genomes):
    _, tabs, _, _ = _tables("kan", "latency", 2)
    _, ttabs, _, _ = _tables("kan", "throughput", 2)
    chip = homogeneous_baseline(4)
    big = compile_to_table(build("resnet50_int8"), chip)
    with pytest.raises(ValueError, match="max_ops"):
        P_batched.stack_plan_tables([tabs[0], big])
    with pytest.raises(ValueError, match="mode"):
        P_batched.stack_plan_tables([tabs[0], ttabs[0]])
    with pytest.raises(ValueError, match="at least one"):
        P_batched.stack_plan_tables([])
    with pytest.raises(ValueError, match="one plan table per chip"):
        P_batched.simulate_plans([chip], [], device="cpu")
    plans = P_batched.stack_plan_tables(tabs)
    cfgs = P_engine.genomes_to_configs(genomes[:2])
    with pytest.raises(ValueError, match="burst"):
        P_batched.batch_simulate(plans, cfgs, mode="burst", device="cpu")


# ------------------------------------------------------------ the engine

@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_python_mapper_engine_is_the_batched_backend(genomes, mode):
    def eng(**kw):
        return P_engine.EvalEngine(
            SMALL, config=P_api.EngineConfig(mode=mode, **kw), device="cpu")

    py = eng(backend="batched", exact_mapper="python")
    got = py.evaluate(genomes)
    want = eng(backend="batched").evaluate(genomes)
    for k in ("latency", "energy", "tops_w", "area"):
        assert np.array_equal(got[k], want[k]), k
    r = py.rescore(genomes)
    assert (r["meta"]["backend"], r["meta"]["mapper"]) == ("batched",
                                                           "python")
    for k in ("latency", "energy", "tops_w", "area"):
        assert np.array_equal(r[k], want[k]), k
    assert py.evaluate(genomes)["meta"]["hit_rate"] == 1.0
