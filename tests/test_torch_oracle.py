"""PyTorch port, the ChipSim oracle (host numpy): ``ActivationCache``,
``TileSim``, the per-module wrappers, ``ChipSim``'s full result surface
(``golden_dict``, ``summary``, the chrome trace) and the NVDLA reference
chips equal the JAX package's bit for bit; the oracle reproduces the twelve
aggregate golden traces (read directly, at the conftest comparator's rtol
1e-6, atol 1e-12); the plan-table executor agrees with it within rel 1e-9
(the reference's own ``REL_TOL``); and ``EvalEngine(backend="oracle")`` and
``rescore(oracle=True)`` score what the reference's oracle engine scores."""
import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compile_workload as R_compile
from repro.core import simulate as R_simulate
from repro.core.arch import hetero_bls as R_hetero_bls
from repro.core.arch import homogeneous_baseline as R_homogeneous
from repro.core.calibrate import nvdla as R_nvdla
from repro.core.compiler import mapper as R_mapper
from repro.core.dse import api as R_api
from repro.core.dse import engine as R_engine
from repro.core.simulator import costs as R_costs
from repro.core.simulator import modules as R_modules
from repro.core.simulator import tile as R_tile
from repro.core.workloads import build as R_build
from repro_torch.core import simulator as P_simulator
from repro_torch.core.arch import hetero_bls, homogeneous_baseline
from repro_torch.core.calibrate import DEFAULT_CALIB
from repro_torch.core.calibrate import nvdla as P_nvdla
from repro_torch.core.compiler import mapper as P_mapper
from repro_torch.core.compiler.pipeline import compile_workload, lower_plan
from repro_torch.core.dse import api as P_api
from repro_torch.core.dse import engine as P_engine
from repro_torch.core.dse.encoding import random_genomes
from repro_torch.core.ir import OpType
from repro_torch.core.simulator import batched as P_batched
from repro_torch.core.simulator import costs as P_costs
from repro_torch.core.simulator import modules as P_modules
from repro_torch.core.simulator import tile as P_tile
from repro_torch.core.simulator.orchestrator import ChipSim, simulate
from repro_torch.core.workloads import build

GOLDEN = ["resnet50_int8", "vit_b16_fp16", "llama7b_int4", "snn_vgg9",
          "hyena_1_3b", "kan"]
GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
REL_TOL = 1e-9
WORKLOADS = ["kan", "snn_vgg9", "gnn_gat"]
ENERGY_MODULES = ("compute", "dram", "sram", "irf", "orf", "dsp", "special",
                  "noc", "leakage", "fuse_savings")


@pytest.fixture(scope="module")
def genomes():
    return random_genomes(np.random.default_rng(2026), 16)


# ------------------------------------------------------- activation cache

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_activation_cache_matches_reference_and_fifo_insert(seed):
    """Random insert sequences over four tiles: the port's class, the
    reference's class and the port's ``fifo_insert`` hold the same entries
    and the same op -> tile map after every insert."""
    rng = np.random.default_rng(seed)
    caps = rng.choice([4096.0, 16384.0, 65536.0], size=4)
    n_ops = 96
    port = [P_costs.ActivationCache(i, c) for i, c in enumerate(caps)]
    ref = [R_costs.ActivationCache(i, c) for i, c in enumerate(caps)]
    at_p, at_r = {}, {}
    S = P_costs.ACT_CACHE_SLOTS
    fifo_ops = torch.full((1, P_batched.MAX_TILES, S), -1, dtype=torch.long)
    fifo_b = torch.zeros((1, P_batched.MAX_TILES, S), dtype=torch.float64)
    cached = torch.full((1, n_ops + 1), -1, dtype=torch.long)
    for op in range(n_ops):
        t = int(rng.integers(0, 4))
        nbytes = float(rng.choice([0.0, 512.0, 3000.0, 9000.0, 70000.0,
                                   float(rng.integers(1, 20000))]))
        port[t].insert(op, nbytes, at_p)
        ref[t].insert(op, nbytes, at_r)
        P_batched.fifo_insert(fifo_ops, fifo_b, cached,
                              torch.tensor([[t]]), op, nbytes,
                              torch.tensor([[caps[t]]], dtype=torch.float64))
        assert at_p == at_r
        for i in range(4):
            assert list(port[i].entries) == list(ref[i].entries)
            assert port[i].used == ref[i].used
            ops = [int(o) for o in fifo_ops[0, i] if o >= 0]
            assert ops == [e[0] for e in port[i].entries], (op, i)
        want = np.full(n_ops, -1)
        for k, v in at_p.items():
            want[k] = v
        assert np.array_equal(cached[0, :n_ops].numpy(), want), op


# ------------------------------------------------------------ TileSim

def _op_of(wname, op_type):
    g = build(wname)
    rg = R_build(wname)
    for i, nd in enumerate(g.nodes):
        if nd.op_type == op_type:
            return nd, rg.nodes[i]
    raise LookupError(op_type)


# one op per class, and each special-function op
_TILE_OPS = [("resnet50_int8", OpType.CONV2D), ("resnet50_int8", OpType.ADD),
             ("hyena_1_3b", OpType.FFT), ("snn_vgg9", OpType.SNN_LIF),
             ("kan", OpType.POLY)]


@pytest.mark.parametrize("wname,op_type", _TILE_OPS,
                         ids=[t.name for _, t in _TILE_OPS])
def test_tilesim_execute_matches_reference(wname, op_type):
    p_op, r_op = _op_of(wname, op_type)
    chips = [(hetero_bls(), R_hetero_bls()),
             (homogeneous_baseline(2), R_homogeneous(2))]
    for p_chip, r_chip in chips:
        for p_t, r_t in zip(p_chip.instances(), r_chip.instances()):
            ps, rs = P_tile.TileSim(p_t), R_tile.TileSim(r_t)
            assert ps.supports(p_op) == rs.supports(r_op)
            for bw in (8.0, 64.0):
                assert ps.roofline_cycles(p_op, bw) == \
                    rs.roofline_cycles(r_op, bw)
                for rd, wr in ((0.0, 0.0), (1e5, 3e3)):
                    got = dataclasses.asdict(ps.execute(p_op, bw, rd, wr))
                    want = dataclasses.asdict(rs.execute(r_op, bw, rd, wr))
                    assert got == want, (p_t.name, bw, rd, wr)


def test_module_wrappers_match_reference():
    for p_t, r_t in zip(hetero_bls().instances(), R_hetero_bls().instances()):
        assert P_modules.tile_cost_dict(p_t) == R_modules.tile_cost_dict(r_t)
        for m, k, n in ((128, 64, 64), (1, 4096, 4096), (3136, 576, 64)):
            assert int(P_modules.pick_dataflow(p_t, m, k, n)) == \
                int(R_modules.pick_dataflow(r_t, m, k, n))
            tiling = P_modules.mac_tiling(p_t, m, k, n, 1.0)
            assert tiling == R_modules.mac_tiling(r_t, m, k, n, 1.0)
            assert P_modules.mac_cycles(p_t, m, k, n, 1.5, *tiling) == \
                R_modules.mac_cycles(r_t, m, k, n, 1.5, *tiling)
            for df in range(3):
                assert P_modules.sram_traffic(df, m, k, n, 2.0, *tiling) == \
                    R_modules.sram_traffic(df, m, k, n, 2.0, *tiling)
        for op_type in (int(OpType.SOFTMAX), int(OpType.SSM_SCAN)):
            assert P_modules.dsp_cycles_energy(
                p_t, op_type, 65536.0, 256.0, DEFAULT_CALIB) == \
                R_modules.dsp_cycles_energy(r_t, op_type, 65536.0, 256.0,
                                            DEFAULT_CALIB)
        for op_type in (int(OpType.FFT), int(OpType.SNN_LIF),
                        int(OpType.POLY)):
            assert P_modules.sfu_cycles_energy(
                p_t, op_type, 8192.0, 512.0, 8.0, 4.0, DEFAULT_CALIB) == \
                R_modules.sfu_cycles_energy(r_t, op_type, 8192.0, 512.0, 8.0,
                                            4.0, DEFAULT_CALIB)
        for rd, wr in ((0.0, 0.0), (100.0, 0.0), (1e6, 4097.0)):
            assert P_modules.dram_cycles_energy(rd, wr, 16.0, 1e9,
                                                DEFAULT_CALIB) == \
                R_modules.dram_cycles_energy(rd, wr, 16.0, 1e9,
                                             DEFAULT_CALIB)


# ------------------------------------------------------------- ChipSim

@functools.lru_cache(maxsize=None)
def _port_run(wname, mode):
    plan = compile_workload(build(wname), hetero_bls(), mode=mode)
    return plan, simulate(hetero_bls(), plan)


@functools.lru_cache(maxsize=None)
def _ref_run(wname, mode):
    return R_simulate(R_hetero_bls(),
                      R_compile(R_build(wname), R_hetero_bls(), mode=mode))


def _golden_diffs(ref, new, path=""):
    """Leaves of two golden payloads that differ beyond rtol 1e-6, atol
    1e-12 (the conftest comparator's default)."""
    if isinstance(ref, dict):
        if set(ref) != set(new):
            return [f"{path}: keys {sorted(set(ref) ^ set(new))}"]
        return [d for k in ref for d in _golden_diffs(ref[k], new[k],
                                                      f"{path}.{k}")]
    if isinstance(ref, list):
        if len(ref) != len(new):
            return [f"{path}: length"]
        return [d for i, (r, n) in enumerate(zip(ref, new))
                for d in _golden_diffs(r, n, f"{path}[{i}]")]
    if isinstance(ref, (bool, str)) or isinstance(new, (bool, str)):
        return [] if ref == new else [f"{path}: {ref!r} -> {new!r}"]
    return [] if np.isclose(ref, new, rtol=1e-6, atol=1e-12) \
        else [f"{path}: {ref!r} -> {new!r}"]


@pytest.mark.parametrize("mode", ["latency", "throughput"])
@pytest.mark.parametrize("wname", GOLDEN)
def test_chipsim_matches_reference_and_golden(wname, mode):
    _, r = _port_run(wname, mode)
    want = _ref_run(wname, mode)
    assert r.golden_dict() == want.golden_dict()
    assert r.summary() == want.summary()
    assert json.loads(r.chrome_trace()) == json.loads(want.chrome_trace())
    if mode == "throughput":
        assert json.loads(r.chrome_trace(batches=3)) == \
            json.loads(want.chrome_trace(batches=3))
    else:
        with pytest.raises(ValueError, match="throughput"):
            r.chrome_trace(batches=2)
    suffix = "" if mode == "latency" else "_throughput"
    g = json.loads((GOLDEN_DIR / f"{wname}{suffix}.json").read_text())
    assert not _golden_diffs(g, r.golden_dict())


@pytest.mark.parametrize("mode", ["latency", "throughput"])
@pytest.mark.parametrize("wname", GOLDEN)
def test_plan_tables_match_oracle_on_golden_runs(wname, mode):
    """The plan-table executor on the oracle's own plans: within rel 1e-9
    of the oracle per module, per-tile op counts and gating equal."""
    plan, r = _port_run(wname, mode)
    chip = hetero_bls()
    res = P_batched.simulate_plans([chip], [lower_plan(plan, chip.num_tiles)],
                                   device="cpu")
    assert res["mode"] == mode
    pairs = [("latency_s", r.latency_s), ("energy_pj", r.energy_pj),
             ("achieved_tops", r.achieved_tops), ("area_mm2", r.area_mm2),
             ("peak_tops", r.peak_tops)]
    pairs += [(f"energy_{m}_pj", getattr(r.energy_breakdown, m))
              for m in ENERGY_MODULES]
    pairs += [(k, v) for k, v in (r.pipeline or {}).items()]
    for k, want in pairs:
        assert float(res[k][0]) == pytest.approx(want, rel=REL_TOL,
                                                 abs=1e-9), k
    n = len(r.tiles)
    assert res["tile_ops"][0][:n].tolist() == [b.ops for b in r.tiles]
    assert res["power_gated"][0][:n].tolist() == \
        [b.power_gated for b in r.tiles]
    np.testing.assert_allclose(res["tile_active_s"][0][:n],
                               [b.active_s for b in r.tiles], rtol=REL_TOL)


def test_chipsim_refuses_link_fidelity_and_unknown_modes():
    plan, _ = _port_run("kan", "latency")
    with pytest.raises(ValueError, match="fidelity"):
        ChipSim(hetero_bls(), fidelity="cycle")
    bad = dataclasses.replace(plan, mode="burst")
    with pytest.raises(ValueError, match="burst"):
        simulate(hetero_bls(), bad)


def test_simulator_package_exports_load_on_use():
    assert P_simulator.ChipSim is ChipSim
    assert P_simulator.simulate is simulate
    assert P_simulator.ActivationCache is P_costs.ActivationCache
    assert set(P_simulator.__all__) >= {"SimResult", "ChipSim", "simulate",
                                        "TileSim", "ActivationCache"}
    with pytest.raises(AttributeError):
        P_simulator.nope


# --------------------------------------------------------------- NVDLA

def _gemm64(ir):
    g = ir.WorkloadGraph("gemm64", model_precision=ir.Precision.INT8)
    g.add(ir.OpNode("gemm", ir.OpType.MATMUL, m=64, k=64, n=64,
                    precision=ir.Precision.INT8, splittable=False))
    return g


@pytest.mark.parametrize("point", ["NVDLA_SMALL", "NVDLA_FULL"])
def test_nvdla_points_and_chips_match_reference(point):
    import repro.core.ir as R_ir
    import repro_torch.core.ir as P_ir
    p, r = getattr(P_nvdla, point), getattr(R_nvdla, point)
    pd, rd = dataclasses.asdict(p), dataclasses.asdict(r)
    assert pd.pop("precisions") == rd.pop("precisions")
    assert pd == rd
    pc, rc = P_nvdla.nvdla_chip(p), R_nvdla.nvdla_chip(r)
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    got = simulate(pc, compile_workload(_gemm64(P_ir), pc))
    want = R_simulate(rc, R_compile(_gemm64(R_ir), rc))
    assert got.golden_dict() == want.golden_dict()
    assert got.summary() == want.summary()


# -------------------------------------------------------------- engine

def _port(mode, **kw):
    return P_engine.EvalEngine(
        WORKLOADS, config=P_api.EngineConfig(mode=mode, **kw), device="cpu")


def _ref(mode, **kw):
    return R_engine.EvalEngine(
        WORKLOADS, config=R_api.EngineConfig(mode=mode, **kw))


_COLS = ("latency", "energy", "tops_w", "area")


@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_oracle_engine_matches_reference(genomes, mode):
    genomes = genomes[:8]
    got = _port(mode, backend="oracle").evaluate(genomes)
    want = _ref(mode, backend="oracle").evaluate(genomes)
    for k in _COLS:
        assert np.array_equal(got[k], want[k]), k
    assert np.isfinite(got["latency"]).all()
    assert got["meta"]["backend"] == "oracle"
    # rescore(oracle=True) through a batched engine: the same rows
    port = _port(mode, backend="batched")
    r = port.rescore(genomes, oracle=True)
    for k in _COLS[:3]:
        assert np.array_equal(r[k], got[k]), k
    wr = _ref(mode, backend="batched").rescore(genomes, oracle=True)
    for k in _COLS:         # areas of fewer than 16 genomes come per chip
        assert np.array_equal(r[k], wr[k]), k
    assert r["meta"] == wr["meta"]
    assert (r["meta"]["backend"], r["meta"]["mapper"]) == ("oracle", "python")
    # and within rel 1e-9 of the batched backend's rows
    b = port.evaluate(genomes)
    assert np.array_equal(b["latency"], got["latency"])
    for k in ("energy", "tops_w"):
        err = np.abs(b[k] - got[k]) / np.maximum(np.abs(got[k]), 1e-300)
        assert err.max() <= REL_TOL, (k, err.max())


def test_unmappable_pairs_score_inf(genomes, monkeypatch):
    """A (genome, workload) pair that ``map_graph`` cannot map scores inf
    latency and energy and 0 TOPS/W on the oracle and the python-mapper
    paths, as in the reference."""
    def refusing(module):
        real = module.map_graph

        def map_graph(g, chip, *a, **kw):
            if g.name == "snn_vgg9" and chip.name in ("x1", "x4"):
                raise module.UnmappableError("no tile")
            return real(g, chip, *a, **kw)
        return map_graph

    monkeypatch.setattr(P_engine, "map_graph", refusing(P_mapper))
    monkeypatch.setattr(R_mapper, "map_graph", refusing(R_mapper))
    g = genomes[:6]
    got = _port("latency", backend="oracle").evaluate(g)
    want = _ref("latency", backend="oracle").evaluate(g)
    py = _port("latency", backend="batched",
               exact_mapper="python").rescore(g)
    for res in (got, py):
        assert np.isinf(res["latency"][[1, 4], 1]).all()
        assert np.isinf(res["energy"][[1, 4], 1]).all()
        assert (res["tops_w"][[1, 4], 1] == 0).all()
        assert np.isfinite(res["latency"][[0, 2, 3, 5]]).all()
    for k in _COLS:
        assert np.array_equal(got[k], want[k]), k

