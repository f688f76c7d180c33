"""PyTorch port, the link fidelity tier (A5-link): the XY route masks, the
DRAM channel selectors and ``pipeline_bounds``' link arm bit for bit
against the JAX package's (numpy, and torch on the CPU); ``ChipSim(
fidelity="link")`` bit for bit the reference oracle and within the
golden comparator's rtol of the six ``*_link.json`` traces (read
directly); the plan-table executor and ``map_and_simulate`` within rel
1e-9 of the oracle on them, and the search's link bounds bit for bit the
reference's ``map_and_simulate``; the exact, batched and python-mapper engines
bit for bit each other on the link tier, the oracle engine within rel
1e-9 of the reference's exact link engine; and II(link) >= II(aggregate)
with the latency columns unchanged."""
import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compile_workload as R_compile  # noqa: E402
from repro.core import simulate as R_simulate  # noqa: E402
from repro.core.arch import hetero_bls as R_hetero_bls  # noqa: E402
from repro.core.compiler import batched_mapper as R_bm  # noqa: E402
from repro.core.dse import api as R_api  # noqa: E402
from repro.core.dse import engine as R_engine  # noqa: E402
from repro.core.simulator import costs as R_costs  # noqa: E402
from repro.core.workloads import build as R_build  # noqa: E402
from repro_torch.core.arch import hetero_bls  # noqa: E402
from repro_torch.core.compiler import batched_mapper as P_bm  # noqa: E402
from repro_torch.core.compiler.pipeline import (compile_workload,  # noqa: E402
                                                lower_plan)
from repro_torch.core.dse import api as P_api  # noqa: E402
from repro_torch.core.dse import engine as P_engine  # noqa: E402
from repro_torch.core.dse.encoding import random_genomes  # noqa: E402
from repro_torch.core.simulator import batched as P_batched  # noqa: E402
from repro_torch.core.simulator import costs as P_costs  # noqa: E402
from repro_torch.core.simulator.orchestrator import simulate  # noqa: E402
from repro_torch.core.workloads import build  # noqa: E402

GOLDEN = ["resnet50_int8", "vit_b16_fp16", "llama7b_int4", "snn_vgg9",
          "hyena_1_3b", "kan"]
GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
WORKLOADS = ["kan", "snn_vgg9", "gnn_gat"]
MODES = ["latency", "throughput"]
REL_TOL = 1e-9
_COLS = ("latency", "energy", "tops_w")


@pytest.fixture(scope="module")
def genomes():
    return random_genomes(np.random.default_rng(2026), 16)


# ------------------------------------------------------------ cost helpers

def _grid_cases():
    """Every (src, dst) on grids 1x1 to 4x4, src from -1 (no tile)."""
    src, dst, w, h = [], [], [], []
    for gw in range(1, 5):
        for gh in range(1, 5):
            n = gw * gh
            s, d = np.meshgrid(np.arange(-1, n), np.arange(n), indexing="ij")
            src.append(s.ravel())
            dst.append(d.ravel())
            w.append(np.full(s.size, gw))
            h.append(np.full(s.size, gh))
    return [np.concatenate(a).astype(np.float64) for a in (src, dst, w, h)]


@pytest.mark.parametrize("torus", [0.0, 1.0])
def test_xy_route_link_mask_matches_reference(torus):
    src, dst, w, h = _grid_cases()
    want = R_costs.xy_route_link_mask(np, src, dst, w, h, torus)
    assert want.shape == (len(src), P_costs.MAX_LINKS)
    assert want[src < 0].sum() == 0
    got = P_costs.xy_route_link_mask(src, dst, w, h, torus)
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    t = [torch.from_numpy(a) for a in (src, dst, w, h)]
    got_t = P_costs.xy_route_link_mask(*t, torch.tensor(torus))
    assert got_t.dtype == torch.float64
    assert np.array_equal(got_t.numpy(), want)


def test_dram_channels_and_pipeline_link_arm_match_reference():
    tiles = np.arange(-1, P_costs.MAX_DRAM_CHANNELS * 2, dtype=np.float64)
    for n in (1.0, 2.0, 3.0, 8.0, 11.0):
        want = R_costs.dram_channel_one_hot(np, tiles, n)
        assert np.array_equal(P_costs.dram_channel_one_hot(tiles, n), want)
        got_t = P_costs.dram_channel_one_hot(torch.from_numpy(tiles),
                                             torch.tensor(n))
        assert np.array_equal(got_t.numpy(), want)
    rng = np.random.default_rng(5)
    chan = rng.uniform(0, 1e7, (6, P_costs.MAX_DRAM_CHANNELS))
    links = rng.uniform(0, 1e-3, (6, P_costs.MAX_LINKS))
    args = dict(makespan_s=rng.uniform(0, 2e-3, 6),
                tile_busy_max_s=rng.uniform(0, 1e-3, 6),
                dram_bytes=rng.uniform(0, 1e8, 6),
                dram_gbps=rng.choice([64.0, 256.0], 6),
                noc_busy_s=rng.uniform(0, 1e-3, 6))
    ch = rng.choice([1.0, 2.0, 4.0, 8.0], 6)
    want = R_costs.pipeline_bounds(np, **args, chan_bytes=chan,
                                   dram_channels=ch, link_busy_s=links)
    got = P_costs.pipeline_bounds(**args, chan_bytes=chan, dram_channels=ch,
                                  link_busy_s=links)
    assert set(got) == set(want) and "ii_link_bound_s" in got
    t = {k: torch.from_numpy(v)[:, None] for k, v in args.items()}
    got_t = P_costs.pipeline_bounds(
        **t, chan_bytes=torch.from_numpy(chan),
        dram_channels=torch.from_numpy(ch)[:, None],
        link_busy_s=torch.from_numpy(links))
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(got_t[k].reshape(-1).numpy(), want[k]), k
    agg = P_costs.pipeline_bounds(**args)
    assert set(agg) == set(want) - {"ii_chan_bound_s", "ii_link_bound_s"}
    assert (want["ii_s"] >= agg["ii_s"]).all()


# ------------------------------------------------------ the oracle, plans

def _link_chip(base=hetero_bls):
    """tests/test_golden_traces.py's topology-exercising chip."""
    return dataclasses.replace(base(), name="heteroBLS-link", torus=True,
                               grid_aspect=2.0, dram_channels=2,
                               noc_bytes_per_cycle=32.0)


@functools.lru_cache(maxsize=None)
def _port_run(wname):
    chip = _link_chip()
    plan = compile_workload(build(wname), chip, mode="throughput")
    return chip, plan, simulate(chip, plan, fidelity="link")


def _golden_diffs(ref, new, path=""):
    """Leaves that differ beyond the conftest comparator's rtol 1e-6, atol
    1e-12."""
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


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


@pytest.mark.parametrize("wname", GOLDEN)
def test_link_oracle_golden_and_plan_paths(wname):
    chip, plan, r = _port_run(wname)
    rchip = _link_chip(base=R_hetero_bls)
    want = R_simulate(rchip, R_compile(R_build(wname), rchip,
                                       mode="throughput"), fidelity="link")
    assert r.golden_dict() == want.golden_dict()
    g = json.loads((GOLDEN_DIR / f"{wname}_link.json").read_text())
    assert not _golden_diffs(g, r.golden_dict())
    pipe = r.pipeline
    assert pipe["ii_s"] >= simulate(chip, plan).pipeline["ii_s"]
    # the plan tables and the compile-free map + execute, on the link tier
    res = P_batched.simulate_plans([chip], [lower_plan(plan, chip.num_tiles)],
                                   fidelity="link", device="cpu")
    ms = P_bm.map_and_simulate(P_engine.prepared_workload(wname),
                               P_batched.stack_chip_configs([chip]),
                               mode="throughput", fidelity="link",
                               device="cpu")
    assert ms["ok"][0]
    for k, v in pipe.items():
        assert _rel(float(res[k][0]), v) <= REL_TOL, k
        assert _rel(float(ms[k][0]), v) <= REL_TOL, k
    assert _rel(float(res["energy_pj"][0]), r.energy_pj) <= REL_TOL


def test_search_surface_gains_link_bounds(genomes):
    """The search's link surface: ``map_and_simulate``'s, and its two link
    bounds and II bit for bit the reference's ``map_and_simulate``."""
    cfgs = P_engine.genomes_to_configs(genomes)
    ws = P_engine.prepared_workload("snn_vgg9")
    link = P_bm.search_and_simulate(ws, cfgs, mode="throughput",
                                    fidelity="link", device="cpu")
    agg = P_bm.search_and_simulate(ws, cfgs, mode="throughput",
                                   device="cpu")
    assert set(link) == set(agg) | set(P_bm.LINK_KEYS)
    full = P_bm.map_and_simulate(ws, cfgs, mode="throughput",
                                 fidelity="link", device="cpu")
    ok = link["ok"]
    for k in P_bm.SEARCH_KEYS + P_bm.LINK_KEYS:
        assert np.array_equal(link[k][ok], full[k][ok]), k
    ref = R_bm.map_and_simulate(R_engine.prepared_workload("snn_vgg9"), cfgs,
                                mode="throughput", fidelity="link")
    assert np.array_equal(ref["ok"], ok)
    for k in P_bm.LINK_KEYS + ("ii_s",):
        assert np.array_equal(link[k][ok], ref[k][ok]), k
    for k in P_bm.SEARCH_KEYS:
        if k in ("ii_s", "energy_ss_pj", "achieved_tops_ss",
                 "pipeline_depth"):
            continue
        assert np.array_equal(link[k], agg[k]), k
    assert (link["ii_s"][ok] >= agg["ii_s"][ok]).all()
    assert (link["ii_s"][ok] > agg["ii_s"][ok]).any()


# ------------------------------------------------------------- the engines

def _port(mode, fidelity="link", **kw):
    return P_engine.EvalEngine(WORKLOADS, config=P_api.EngineConfig(
        mode=mode, fidelity=fidelity, **kw), device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_link_engines_agree_and_bound_the_aggregate(genomes, mode):
    exact = _port(mode, backend="exact").evaluate(genomes)
    assert exact["meta"]["fidelity"] == "link"
    batched = _port(mode, backend="batched").evaluate(genomes)
    python = _port(mode, backend="batched",
                   exact_mapper="python").evaluate(genomes)
    for other in (batched, python):
        for k in _COLS + ("area",):
            assert np.array_equal(other[k], exact[k]), k
    agg = _port(mode, "aggregate", backend="exact").evaluate(genomes)
    assert np.array_equal(np.isfinite(agg["latency"]),
                          np.isfinite(exact["latency"]))
    if mode == "latency":
        for k in _COLS:
            assert np.array_equal(exact[k], agg[k]), k
    else:
        fin = np.isfinite(agg["latency"])
        assert (exact["latency"][fin] >= agg["latency"][fin]).all()
        assert (exact["latency"][fin] > agg["latency"][fin]).any()


@pytest.fixture(scope="module")
def reference_exact_link(genomes):
    """The JAX package's exact engine on the link tier, both modes (one
    compile)."""
    return {m: R_engine.EvalEngine(WORKLOADS, config=R_api.EngineConfig(
        backend="exact", mode=m, fidelity="link")).evaluate(genomes[:8])
        for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_oracle_engine_matches_reference_exact_link(genomes,
                                                    reference_exact_link,
                                                    mode):
    got = _port(mode, backend="oracle").evaluate(genomes[:8])
    want = reference_exact_link[mode]
    for k in _COLS:
        a, b = got[k], want[k]
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), k
        err = np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1e-300)
        assert err.max(initial=0.0) <= REL_TOL, (k, err.max())
    for k in ("backend", "mode", "fidelity", "requests", "misses"):
        assert got["meta"][k] == (want["meta"][k] if k != "backend"
                                  else "oracle"), k
