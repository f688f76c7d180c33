"""PyTorch port, batched mapper + executor: placements and ``ok`` equal the
JAX ``batched_map`` exactly; ``map_and_simulate`` metrics equal the JAX
ones within rel 1e-9 (the ``REL_TOL`` tests/test_golden_traces.py holds
the reference's own backends to), bitwise where reached; and the port on
``hetero_bls()`` reproduces the six golden traces in both schedule modes
(read directly, at the conftest comparator's rtol 1e-6)."""
import functools
import json
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.compiler import batched_mapper as R_bm
from repro.core.dse import engine as R_engine
from repro_torch.core.arch import hetero_bls
from repro_torch.core.compiler import batched_mapper as P_bm
from repro_torch.core.dse import engine as P_engine
from repro_torch.core.dse.encoding import random_genomes
from repro_torch.core.simulator.batched import stack_chip_configs

WORKLOADS = ["kan", "snn_vgg9", "gnn_gat", "resnet50_int8"]
GOLDEN = ["resnet50_int8", "vit_b16_fp16", "llama7b_int4", "snn_vgg9",
          "hyena_1_3b", "kan"]
GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
REL_TOL = 1e-9
PLACEMENT_KEYS = ("owner", "n_split", "split_axis", "split_mask", "ok")
METRIC_KEYS = (
    "latency_s", "energy_pj", "achieved_tops", "cache_hits", "cache_noc",
    "cache_misses", "energy_leakage_pj", "energy_compute_pj",
    "energy_dram_pj", "energy_sram_pj", "energy_irf_pj", "energy_orf_pj",
    "energy_dsp_pj", "energy_special_pj", "energy_noc_pj",
    "energy_fuse_savings_pj", "ii_s", "ii_tile_bound_s", "ii_dram_bound_s",
    "ii_noc_bound_s", "fill_latency_s", "dram_bytes_per_batch",
    "energy_ss_pj", "achieved_tops_ss", "pipeline_depth", "op_finish",
    "tile_ops", "tile_active_s", "tile_macs", "power_gated",
    "tile_leakage_pj", "area_mm2", "peak_tops")


@pytest.fixture(scope="module")
def genomes():
    return random_genomes(np.random.default_rng(2026), 16)


def assert_close(got, want, what, rel=REL_TOL):
    """Bitwise if it holds, else within ``rel`` with equal non-finite
    masks."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if np.array_equal(got, want):
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)), what
    assert np.array_equal(got[~fin], want[~fin]), what
    err = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]),
                                                    1e-300)
    assert err.max() <= rel, (what, float(err.max()))


@pytest.mark.parametrize("wname", WORKLOADS)
def test_batched_map_placements_exact(genomes, wname):
    got = P_bm.batched_map(P_engine.prepared_workload(wname),
                           P_engine.genomes_to_configs(genomes), device="cpu")
    want = R_bm.batched_map(R_engine.prepared_workload(wname),
                            R_engine.genomes_to_configs(genomes))
    for k in PLACEMENT_KEYS:
        assert got[k].dtype == want[k].dtype, (wname, k)
        assert np.array_equal(got[k], want[k]), (wname, k)


@pytest.mark.parametrize("mode", ["latency", "throughput"])
@pytest.mark.parametrize("wname", WORKLOADS)
def test_map_and_simulate_matches_jax(genomes, wname, mode):
    got = P_bm.map_and_simulate(P_engine.prepared_workload(wname),
                                P_engine.genomes_to_configs(genomes),
                                mode=mode, device="cpu")
    want = R_bm.map_and_simulate(R_engine.prepared_workload(wname),
                                 R_engine.genomes_to_configs(genomes),
                                 mode=mode)
    assert got["mode"] == want["mode"] == mode
    ok = want["ok"]
    assert np.array_equal(got["ok"], ok), wname
    assert ok.any(), wname
    for k in PLACEMENT_KEYS[:-1]:
        assert np.array_equal(got[k].astype(want[k].dtype), want[k]), k
    for k in METRIC_KEYS:
        assert_close(got[k][ok], want[k][ok], (wname, mode, k))


def _golden_pairs(res, g):
    """(name, port value, golden value) over the batched surface."""
    pairs = [(k, res[k][0], g[k]) for k in
             ("latency_s", "energy_pj", "achieved_tops", "area_mm2",
              "peak_tops")]
    for mod, want in g["energy_breakdown"].items():
        got = res["energy_pj"][0] if mod == "total" \
            else res[f"energy_{mod}_pj"][0]
        pairs.append((f"energy_breakdown.{mod}", got, want))
    for i, t in enumerate(g["tiles"]):
        pairs += [(f"tiles[{i}].ops", res["tile_ops"][0][i], t["ops"]),
                  (f"tiles[{i}].macs", res["tile_macs"][0][i], t["macs"]),
                  (f"tiles[{i}].active_s", res["tile_active_s"][0][i],
                   t["active_s"]),
                  (f"tiles[{i}].power_gated",
                   float(res["power_gated"][0][i]), float(t["power_gated"]))]
    for k, want in (g.get("pipeline") or {}).items():
        pairs.append((f"pipeline.{k}", res[k][0], want))
    return pairs


@functools.lru_cache(maxsize=None)
def _hetero_bls_run(wname):
    """One port run per workload: the executor always evaluates both
    schedule-mode surfaces (``mode`` only validates and tags)."""
    return P_bm.map_and_simulate(P_engine.prepared_workload(wname),
                                 stack_chip_configs([hetero_bls()]),
                                 device="cpu")


@pytest.mark.parametrize("mode", ["latency", "throughput"])
@pytest.mark.parametrize("wname", GOLDEN)
def test_golden_traces_on_hetero_bls(wname, mode):
    suffix = "" if mode == "latency" else "_throughput"
    g = json.loads((GOLDEN_DIR / f"{wname}{suffix}.json").read_text())
    assert g["arch"] == hetero_bls().name
    res = _hetero_bls_run(wname)
    assert bool(res["ok"][0]), wname
    bad = [(name, float(got), want) for name, got, want in
           _golden_pairs(res, g)
           if not np.isclose(got, want, rtol=1e-6, atol=1e-12)]
    assert not bad, bad


def test_entry_points_default_to_the_card(monkeypatch, genomes):
    """Without a card and without ``device="cpu"`` the port refuses to
    run instead of dropping to the CPU."""
    import torch

    from repro_torch.core.dse.prefilter import roofline_bounds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ws = P_engine.prepared_workload("kan")
    cfgs = P_engine.genomes_to_configs(genomes)
    for call in (lambda: P_bm.batched_map(ws, cfgs),
                 lambda: P_bm.map_and_simulate(ws, cfgs),
                 lambda: roofline_bounds(cfgs, ws)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
