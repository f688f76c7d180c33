"""PyTorch port, data model: the host-side modules of ``repro_torch``
(IR, architecture schema, calibration, workload suite, compiler passes
1-2, genome encoding and config stacking) give the reference's arrays
bitwise.  Numpy only: nothing here compiles a JAX function."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import arch as R_arch
from repro.core.calibrate import asap7 as R_asap7
from repro.core.dse import encoding as R_enc
from repro.core.dse import engine as R_engine
from repro.core.workloads import workload_names as r_workload_names
from repro_torch.core import arch as P_arch
from repro_torch.core.calibrate import asap7 as P_asap7
from repro_torch.core.dse import encoding as P_enc
from repro_torch.core.dse import engine as P_engine
from repro_torch.core.dse.batch_eval import prepare_configs
from repro_torch.core.workloads import workload_names


def _genomes(n=256, seed=11):
    """Random genomes from both packages' encoders (the same numpy
    stream must give the same genomes), mixing the family strata."""
    out = []
    for fam in (None, "homo", "hetero_bl", "hetero_bls"):
        r = R_enc.random_genomes(np.random.default_rng(seed), n // 4, fam)
        p = P_enc.random_genomes(np.random.default_rng(seed), n // 4, fam)
        assert np.array_equal(r, p) and r.dtype == p.dtype, fam
        out.append(p)
    return np.concatenate(out)


def _assert_same_arrays(a, b, where=""):
    assert set(a) == set(b), where
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, (where, k, x.dtype, y.dtype)
        assert np.array_equal(x, y), (where, k)


def test_suite_names_match():
    assert workload_names() == r_workload_names()
    assert len(workload_names()) == 20


@pytest.mark.parametrize("wname", r_workload_names())
def test_prepare_workload_bitwise(wname):
    _assert_same_arrays(P_engine.prepared_workload(wname),
                        R_engine.prepared_workload(wname), wname)


def test_prepare_workload_int4_and_no_fusion_bitwise():
    for wname in ("resnet50_int8", "vit_b16_fp16"):
        _assert_same_arrays(P_engine.prepared_workload(wname, True, False),
                            R_engine.prepared_workload(wname, True, False),
                            wname)


def test_genomes_to_configs_bitwise():
    g = _genomes()
    _assert_same_arrays(P_engine.genomes_to_configs(g)["tile"],
                        R_engine.genomes_to_configs(g)["tile"], "tile")
    _assert_same_arrays(P_engine.genomes_to_configs(g)["chip"],
                        R_engine.genomes_to_configs(g)["chip"], "chip")
    assert np.array_equal(P_engine.genome_areas(g), R_engine.genome_areas(g))


def test_decode_path_configs_bitwise():
    """The per-chip path (``decode`` -> ``prepare_configs``) matches the
    reference's per-chip path.  (On some genomes both packages' decode
    path differs from their vectorized path in the last bit of
    ``area_mm2``: a reference property the port keeps; ROADMAP.md C.)"""
    from repro.core.dse.batch_eval import prepare_configs as r_prepare
    g = _genomes(32, seed=3)
    ref = r_prepare([R_enc.decode(x, f"g{i}") for i, x in enumerate(g)])
    got = prepare_configs([P_enc.decode(x, f"g{i}") for i, x in enumerate(g)])
    for grp in ("tile", "chip"):
        _assert_same_arrays(got[grp], ref[grp], grp)


def test_canonical_genomes_bitwise():
    g = _genomes()
    assert np.array_equal(P_engine.canonical_genomes(g),
                          R_engine.canonical_genomes(g))


def test_encoding_tables_match():
    assert P_enc.GENOME_LEN == R_enc.GENOME_LEN == 43
    assert np.array_equal(P_enc.genome_bounds(), R_enc.genome_bounds())


def test_chip_vectors_match():
    chips = [(P_arch.hetero_bls(), R_arch.hetero_bls()),
             (P_arch.hetero_bl(3, 2), R_arch.hetero_bl(3, 2)),
             (P_arch.homogeneous_baseline(4), R_arch.homogeneous_baseline(4))]
    for x in _genomes(16, seed=5):
        chips.append((P_enc.decode(x), R_enc.decode(x)))
    for p, r in chips:
        vp, vr = p.to_vector(), r.to_vector()
        _assert_same_arrays(vp["tile"], vr["tile"], p.name)
        _assert_same_arrays(vp["chip"], vr["chip"], p.name)
        assert dataclasses.asdict(p) == dataclasses.asdict(r), p.name


def test_calibration_and_knob_grid_match():
    assert dataclasses.asdict(P_asap7.DEFAULT_CALIB) == \
        dataclasses.asdict(R_asap7.DEFAULT_CALIB)
    pa, ra = P_asap7.DEFAULT_CALIB.as_arrays(), \
        R_asap7.DEFAULT_CALIB.as_arrays()
    _assert_same_arrays(pa, ra, "calib")
    assert P_arch.KNOB_GRID == R_arch.KNOB_GRID
    assert P_arch.prec_mask([0, 2]) == R_arch.prec_mask([0, 2])
