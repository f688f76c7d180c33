"""PyTorch port, ``dse_eval``: the plain version matches the JAX
``ref.dse_eval_ref`` and the interpret-mode ``dse_eval_pallas`` at the
tests/test_kernels.py shapes and tolerances; the case where no tile can
host an op follows ``ref.py``; ``prefilter.roofline_bounds`` packs the
fields its docstring names; and the wrapper checks its inputs.  (The
CUDA kernel's own tests are in tests/test_torch_gpu.py.)"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.simulator import costs as R_costs
from repro.kernels import ref as R
from repro.kernels.dse_eval import dse_eval_pallas
from repro_torch.core.dse import engine as P_engine
from repro_torch.core.dse.encoding import random_genomes
from repro_torch.core.dse.prefilter import pack_launches, roofline_bounds
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as P


def _inputs(rng, B, T, N):
    """tests/test_kernels.py::test_dse_eval's input recipe."""
    tiles = rng.uniform(0.5, 2.0, size=(B, T, R.TILE_FIELDS)).astype(
        np.float32)
    tiles[..., 0] = (rng.random((B, T)) > 0.3)
    tiles[..., 1] = rng.integers(0, 4096, (B, T))
    tiles[..., 2] = 128.0
    tiles[..., 3] = 1e9
    tiles[..., 9] = 4e9
    ops = np.stack([
        rng.integers(0, 3, N), rng.integers(0, 10**6, N),
        rng.integers(1, 10**5, N), rng.integers(1, 10**6, N),
        np.ones(N), 2.0 ** rng.integers(0, 3, N), np.full(N, 512.0)],
        axis=1).astype(np.float32)
    return tiles, ops


def _assert_kernel_tol(out, ref):
    """tests/test_kernels.py::test_dse_eval's tolerances."""
    fin = np.isfinite(ref[..., 0])
    np.testing.assert_allclose(out[..., 0][fin], ref[..., 0][fin], rtol=1e-5)
    np.testing.assert_allclose(out[..., 1], ref[..., 1], rtol=1e-4, atol=1.0)
    assert (np.isfinite(out[..., 0]) == fin).all()


@pytest.mark.parametrize("B,T,N", [(8, 8, 128), (16, 24, 256)])
def test_plain_matches_jax_ref_and_pallas(B, T, N):
    tiles, ops = _inputs(np.random.default_rng(0), B, T, N)
    before = K.launch_counts["dse_eval"]
    got = K.dse_eval(torch.from_numpy(tiles), torch.from_numpy(ops)).numpy()
    assert K.launch_counts["dse_eval"] == before  # CPU: the plain version
    jref = np.asarray(R.dse_eval_ref(jnp.asarray(tiles), jnp.asarray(ops)))
    _assert_kernel_tol(got, jref)
    pal = np.asarray(dse_eval_pallas(jnp.asarray(tiles), jnp.asarray(ops),
                                     interpret=True))
    _assert_kernel_tol(pal, got)


def test_no_hostable_tile_follows_ref_py():
    """Candidate 0 has no tile; candidate 1 has tiles without DSP lanes or
    MACs.  ref.py: inf seconds, energy macs * e_mac[tile 0] + 0.5 * elems
    (the Pallas kernel returns energy 0 there; ROADMAP.md B1)."""
    tiles = np.zeros((2, 4, R.TILE_FIELDS), np.float32)
    tiles[..., 3] = 1e9
    tiles[..., 8] = [1.5, 2.0, 3.0, 4.0]
    tiles[..., 9] = 4e9
    tiles[1, :, 0] = 1.0
    ops = np.array([[0, 1000, 10, 100, 1, 1, 0],
                    [1, 0, 50, 100, 1, 1, 0],
                    [2, 0, 64, 100, 1, 4, 0]], np.float32)
    got = K.dse_eval(torch.from_numpy(tiles), torch.from_numpy(ops)).numpy()
    assert np.isinf(got[..., 0]).all()
    want_e = ops[:, 1] * 1.5 + ops[:, 2] * 0.5
    assert np.array_equal(got[..., 1], np.broadcast_to(want_e, (2, 3)))
    jref = np.asarray(R.dse_eval_ref(jnp.asarray(tiles), jnp.asarray(ops)))
    assert np.array_equal(got, jref)


def _hand_pack(cfgs, ws, rows, prec, act_sp, w_sp):
    """The prefilter layout built with the reference's numpy cost model."""
    cm = R_costs.cost_model(P_engine.DEFAULT_CALIB, np)
    T = cfgs["tile"]
    tiles = np.stack([
        T["exists"], T["num_macs"], T["dsp_lanes"], T["clock_hz"],
        np.broadcast_to(cm.eta(T["sparsity"], act_sp, w_sp),
                        T["exists"].shape),
        T["sfu_mask"], T["sfu_parallel"],
        cm.supports_precision(T, prec).astype(np.float64),
        cm.mac_energy_pj(T, cm._i32(prec)),
        np.broadcast_to(cfgs["chip"]["dram_gbps"][:, None] * 1e9,
                        T["exists"].shape)], axis=-1).astype(np.float32)
    ops = np.stack([
        ws["op_cls"][rows], ws["macs"][rows], ws["elems"][rows],
        ws["bytes_in"][rows] + ws["bytes_w"][rows] + ws["bytes_out"][rows],
        ws["seq_len"][rows],
        R_costs.SFU_NEED[ws["op_type"][rows]], ws["fft_n"][rows]],
        axis=1).astype(np.float32)
    return tiles, ops


@pytest.mark.parametrize("wname", ["kan", "resnet50_int8", "hyena_1_3b"])
def test_roofline_bounds_packing(wname):
    g = random_genomes(np.random.default_rng(4), 12)
    cfgs = P_engine.genomes_to_configs(g)
    ws = P_engine.prepared_workload(wname)
    launches = pack_launches(cfgs, ws, device="cpu")
    active = np.flatnonzero((ws["valid"] > 0) & (ws["fused"] == 0))
    seen = np.sort(np.concatenate([rows for rows, _, _ in launches]))
    assert np.array_equal(seen, active)
    want = np.zeros((len(g), len(ws["op_type"]), 2), np.float32)
    for rows, tiles, ops in launches:
        keys = {(ws["precision"][r], ws["act_sparsity"][r],
                 ws["w_sparsity"][r]) for r in rows}
        assert len(keys) == 1
        prec, act_sp, w_sp = keys.pop()
        ht, ho = _hand_pack(cfgs, ws, rows, int(prec), act_sp, w_sp)
        assert np.array_equal(tiles.numpy(), ht)
        assert np.array_equal(ops.numpy(), ho)
        want[:, rows] = P.dse_eval_ref(torch.from_numpy(ht),
                                       torch.from_numpy(ho)).numpy()
    got = roofline_bounds(cfgs, ws, device="cpu").numpy()
    assert np.array_equal(got, want)
    assert np.isfinite(got[:, active, 0]).any()


@pytest.mark.parametrize("wname", ["kan", "gnn_gat", "resnet50_int8"])
def test_roofline_bounds_class_order_changes_nothing(wname):
    """pack_launches orders each launch's rows by op class (for the
    kernel's warps); roofline_bounds scatters by row, so it equals, bit for
    bit, the bound of launches in row order (the packing before the
    reorder)."""
    g = random_genomes(np.random.default_rng(5), 10)
    cfgs = P_engine.genomes_to_configs(g)
    ws = P_engine.prepared_workload(wname)
    want = np.zeros((len(g), len(ws["op_type"]), 2), np.float32)
    for rows, tiles, ops in pack_launches(cfgs, ws, device="cpu"):
        cls = ops[:, 0].numpy()
        assert (np.diff(cls) >= 0).all()
        assert np.array_equal(cls, ws["op_cls"][rows])
        order = np.argsort(rows)
        want[:, rows[order]] = P.dse_eval_ref(
            tiles, ops[torch.from_numpy(order)]).numpy()
    got = roofline_bounds(cfgs, ws, device="cpu").numpy()
    assert np.array_equal(got, want)


def test_wrapper_checks_inputs():
    t = torch.zeros((2, 3, R.TILE_FIELDS))
    o = torch.zeros((4, R.OP_FIELDS))
    with pytest.raises(TypeError):
        K.dse_eval(t.double(), o)
    with pytest.raises(ValueError):
        K.dse_eval(t[..., :9], o)
    with pytest.raises(ValueError):
        K.dse_eval(t, o[:, :6])
    with pytest.raises(ValueError):
        K.dse_eval(t.transpose(0, 1), o)

