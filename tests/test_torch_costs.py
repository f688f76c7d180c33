"""PyTorch port, cost model: the port's torch-float64 ``CostModel`` on CPU
is bitwise equal to the reference's numpy ``cost_model(calib, xp=np)``
on random ops x tiles, in both of the forms the port evaluates it:
op fields as tensors (broadcast against tile tensors) and op fields as
host floats (the batched executor's form)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.calibrate.asap7 import DEFAULT_CALIB as R_CALIB
from repro.core.simulator import costs as R
from repro_torch.core.calibrate.asap7 import DEFAULT_CALIB as P_CALIB
from repro_torch.core.simulator import costs as P

N_OPS, N_TILES = 96, 24


def _tiles(rng, n):
    num_rows = rng.choice([0, 8, 16, 32, 64, 128], n).astype(float)
    cols = np.where(num_rows > 0, rng.choice([8, 16, 32, 64, 128], n), 0.0)
    t = {
        "exists": (rng.random(n) > 0.15).astype(float),
        "rows": num_rows, "cols": cols, "num_macs": num_rows * cols,
        "engine": rng.integers(0, 4, n).astype(float),
        "prec_mask": rng.integers(1, 32, n).astype(float),
        "asym_mac": rng.integers(0, 4, n).astype(float),
        "sparsity": rng.integers(0, 5, n).astype(float),
        "dataflow": rng.integers(0, 4, n).astype(float),
        "sram_kb": rng.choice([64, 128, 256, 512, 1024, 2048, 4096],
                              n).astype(float),
        "dsp_count": rng.integers(0, 3, n).astype(float),
        "sfu_mask": rng.integers(0, 8, n).astype(float),
        "sfu_parallel": rng.choice([1, 16, 17], n).astype(float),
        "double_buffer": rng.integers(0, 2, n).astype(float),
        "pipeline_depth": rng.choice([1, 4, 8, 16], n).astype(float),
        "clock_hz": rng.choice([500e6, 800e6, 1200e6], n),
        "sram_bpc": rng.choice([16.0, 128.0], n),
        "max_prec": rng.integers(0, 5, n).astype(float),
    }
    t["dsp_lanes"] = t["dsp_count"] * 64.0
    return t


def _ops(rng, n):
    op_type = rng.integers(0, 23, n)
    op_cls = np.where(op_type <= 4, 0, np.where(op_type >= 20, 2, 1))
    is_mac = op_cls == 0
    m = np.where(is_mac, rng.integers(1, 5000, n), 0).astype(float)
    k = np.where(is_mac, rng.integers(1, 9000, n), 0).astype(float)
    nn = np.where(is_mac, rng.integers(1, 7000, n), 0).astype(float)
    return {
        "op_type": op_type.astype(float), "op_cls": op_cls.astype(float),
        "m": m, "k": k, "n": nn, "macs": m * k * nn,
        "elems": np.where(is_mac, 0, rng.integers(1, 10 ** 7, n)).astype(float),
        "precision": rng.integers(0, 5, n).astype(float),
        "bytes_in": rng.integers(0, 10 ** 8, n).astype(float),
        "bytes_w": rng.integers(0, 10 ** 8, n).astype(float),
        "bytes_out": rng.integers(0, 10 ** 8, n).astype(float),
        "act_sparsity": rng.uniform(0.0, 1.0, n),
        "w_sparsity": rng.uniform(0.0, 1.0, n),
        "fft_n": rng.integers(0, 5000, n).astype(float),
        "poly_degree": rng.integers(0, 12, n).astype(float),
        "snn_timesteps": rng.integers(0, 9, n).astype(float),
        "seq_len": rng.integers(0, 2048, n).astype(float),
    }


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1234)
    tiles, ops = _tiles(rng, N_TILES), _ops(rng, N_OPS)
    # numpy reference: ops (N, 1) x tiles (1, T)
    Tn = {k: v[None, :] for k, v in tiles.items()}
    On = {k: v[:, None] for k, v in ops.items()}
    Tt = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in Tn.items()}
    Ot = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in On.items()}
    dyn = {"bw": rng.choice([16.0, 64.0, 512.0], (N_OPS, 1)) / 3.0,
           "rd": rng.integers(0, 10 ** 7, (N_OPS, 1)).astype(float),
           "wr": rng.integers(0, 10 ** 7, (N_OPS, 1)).astype(float)}
    dyn["rd"][::5] = 0.0
    return Tn, On, Tt, Ot, dyn


def _models():
    return R.cost_model(R_CALIB, np), P.cost_model(P_CALIB, "cpu")


def _same(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.broadcast_to(np.asarray(want), got.shape) \
        if np.ndim(want) < np.ndim(got) else np.asarray(want)
    got = np.broadcast_to(got, want.shape)
    assert np.array_equal(got, want, equal_nan=True), what


def test_execute_static_and_dynamic_bitwise(case):
    Tn, On, Tt, Ot, dyn = case
    rcm, pcm = _models()
    rs, ps = rcm.execute_static(Tn, On), pcm.execute_static(Tt, Ot)
    assert set(rs) == set(ps)
    for k in rs:
        _same(ps[k], rs[k], k)
    bw = torch.as_tensor(dyn["bw"])
    rd, wr = torch.as_tensor(dyn["rd"]), torch.as_tensor(dyn["wr"])
    rdyn = rcm.execute_dynamic(rs, Tn, dyn["bw"], dyn["rd"], dyn["wr"])
    pdyn = pcm.execute_dynamic(ps, Tt, bw, rd, wr)
    assert set(rdyn) == set(pdyn)
    for k in rdyn:
        _same(pdyn[k], rdyn[k], k)


def test_roofline_and_supports_bitwise(case):
    Tn, On, Tt, Ot, dyn = case
    rcm, pcm = _models()
    bw = torch.as_tensor(dyn["bw"])
    _same(pcm.roofline_cycles(Tt, Ot, bw),
          rcm.roofline_cycles(Tn, On, dyn["bw"]), "roofline_cycles")
    _same(pcm.supports(Tt, Ot), rcm.supports(Tn, On), "supports")
    _same(pcm.eta(Tt["sparsity"], Ot["act_sparsity"], Ot["w_sparsity"]),
          rcm.eta(Tn["sparsity"], On["act_sparsity"], On["w_sparsity"]),
          "eta")
    _same(pcm.mac_energy_pj(Tt, Ot["precision"]),
          rcm.mac_energy_pj(Tn, rcm._i32(On["precision"])), "mac_energy")


@pytest.mark.parametrize("cls", [0, 1, 2])
def test_class_specialized_halves_bitwise(case, cls):
    """Host-float op rows (the executor's form) through the
    class-specialized halves equal the reference's full numpy model on the
    same op, term for term."""
    Tn, On, Tt, Ot, dyn = case
    rcm, pcm = _models()
    rows = np.flatnonzero(On["op_cls"][:, 0] == cls)[:6]
    assert len(rows) > 0
    for i in rows:
        op_host = {k: float(v[i, 0]) for k, v in On.items()}
        op_np = {k: v[i, 0] for k, v in On.items()}
        bw = float(dyn["bw"][i, 0])
        rs = rcm.execute_static(Tn, op_np)
        ps = pcm.execute_static_cls(Tt, op_host, cls)
        for k in rs:
            _same(ps[k], rs[k], (i, k))
        rd = rcm.execute_dynamic(rs, Tn, bw, dyn["rd"][i, 0], dyn["wr"][i, 0])
        pd = pcm.execute_dynamic(ps, Tt, bw, float(dyn["rd"][i, 0]),
                                 float(dyn["wr"][i, 0]))
        for k in rd:
            _same(pd[k], rd[k], (i, k))
        _same(pcm.roofline_cycles_cls(Tt, op_host, bw, cls),
              rcm.roofline_cycles(Tn, op_np, bw), (i, "roofline"))
        _same(pcm.supports_cls(Tt, op_host, cls), rcm.supports(Tn, op_np),
              (i, "supports"))


def test_split_fields_noc_and_pipeline_bitwise(case):
    Tn, On, Tt, Ot, dyn = case
    rng = np.random.default_rng(5)
    kf = rng.integers(1, 9, (N_OPS, 1)).astype(float)
    axis = rng.integers(-1, 3, (N_OPS, 1))
    rsub = R.split_op_fields(np, On, axis, kf)
    psub = P.split_op_fields(Ot, torch.as_tensor(axis), torch.as_tensor(kf))
    for k in rsub:
        _same(psub[k], rsub[k], ("split", k))
    nbytes = rng.integers(0, 10 ** 7, N_OPS).astype(float)
    bpc = rng.choice([32.0, 64.0, 128.0, 256.0], N_OPS)
    hops = rng.integers(1, 6, N_OPS).astype(float)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    _same(P.noc_transfer_seconds(t(nbytes), t(bpc), t(hops), 8.0, 1e9),
          R.noc_transfer_seconds(np, nbytes, bpc, hops, 8.0, 1e9), "noc_s")
    # the executor's form: host-float byte count over per-candidate tensors
    _same(P.noc_transfer_seconds(float(nbytes[0]), t(bpc), t(hops), 8.0,
                                 1e9),
          R.noc_transfer_seconds(np, nbytes[0], bpc, hops, 8.0, 1e9),
          "noc_s host")
    _same(P.noc_transfer_energy_pj(t(nbytes), 0.8, t(hops)),
          R.noc_transfer_energy_pj(np, nbytes, 0.8, hops), "noc_e")
    mk, tb, db, gb, nb = (rng.uniform(1e-6, 1e-2, N_OPS),
                          rng.uniform(1e-6, 1e-2, N_OPS),
                          rng.integers(0, 10 ** 9, N_OPS).astype(float),
                          rng.choice([16.0, 64.0, 512.0], N_OPS),
                          rng.uniform(0.0, 1e-2, N_OPS))
    rp = R.pipeline_bounds(np, mk, tb, db, gb, nb)
    pp = P.pipeline_bounds(t(mk), t(tb), t(db), t(gb), t(nb))
    assert set(rp) == set(pp)
    for k in rp:
        _same(pp[k], rp[k], ("pipeline", k))
    e, lk, lr = (rng.uniform(1e6, 1e9, N_OPS), rng.uniform(0, 1e6, N_OPS),
                 rng.uniform(0, 1e9, N_OPS))
    _same(P.steady_state_energy(t(e), t(lk), t(lr), pp["ii_s"]),
          R.steady_state_energy(e, lk, lr, rp["ii_s"]), "ss_energy")
    n = np.arange(0, 25, dtype=float)
    for aspect in (0.5, 1.0, 2.0):
        rw, rh = R.grid_dims(np, n, aspect)
        pw, ph = P.grid_dims(t(n), aspect)
        _same(pw, rw, "grid_w")
        _same(ph, rh, "grid_h")
        nw, nh = P.grid_dims(n, aspect)
        assert np.array_equal(nw, rw) and np.array_equal(nh, rh)


def test_sqrt_and_division_helpers_are_ieee():
    """The two torch behaviours the port routes around (see the costs
    module docstring): CPU float64 sqrt and scalar / tensor."""
    x = np.random.default_rng(0).uniform(0.0, 1e12, 4096)
    assert np.array_equal(P._sqrt(torch.as_tensor(x)).numpy(), np.sqrt(x))
    assert np.array_equal(P._div(3.0, torch.as_tensor(x)).numpy(), 3.0 / x)
    assert np.array_equal(P._div(torch.as_tensor(x), 1e12).numpy(), x / 1e12)
