"""PyTorch port, the launch tools (``repro_torch.launch.{roofline,
dryrun,hillclimb}`` and ``repro_torch.core.tpu_dse``): ``model_flops``,
``analyze``, ``predict_cost`` and ``search_mesh`` equal the JAX
package's with the port's H100 rates swapped for the reference's, and
keep the reference's properties at the H100 rates; the dry-run traces
reduced cells in every mode on a fake multi-rank mesh (collectives) and
on a mesh of one device (none, and the flops of the same call without
DTensor); the hillclimb's cell mode runs end to end."""
import argparse
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import tpu_dse as R_dse  # noqa: E402
from repro.launch import roofline as R_roof  # noqa: E402
from repro.models import get_config as r_config  # noqa: E402
from repro_torch.core import tpu_dse as T_dse  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import roofline as T_roof  # noqa: E402
from repro_torch.launch import shapes as S  # noqa: E402
from repro_torch.launch import tuning  # noqa: E402
from repro_torch.launch.hillclimb import _main_cell  # noqa: E402
from repro_torch.models.model import (Model, init_cache,  # noqa: E402
                                      set_scan_unroll)
from repro_torch.models.registry import get_config, list_archs  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.serve.step import (make_decode_step,  # noqa: E402
                                    make_prefill_step)
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_train_step)

RATES = ("PEAK_FLOPS", "HBM_BW", "LINK_BW")


@pytest.mark.parametrize("shape", list(S.SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_reference(arch, shape):
    assert T_roof.model_flops(arch, shape) == R_roof.model_flops(arch, shape)


def _record(arch, shape, mesh="16x16", n=256):
    return {"arch": arch, "shape": shape, "mesh": mesh, "n_devices": n,
            "flops_per_device": 3.7e14, "bytes_per_device": 2.9e12,
            "collectives": {"all-gather": {"count": 12, "bytes": 5.1e9},
                            "reduce-scatter": {"count": 6, "bytes": 3.8e10}},
            "memory": {"peak_bytes": 27 * 2**30}}


@pytest.mark.parametrize("arch,shape", [("granite-20b", "train_4k"),
                                        ("deepseek-v2-lite-16b",
                                         "decode_32k")])
def test_analyze_equals_the_reference_at_its_rates(arch, shape,
                                                   monkeypatch):
    for k in RATES:
        monkeypatch.setattr(T_roof, k, getattr(R_roof, k))
    rec = _record(arch, shape)
    assert T_roof.analyze(rec) == R_roof.analyze(rec)
    assert T_roof.analyze(dict(rec, error="x")) is None
    assert T_roof.analyze({"skipped": "full attention"}) is None


def test_roofline_rates_are_the_h100s():
    assert (T_roof.PEAK_FLOPS, T_roof.HBM_BW, T_roof.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert (T_dse.PEAK_FLOPS, T_dse.HBM_BW, T_dse.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch", ["granite-20b", "starcoder2-15b",
                                  "deepseek-v2-lite-16b",
                                  "llama4-maverick-400b-a17b"])
def test_mesh_search_equals_the_reference_at_its_rates(arch, monkeypatch):
    for k in RATES:
        monkeypatch.setattr(T_dse, k, getattr(R_dse, k))
    got = T_dse.search_mesh(get_config(arch), 256, 256, 4096, hbm_gib=16.0)
    want = R_dse.search_mesh(r_config(arch), 256, 256, 4096, hbm_gib=16.0)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert dataclasses.astuple(a.knobs) == dataclasses.astuple(b.knobs)
        assert (a.compute_s, a.memory_s, a.collective_s, a.hbm_gib,
                a.fits, a.step_s) == (b.compute_s, b.memory_s,
                                      b.collective_s, b.hbm_gib, b.fits,
                                      b.step_s)
    k = T_dse.MeshKnobs(dp=64, tp=4, microbatches=2, remat=False)
    rk = R_dse.MeshKnobs(dp=64, tp=4, microbatches=2, remat=False)
    a = T_dse.predict_cost(get_config(arch), k, 256, 4096)
    b = R_dse.predict_cost(r_config(arch), rk, 256, 4096)
    assert (a.compute_s, a.memory_s, a.collective_s) == \
        (b.compute_s, b.memory_s, b.collective_s)


def test_h100_mesh_search_prefers_fitting_configs():
    """The reference's properties, at the H100's rates and 80 GiB."""
    cfg = get_config("granite-20b")
    ranked = T_dse.search_mesh(cfg, chips=256, global_batch=256,
                               seq_len=4096)
    assert ranked and ranked[0].fits
    c1 = T_dse.predict_cost(cfg, T_dse.MeshKnobs(dp=128, tp=2,
                                                 microbatches=1), 256, 4096)
    c4 = T_dse.predict_cost(cfg, T_dse.MeshKnobs(dp=128, tp=2,
                                                 microbatches=4), 256, 4096)
    assert c4.hbm_gib < c1.hbm_gib
    sc = get_config("starcoder2-15b")
    lo = T_dse.predict_cost(sc, T_dse.MeshKnobs(dp=128, tp=2), 256, 4096)
    hi = T_dse.predict_cost(sc, T_dse.MeshKnobs(dp=16, tp=16), 256, 4096)
    assert hi.collective_s > lo.collective_s


@pytest.fixture
def small_shapes(monkeypatch):
    """The four shape cases cut to 256 tokens and a batch of 32 (long
    decode keeps its batch of 1), so that a reduced cell traces in about
    a second."""
    for k, c in list(S.SHAPES.items()):
        monkeypatch.setitem(S.SHAPES, k, S.ShapeCase(
            k, min(c.seq_len, 256), min(c.global_batch, 32), c.mode))


def _plain_flops(cfg, shape):
    """FlopCounterMode over the same step on plain fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    case = S.SHAPES[shape]
    structs, _ = S.input_specs(cfg, shape)
    set_scan_unroll(True)
    try:
        with FakeTensorMode():
            model = Model(cfg, device="cpu", generator=None)
            x = {k: torch.zeros(s.shape, dtype=s.dtype)
                 for k, s in structs.items()}
            with FlopCounterMode(display=False) as fc:
                if case.mode == "train":
                    st = init_train_state(cfg, model, AdamWConfig())
                    make_train_step(cfg, AdamWConfig())(st, x)
                elif case.mode == "prefill":
                    make_prefill_step(cfg, case.seq_len)(model, x["tokens"])
                else:
                    c = init_cache(cfg, case.global_batch, case.seq_len,
                                   "cpu")
                    make_decode_step(cfg)(model, x["tokens"], x["pos"], c)
    finally:
        set_scan_unroll(False)
    return fc.get_total_flops()


@pytest.mark.parametrize("mesh", [(2, 2), (1, 1)])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["starcoder2-15b", "mamba2-780m",
                                  "deepseek-v2-lite-16b"])
def test_dryrun_traces_reduced_cells(arch, shape, mesh, small_shapes):
    import torch.distributed as dist
    cfg = get_config(arch).reduced()
    rec = D.run_cell(arch, shape, cfg=cfg, mesh_shape=mesh)
    assert not dist.is_initialized()
    assert "error" not in rec, rec.get("traceback")
    assert rec["mesh"] == "x".join(map(str, mesh))
    assert rec["n_devices"] == mesh[0] * mesh[1]
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["output_bytes"] > 0
    assert rec["cost_unrolled"] is True
    if mesh == (1, 1):
        assert rec["collectives"] == {}
        assert rec["flops_per_device"] == _plain_flops(cfg, shape)
    else:
        assert sum(v["count"] for v in rec["collectives"].values()) > 0
        assert all(v["bytes"] > 0 for v in rec["collectives"].values())
        a = T_roof.analyze(dict(rec, arch=arch, shape=shape))
        assert a["collective_s"] > 0 and a["compute_s"] > 0


def test_dryrun_records_a_failing_cell(monkeypatch, small_shapes):
    import torch.distributed as dist

    def broken(*a, **k):
        raise ValueError("planted")

    monkeypatch.setattr(D, "_run", broken)
    rec = D.run_cell("starcoder2-15b", "train_4k",
                     cfg=get_config("starcoder2-15b").reduced(),
                     mesh_shape=(1, 1))
    assert rec["error"] == "ValueError: planted"
    assert "planted" in rec["traceback"]
    assert not dist.is_initialized()
    skip = D.run_cell("granite-20b", "long_500k")
    assert "skipped" in skip and "error" not in skip


def test_hillclimb_cell_mode_end_to_end(tmp_path, small_shapes, capsys):
    args = argparse.Namespace(arch="starcoder2-15b", shape="train_4k",
                              multi_pod=False, set=["act_mode=batch",
                                                    "microbatches=2"],
                              tag="t", out=str(tmp_path))
    rec = _main_cell(args, cfg=get_config("starcoder2-15b").reduced())
    assert "error" not in rec and rec["n_devices"] == 256
    assert rec["knobs"] == {"act_mode": "batch", "microbatches": 2}
    assert tuning.KNOBS == tuning.PerfKnobs()
    with open(tmp_path / "starcoder2-15b_train_4k_t.json") as f:
        assert json.load(f)["knobs"] == rec["knobs"]
    out = json.loads(capsys.readouterr().out)
    assert out["dominant"] in ("compute", "memory", "collective")
    assert rec["flops_per_device"] > 0 and rec["memory"]["peak_bytes"] > 0
    assert sum(v["count"] for v in rec["collectives"].values()) > 0
    skip = _main_cell(argparse.Namespace(
        arch="granite-20b", shape="long_500k", multi_pod=False, set=[],
        tag="s", out=str(tmp_path)))
    assert "skipped" in skip and "SKIPPED" in capsys.readouterr().out


@pytest.mark.parametrize("device,route", [("cpu", "direct"),
                                          ("cuda", "flash")])
def test_cost_mode_keeps_the_kernel_for_tensors_on_the_card(
        device, route, monkeypatch):
    """``set_scan_unroll(True)`` sends a whole sequence of CPU tensors
    (the dry-run's) through the direct route and leaves tensors on the
    card (fake ``cuda`` tensors here) on the flash kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import layers as L
    taken = []
    monkeypatch.setattr(L, "_flash", lambda q, k, v, causal: taken.append(
        "flash") or q.flatten(2))
    monkeypatch.setattr(L, "_sdpa_direct", lambda q, k, v, causal:
                        taken.append("direct") or q.flatten(2))
    set_scan_unroll(True)
    try:
        with FakeTensorMode():
            q = torch.empty((2, 8, 4, 16), dtype=torch.bfloat16,
                            device=device)
            L._attend(q, q, q, causal=True)
    finally:
        set_scan_unroll(False)
    assert taken == [route]


def test_prefill_holds_caches_passed_in_to_be_empty():
    """Empty caches passed in give ``prefill_step``'s own result; caches
    that already hold tokens are refused."""
    cfg = get_config("starcoder2-15b").reduced()
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 8)))
    pf = make_prefill_step(cfg, 16)
    want, _ = pf(model, tokens)
    got, caches = pf(model, tokens, None, init_cache(cfg, 2, 16, "cpu"))
    assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="caches not empty"):
        pf(model, tokens, None, caches)


def test_dtensor_route_is_scoped_to_its_block():
    """``dtensor_route.routes()`` swaps the model's functions only inside
    its block and leaves plain tensors on their own ops there."""
    from repro_torch.launch.dtensor_route import routes
    from repro_torch.models import layers, model
    from repro_torch.serve import step
    plain = (layers.einsum, model._embed, step._embed, model._chunked_ce,
             model.checkpoint)
    x = torch.arange(24, dtype=torch.float32)
    with routes():
        assert all(a is not b for a, b in zip(
            (layers.einsum, model._embed, step._embed, model._chunked_ce,
             model.checkpoint), plain))
        y = torch.cumsum(x.reshape(4, 6), dim=1)
    assert (layers.einsum, model._embed, step._embed, model._chunked_ce,
            model.checkpoint) == plain
    assert torch.equal(y, torch.cumsum(x.reshape(4, 6), dim=1))
