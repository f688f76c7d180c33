"""PyTorch port, sharding (``repro_torch.distributed.sharding``,
``launch.shapes`` and ``models.model.param_specs``) against the JAX
package: the resolved parameter specs, the batch spec, the input specs
and the decode-cache specs of every architecture, shape and mesh equal
the reference's, leaf for leaf, and the specs become the expected DTensor
placements on a small fake mesh."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed import sharding as R_shard  # noqa: E402
from repro.launch import shapes as R_shapes  # noqa: E402
from repro.models import get_config as r_config  # noqa: E402
from repro.models.model import param_specs as r_param_specs  # noqa: E402
from repro_torch.distributed import sharding as T_shard  # noqa: E402
from repro_torch.launch import shapes as T_shapes  # noqa: E402
from repro_torch.models.model import Model, _layer_kinds  # noqa: E402
from repro_torch.models.model import param_specs  # noqa: E402
from repro_torch.models.registry import get_config, list_archs  # noqa: E402

ARCHS = list_archs()
SHAPES = list(T_shapes.SHAPES)
AXIS_MAPS = {"single": (R_shard.AXIS_MAP_SINGLE, T_shard.AXIS_MAP_SINGLE),
             "multi": (R_shard.AXIS_MAP_MULTI, T_shard.AXIS_MAP_MULTI)}


def _norm(spec):
    """A spec as a plain tuple, a one-axis tuple entry as that axis and an
    empty one as None: the same sharding (JAX's ``PartitionSpec``
    canonicalises them so)."""
    return tuple((p[0] if len(p) == 1 else (p or None))
                 if isinstance(p, tuple) else p for p in spec)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _unstack(spec):
    assert spec[0] is None, spec
    return _norm(tuple(spec)[1:])


def _ref_by_port_name(cfg, tree):
    """The reference's spec tree keyed by the port's parameter names: the
    prefix layers first, then row r of pattern position j at layer
    ``first_k_dense + r * len(pattern) + j`` (its stacked leading None
    dropped), then the encoder's layers."""
    out = {}
    for key in ("embed", "final_norm", "lm_head", "enc_final_norm"):
        if key in tree:
            out.update({n: _norm(s) for n, s in _leaves(tree[key], key)})
    for j, layer in enumerate(tree.get("prefix", [])):
        out.update({n: _norm(s) for n, s in _leaves(layer, f"layers.{j}")})
    period = len(cfg.pattern())
    for j, block in enumerate(tree["blocks"]):
        for name, s in _leaves(block):
            for r in range(cfg.n_repeats):
                out[f"layers.{cfg.first_k_dense + r * period + j}.{name}"] \
                    = _unstack(s)
    for name, s in _leaves(tree.get("encoder", {})):
        for i in range(cfg.encoder_layers):
            out[f"encoder.{i}.{name}"] = _unstack(s)
    return out


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_resolved_param_specs_equal_the_reference(arch, mesh):
    r_map, t_map = AXIS_MAPS[mesh]
    cfg = get_config(arch)
    want = _ref_by_port_name(cfg, R_shard.resolve_specs(
        r_param_specs(r_config(arch)), r_map))
    got = T_shard.resolve_specs(param_specs(cfg), t_map)
    assert set(got) == set(want)
    for name, spec in got.items():
        assert isinstance(spec, T_shard.PartitionSpec)
        assert _norm(spec) == want[name], name


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_cover_every_parameter_once(arch):
    """Every named parameter of the reduced model has one spec, with one
    entry per dimension, equal to the reference's leaf."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="meta", generator=None)
    params = dict(model.named_parameters())
    specs = param_specs(cfg)
    assert sorted(specs) == sorted(params)
    want = _ref_by_port_name(cfg, r_param_specs(r_config(arch).reduced()))
    for name, p in params.items():
        assert len(specs[name]) == p.dim(), name
        assert _norm(specs[name]) == want[name], name


class _Mesh:
    """Axis names only: what ``batch_spec`` reads of a mesh."""

    def __init__(self, names):
        self.axis_names = self.mesh_dim_names = names


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model")])
@pytest.mark.parametrize("trailing", [(), (None,), (None, "model")])
def test_batch_spec_equals_the_reference(names, trailing):
    got = T_shard.batch_spec(_Mesh(names), *trailing)
    assert _norm(got) == _norm(R_shard.batch_spec(_Mesh(names), *trailing))


def _np_dtype(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_equal_the_reference(arch, shape, multi):
    cfg, rcfg = get_config(arch), r_config(arch)
    assert T_shapes.runnable(cfg, shape) == R_shapes.runnable(rcfg, shape)
    assert T_shapes.skip_reason(cfg, shape) is None \
        or R_shapes.skip_reason(rcfg, shape) is not None
    structs, specs = T_shapes.input_specs(cfg, shape, multi_pod=multi)
    r_structs, r_specs = R_shapes.input_specs(rcfg, shape, multi_pod=multi)
    assert list(structs) == list(r_structs)
    for k, s in structs.items():
        assert s.shape == tuple(r_structs[k].shape)
        assert _np_dtype(s.dtype) == np.dtype(r_structs[k].dtype).name
        assert _norm(specs[k]) == _norm(r_specs[k])
    case = T_shapes.SHAPES[shape]
    B, T = case.global_batch, case.seq_len
    got = T_shapes.cache_specs_physical(cfg, B, multi_pod=multi)
    ref = R_shapes.cache_specs_physical(rcfg, B, multi_pod=multi)
    got_st = T_shapes.cache_structs(cfg, B, T)
    ref_st = R_shapes.cache_structs(rcfg, B, T)
    kinds = _layer_kinds(cfg)
    assert len(got) == len(got_st) == len(kinds)
    period = len(cfg.pattern())
    for i in range(len(kinds)):
        if i < cfg.first_k_dense:
            want, want_st, stacked = ref["prefix"][i], ref_st["prefix"][i], \
                False
        else:
            j = (i - cfg.first_k_dense) % period
            want, want_st, stacked = ref["blocks"][j], ref_st["blocks"][j], \
                True
        if want is None:
            assert got[i] is None and got_st[i] is None
            continue
        assert set(got[i]) == set(want) == set(got_st[i])
        for k in want:
            w = _unstack(want[k]) if stacked else _norm(want[k])
            assert _norm(got[i][k]) == w, (i, k)
            ws = tuple(want_st[k].shape)[1 if stacked else 0:]
            assert got_st[i][k].shape == ws
            assert _np_dtype(got_st[i][k].dtype) == \
                np.dtype(want_st[k].dtype).name


@pytest.fixture
def fake_mesh():
    """A (2, 2) ("data", "model") mesh over a fake process group of four
    ranks, destroyed after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_placements_on_a_fake_mesh(fake_mesh):
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    P = T_shard.PartitionSpec
    pl = T_shard.placements
    assert pl(P("data", "model"), fake_mesh) == (Shard(0), Shard(1))
    assert pl(P(None, "model"), fake_mesh) == (Replicate(), Shard(1))
    assert pl(P(("data", "model"), None), fake_mesh) == (Shard(0), Shard(0))
    assert pl(P(), fake_mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="pod"):
        pl(P("pod"), fake_mesh)
    tree = T_shard.named_shardings(
        {"w": P("data", None), "xs": [P(None, "model"), None]}, fake_mesh)
    assert tree == {"w": (Shard(0), Replicate()),
                    "xs": [(Replicate(), Shard(1)), None]}
    w = distribute_tensor(torch.zeros(8, 6), fake_mesh,
                          pl(P("data", "model"), fake_mesh))
    assert w.to_local().shape == (4, 3)
    # logical_constraint: a no-op without an axis map and on plain tensors
    x = torch.zeros(4, 8, 6)
    assert T_shard.logical_constraint(x, "b", "m", None) is x
    d = distribute_tensor(x, fake_mesh, [Replicate(), Replicate()])
    assert T_shard.logical_constraint(d, "b", "m", None) is d
    T_shard.set_axis_map({"b": ("data",), "m": "model", "d": "data"})
    try:
        y = T_shard.logical_constraint(d, "b", "m", None)
        assert T_shard.logical_constraint(x, "b", "m", None) is x
    finally:
        T_shard.set_axis_map(None)
    assert isinstance(y, DTensor)
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert y.to_local().shape == (2, 4, 6)
