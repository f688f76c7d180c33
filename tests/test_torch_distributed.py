"""PyTorch port, the distribution layer: ``ring_allgather_matmul``
(``repro_torch.distributed.overlap``) on four gloo ranks against the JAX
package's ring on four forced host devices, ``ElasticMesh``
(``repro_torch.train.fault``): its (2, 2) mesh on four gloo ranks, with a
reduced starcoder2 train state re-placed on it by ``reshard_state``, and
a reduced starcoder2 training run that passes its state through
``reshard_state`` halfway and ends bit for bit at the uninterrupted run's
loss."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.pipeline import (DataConfig,  # noqa: E402
                                       SyntheticTokenPipeline)
from repro_torch.distributed.sharding import (AXIS_MAP_SINGLE,  # noqa: E402
                                              resolve_specs)
from repro_torch.models.model import Model, param_specs  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.fault import ElasticMesh  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_train_step)

_SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")

# x (64, 32) row-sharded and w (32, 48) column-sharded over four ranks
_PORT_RING = r"""
import json, os, sys, tempfile
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp

def rank_main(rank, p, path, out):
    dist.init_process_group("gloo", init_method="file://" + path,
                            rank=rank, world_size=p)
    from repro_torch.distributed.overlap import ring_allgather_matmul
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 32))
                         .astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(32, 48))
                         .astype(np.float32))
    s, f = 64 // p, 48 // p
    y = ring_allgather_matmul(x[rank * s:(rank + 1) * s],
                              w[:, rank * f:(rank + 1) * f])
    np.save(os.path.join(out, f"{rank}.npy"), y.numpy())
    dist.destroy_process_group()

if __name__ == "__main__":
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    tmp = tempfile.mkdtemp()
    mp.spawn(rank_main, args=(4, os.path.join(tmp, "store"), sys.argv[1]),
             nprocs=4, join=True)
    print("OK")
"""

# reduced starcoder2-15b's train state, one step in (int8 moments, so
# that every moment carries a scale), re-placed on the (2, 2) mesh of an
# ElasticMesh over four gloo ranks
_PORT_RESHARD = r"""
import os, sys, tempfile
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp

def rank_main(rank, path, out):
    dist.init_process_group("gloo", init_method="file://" + path,
                            rank=rank, world_size=4)
    from torch.distributed.tensor import DTensor
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.distributed.sharding import (AXIS_MAP_SINGLE,
                                                  PartitionSpec, placements,
                                                  resolve_specs)
    from repro_torch.models.model import Model, param_specs
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.fault import ElasticMesh
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = get_config("starcoder2-15b").reduced()
    opt_cfg = AdamWConfig(lr=3e-3, moments_dtype="int8")
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    state = init_train_state(cfg, model, opt_cfg)
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2, seed=0))
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch(0).items()}
    state, _ = make_train_step(cfg, opt_cfg)(state, batch)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    mu = {n: {k: ({q: t.clone() for q, t in v.items()}
                  if isinstance(v, dict) else v.clone())
              for k, v in m.items()}
          for n, m in state["opt"]["mu"].items()}
    em = ElasticMesh(model_parallel=2, devices=["cpu"] * 4)
    mesh = em.mesh()
    assert tuple(mesh.shape) == (2, 2), mesh.shape
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    specs = resolve_specs(param_specs(cfg), AXIS_MAP_SINGLE)
    new = em.reshard_state(state, mesh, specs)
    split = 0

    def held(t, want, spec, what):
        assert isinstance(t, DTensor), what
        assert tuple(t.placements) == placements(spec, mesh), \
            (what, t.placements, spec)
        full = t.full_tensor()
        assert full.dtype == want.dtype and torch.equal(full, want), what
        return int(any(p.is_shard() for p in t.placements))

    for n, p in new["params"].named_parameters():
        split += held(p.data, params[n], specs[n], n)
    assert set(new["opt"]["mu"]) == set(mu)
    for n, m in new["opt"]["mu"].items():
        spec = specs[n]
        scale = PartitionSpec(*(tuple(spec)[:-1] + (None,)))
        for k, v in m.items():
            held(v["q"], mu[n][k]["q"], spec, n + "." + k)
            held(v["scale"], mu[n][k]["scale"], scale, n + "." + k + "~")
    assert split > 0
    assert int(new["step"].full_tensor()) == 1
    open(os.path.join(out, str(rank)), "w").write(str(split))
    dist.destroy_process_group()

if __name__ == "__main__":
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    tmp = tempfile.mkdtemp()
    mp.spawn(rank_main, args=(os.path.join(tmp, "store"), sys.argv[1]),
             nprocs=4, join=True)
    print("OK")
"""

_REF_RING = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.overlap import ring_allgather_matmul
from repro.launch.mesh import mesh_axis_kwargs
mesh = jax.make_mesh((4,), ("model",), **mesh_axis_kwargs(1))
x = jnp.asarray(np.random.default_rng(0).normal(size=(64, 32)), jnp.float32)
w = jnp.asarray(np.random.default_rng(1).normal(size=(32, 48)), jnp.float32)
with mesh:
    y = ring_allgather_matmul(x, w, mesh)
np.save(sys.argv[1], np.asarray(y))
print("OK")
"""


def _run(code, path, arg, timeout=180):
    """``code`` as a script file (the spawned ranks import their function
    from it), run in a fresh process."""
    path.write_text(code)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(_SRC),
               JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    out = subprocess.run([sys.executable, str(path), arg],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert "OK" in out.stdout, out.stderr[-3000:]


def test_ring_allgather_matmul_on_four_gloo_ranks(tmp_path):
    """Each rank's (S, F/4) block, joined on columns, within 1e-5 of the
    reference's ring and within 1e-4 of x @ w."""
    _run(_PORT_RING, tmp_path / "port_ring.py", str(tmp_path))
    got = np.concatenate([np.load(tmp_path / f"{r}.npy") for r in range(4)],
                         axis=1)
    _run(_REF_RING, tmp_path / "ref_ring.py", str(tmp_path / "ref.npy"))
    ref = np.load(tmp_path / "ref.npy")
    x = np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(32, 48)).astype(np.float32)
    assert got.shape == ref.shape == (64, 48)
    assert np.abs(got - ref).max() < 1e-5
    assert np.abs(got - x @ w).max() < 1e-4


@pytest.fixture
def no_group():
    """Destroys the process group that a mesh of one device makes."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_ring_at_one_rank_sends_nothing(no_group):
    from repro_torch.distributed.overlap import ring_allgather_matmul
    from repro_torch.launch.mesh import make_mesh_for_devices
    mesh = make_mesh_for_devices(1, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(8, 4)))
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 6)))
    y = ring_allgather_matmul(x, w, mesh.get_group("model"))
    assert torch.equal(y, x @ w)


def test_elastic_mesh_counts_and_mesh(no_group):
    em = ElasticMesh(model_parallel=1, devices=["cpu"] * 4)
    assert em.n_data == 4
    em.fail(0)
    em.fail(0)                   # failing a failed device changes nothing
    assert em.n_data == 3 and em.healthy == [1, 2, 3]
    tp = ElasticMesh(model_parallel=2, devices=["cpu"] * 4)
    assert tp.n_data == 2
    tp.fail(3)
    assert tp.n_data == 1
    tp.fail(2)
    tp.fail(1)
    with pytest.raises(RuntimeError, match="model_parallel"):
        tp.n_data
    with pytest.raises(RuntimeError, match="no healthy"):
        tp.fail(0)
    one = ElasticMesh(devices=["cpu"])
    mesh = one.mesh()
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"


def test_reshard_state_onto_a_two_by_two_mesh(tmp_path):
    """On four gloo ranks, ``ElasticMesh(model_parallel=2).mesh()`` is the
    (2, 2) ("data", "model") mesh, and ``reshard_state`` turns every
    parameter and int8 moment (and its scale) into a DTensor with its
    spec's placements whose ``full_tensor()`` is the input bit for
    bit."""
    _run(_PORT_RESHARD, tmp_path / "port_reshard.py", str(tmp_path))
    splits = {(tmp_path / str(r)).read_text() for r in range(4)}
    assert len(splits) == 1 and int(splits.pop()) > 0


def _batches(cfg, steps):
    pipe = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2, seed=0))
    return [{k: torch.from_numpy(v) for k, v in pipe.batch(s).items()}
            for s in range(steps)]


def test_resumed_training_through_reshard_state_is_bit_for_bit(no_group):
    """12 steps of reduced starcoder2-15b, once straight through and once
    with the train state gathered to the host and re-placed on a (1, 1)
    mesh at step 6: the losses agree bit for bit."""
    cfg = get_config("starcoder2-15b").reduced()
    opt_cfg = AdamWConfig(lr=3e-3)
    batches = _batches(cfg, 12)

    def run(reshard_at=None):
        model = Model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
        state = init_train_state(cfg, model, opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        losses = []
        for i, b in enumerate(batches):
            if i == reshard_at:
                em = ElasticMesh(devices=["cpu"])
                state = em.reshard_state(state, em.mesh(), resolve_specs(
                    param_specs(cfg), AXIS_MAP_SINGLE))
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return losses, state

    clean, _ = run()
    resumed, state = run(reshard_at=6)
    assert resumed == clean
    assert all(type(p) is torch.nn.Parameter and p.device.type == "cpu"
               for p in state["params"].parameters())
    assert int(state["step"]) == 12
