"""Meshes and device placement (a port of ``repro/launch/mesh.py``).

FUNCTIONS, not module-level constants: importing this module starts no
process group and touches no device, so the tests see one CPU while the
dry-run (``launch.dryrun``, a ``fake`` process group of 256 or 512
ranks) sees the full placeholder pod.

Two kinds of placement live here:

* the LM meshes -- ``make_production_mesh`` (the (16, 16) single-pod and
  (2, 16, 16) multi-pod ``DeviceMesh``, which need a world of 256 or 512
  ranks and so exist only under the dry-run's fake group) and
  ``make_mesh_for_devices`` (the elastic (data, model) mesh of the train
  loop).  Where no default process group exists, a mesh over one device
  makes a world of one rank, with a file store in a temporary directory
  (NCCL on the card, gloo on the CPU);
* the DSE placements -- ``candidate_sharding``, ``population_sharding``,
  ``island_sharding`` and ``default_islands`` -- which read the local
  devices (the CUDA devices, or the CPU when the caller asks for it)
  through ``local_devices``, the one function the tests patch.  They
  return the list of devices a batch or a population is split over, or
  ``None`` (one island) on one device, as the reference's do.

The reference's ``mesh_axis_kwargs`` has no counterpart: it papers over
a JAX version difference (``jax.sharding.AxisType`` and the
``axis_types`` keyword of ``jax.make_mesh``), and torch's
``init_device_mesh`` has no such keyword.
"""
from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import torch

from ..device import resolve_device

__all__ = ["make_production_mesh", "make_mesh_for_devices", "local_devices",
           "candidate_sharding", "population_sharding", "island_sharding",
           "default_islands"]


def local_devices(device=None) -> List[torch.device]:
    """The devices a DSE batch can spread over: every local CUDA device
    when ``device`` resolves to the card (``None``), else ``[device]``
    (the CPU is one device)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def candidate_sharding(device=None) -> Optional[List[torch.device]]:
    """The devices the DSE candidate batch axis splits over, or ``None``
    on a single device (where sharding is a no-op anyway).

    The one placement every engine evaluation path uses: a padded batch
    splits into equal contiguous blocks, one per device, so a sweep or GA
    population spans whatever devices exist.  Batch sizes must be a
    multiple of the device count (``EvalEngine._pad_size`` rounds up)."""
    devs = local_devices(device)
    return devs if len(devs) > 1 else None


def population_sharding(device=None) -> Optional[List[torch.device]]:
    """The GA generation loop's placement: the population splits over the
    same devices the evaluation batches use.  Same divisibility rule: the
    population must be a multiple of the device count or the loop keeps
    one device (it checks before placing)."""
    return candidate_sharding(device)


def island_sharding(n_islands: int, device=None
                    ) -> Optional[List[torch.device]]:
    """Placement of the island-model GA (``core.dse.ga_device`` fused
    loop): the population is logically (islands, P/islands, GENOME_LEN),
    and one contiguous block of islands lives on each device; the ring
    migration moves the migrants across device boundaries.  ``None`` on a
    single device or when ``n_islands`` does not divide over the devices
    (the caller keeps one device -- same numbers, no transfers)."""
    devs = local_devices(device)
    if len(devs) <= 1 or int(n_islands) % len(devs) != 0:
        return None
    return devs


def default_islands(population: int, device=None) -> int:
    """Island count the fused GA defaults to: one island per local device
    when the population splits evenly, else a single panmictic island
    (which keeps the host-memo loop's exact genome stream)."""
    ndev = len(local_devices(device))
    if ndev > 1 and population % ndev == 0 and population // ndev >= 2:
        return ndev
    return 1


def _ensure_world(n_devices: int, device_type: str) -> None:
    """A default process group of ``n_devices`` ranks: the caller's, or a
    world of one made here (file store in a fresh temporary directory,
    NCCL on the card, gloo on the CPU)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if n_devices != 1:
            raise RuntimeError(
                f"a mesh of {n_devices} devices needs a process group of "
                f"{n_devices} ranks: init_process_group first")
        path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"),
                            "store")
        if device_type == "cuda":
            torch.cuda.set_device(0)    # NCCL's device for the one rank
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"file://{path}", rank=0, world_size=1)
    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"process group has {dist.get_world_size()} "
                           f"ranks; the mesh needs {n_devices}")


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
    "model") mesh over the ranks of the default process group, which
    must number 256 or 512 (the dry-run's fake group).  Its device type is
    the CPU's: the dry-run traces the plain route on fake CPU tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _ensure_world(n, "cpu")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_mesh_for_devices(n_devices: int, model_parallel: int = 1,
                          device=None):
    """Elastic mesh for whatever devices are healthy (train loop and
    tests): (n / model_parallel, model_parallel) over ("data", "model")
    on ``device``'s type (``None``: the card)."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model_parallel={model_parallel}")
    from torch.distributed.device_mesh import init_device_mesh
    dtype = resolve_device(device).type
    _ensure_world(n_devices, dtype)
    return init_device_mesh(dtype, (n_devices // model_parallel,
                                    model_parallel),
                            mesh_dim_names=("data", "model"))
