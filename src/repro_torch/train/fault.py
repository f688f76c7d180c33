"""Fault injection and elastic re-meshing (a port of
``repro/train/fault.py``).

``FaultInjector`` deterministically raises simulated device failures at
chosen steps (tests, and the restart path of ``train.loop``).
``ElasticMesh`` rebuilds the (data, model) mesh over the currently
healthy devices and re-shards live train state onto it -- the
single-process analogue of the coordinator-led re-mesh a large
deployment performs when a host drops, with the same state-movement
semantics (gather to the host, re-place).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set

import torch

from ..distributed.sharding import is_dtensor
from ..launch.mesh import local_devices, make_mesh_for_devices

__all__ = ["SimulatedDeviceFailure", "FaultInjector", "ElasticMesh"]


class SimulatedDeviceFailure(RuntimeError):
    def __init__(self, step: int, device_id: int):
        super().__init__(f"simulated failure of device {device_id} at step "
                         f"{step}")
        self.step = step
        self.device_id = device_id


@dataclasses.dataclass
class FaultInjector:
    """Raise a SimulatedDeviceFailure at each step in ``fail_at``."""

    fail_at: Set[int] = dataclasses.field(default_factory=set)
    failed_devices: List[int] = dataclasses.field(default_factory=list)

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            dev = len(self.failed_devices)
            self.failed_devices.append(dev)
            raise SimulatedDeviceFailure(step, dev)


class ElasticMesh:
    """Tracks the healthy device count and rebuilds the mesh after faults.

    ``devices=None`` means the local devices of the card (``launch.mesh.
    local_devices``); pass a list (``[torch.device("cpu")]``) to run
    elsewhere.  With one device the mesh is (1, 1) over a process group of
    one rank, and the pipeline re-shards via
    ``SyntheticTokenPipeline.reshard``: batches stay bit-identical because
    the stream is counter-mode keyed by (seed, step, shard)."""

    def __init__(self, model_parallel: int = 1,
                 devices: Optional[Sequence] = None):
        self.model_parallel = model_parallel
        self.all_devices = [torch.device(d) for d in devices] \
            if devices is not None else local_devices()
        self.healthy = list(range(len(self.all_devices)))

    def fail(self, device_id: int) -> None:
        if device_id in self.healthy:
            self.healthy.remove(device_id)
        if not self.healthy:
            raise RuntimeError("no healthy devices left")

    @property
    def n_data(self) -> int:
        n = len(self.healthy) // self.model_parallel
        if n == 0:
            raise RuntimeError("not enough healthy devices for "
                               "model_parallel")
        return n

    def mesh(self):
        usable = self.n_data * self.model_parallel
        return make_mesh_for_devices(usable, self.model_parallel,
                                     device=self.all_devices[0])

    def reshard_state(self, state: Dict, mesh, specs: Dict) -> Dict:
        """Move live train state onto the rebuilt mesh (gather to the
        host, re-place).  ``state`` is the train step's ``{"params":
        Model, "opt": ..., "step": ...}``; ``specs`` the resolved
        ``PartitionSpec`` of each parameter by name (``param_specs``
        through ``resolve_specs``).  On a mesh of one device every tensor
        comes back a plain tensor on that device, the state the train
        step takes; on more devices the parameters and their moments
        become DTensors with the specs' placements (an int8 moment's
        scale unsplit on its last dim) and the rest is replicated.  The
        model's parameters are replaced in place; returns the new state
        dict."""
        from ..distributed.sharding import PartitionSpec, placements
        one = mesh.size() == 1
        dev = torch.device(mesh.device_type, 0) \
            if mesh.device_type == "cuda" else torch.device("cpu")

        def host(t):
            if is_dtensor(t):
                t = t.full_tensor()
            return t.detach().to("cpu")

        def place(t, spec):
            t = host(t).to(dev)
            if one:
                return t
            from torch.distributed.tensor import distribute_tensor
            return distribute_tensor(t, mesh, placements(spec, mesh))

        def scale_spec(spec):
            return PartitionSpec(*(tuple(spec)[:-1] + (None,))) \
                if len(spec) else spec

        model = state["params"]
        mods = dict(model.named_modules())
        with torch.no_grad():
            for name, p in list(model.named_parameters()):
                owner, _, attr = name.rpartition(".")
                setattr(mods[owner], attr, torch.nn.Parameter(
                    place(p, specs[name]), requires_grad=p.requires_grad))
        rep = PartitionSpec()
        mu = {}
        for name, m in state["opt"]["mu"].items():
            spec = specs[name]
            mu[name] = {k: ({"q": place(v["q"], spec),
                             "scale": place(v["scale"], scale_spec(spec))}
                            if isinstance(v, dict) else place(v, spec))
                        for k, v in m.items()}
        opt = dict(state["opt"], mu=mu, step=place(state["opt"]["step"], rep))
        return dict(state, params=model, opt=opt,
                    step=place(state["step"], rep))
