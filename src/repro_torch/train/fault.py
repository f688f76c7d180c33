"""Fault injection (a port of the host-side half of
``repro/train/fault.py``).

``FaultInjector`` deterministically raises simulated device failures at
chosen steps (tests, and the restart path of ``train.loop``).  The
reference's ``ElasticMesh``, which rebuilds the (data, model) mesh over
the healthy devices, comes with the port's sharding.
"""
from __future__ import annotations

import dataclasses
from typing import List, Set

__all__ = ["SimulatedDeviceFailure", "FaultInjector"]


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
