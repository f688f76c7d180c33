"""Straggler detection and mitigation (a copy of
``repro/train/straggler.py``, which the port does not import).

Per-step wall time feeds an EWMA; a step exceeding ``threshold x EWMA``
flags a straggler.  The mitigation policy at real multi-host scale is
(1) log + mark the host, (2) after ``trip_limit`` consecutive trips,
signal the elastic controller to evict the host and re-mesh (the
elastic mesh is not ported yet).
The detector is clock-injected so tests drive it deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

__all__ = ["StragglerDetector", "StragglerEvent"]


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    ewma_s: float
    ratio: float


class StragglerDetector:
    def __init__(self, threshold: float = 3.0, alpha: float = 0.1,
                 warmup_steps: int = 5, trip_limit: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup_steps = warmup_steps
        self.trip_limit = trip_limit
        self.clock = clock
        self.ewma: Optional[float] = None
        self.steps = 0
        self.consecutive_trips = 0
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None

    def step_start(self) -> None:
        self._t0 = self.clock()

    def step_end(self, step: int) -> Optional[StragglerEvent]:
        """Returns an event when the step straggled; updates the EWMA with
        non-straggler steps only (so one hiccup doesn't mask the next)."""
        dt = self.clock() - self._t0
        self.steps += 1
        if self.ewma is None:
            self.ewma = dt
            return None
        if self.steps <= self.warmup_steps:
            self.ewma += self.alpha * (dt - self.ewma)
            return None
        ratio = dt / max(self.ewma, 1e-9)
        if ratio > self.threshold:
            ev = StragglerEvent(step, dt, self.ewma, ratio)
            self.events.append(ev)
            self.consecutive_trips += 1
            return ev
        self.consecutive_trips = 0
        self.ewma += self.alpha * (dt - self.ewma)
        return None

    @property
    def should_evict(self) -> bool:
        return self.consecutive_trips >= self.trip_limit
