"""Straggler / health monitoring for long runs (a copy of
``repro.train.straggler``: pure Python).

On real fleets the failure modes are: a host slows down (thermals, ECC
retries), a step hangs (network), or throughput decays (input pipeline).
This monitor tracks a step-time EWMA + variance, flags outlier steps, and
exposes hooks the launcher uses to act (log, or abort).

The caller ends each timed step in a device synchronisation (the host
clock otherwise measures only the enqueue).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class StragglerMonitor:
    ewma_alpha: float = 0.05
    outlier_factor: float = 3.0  # step > factor × ewma → straggler event
    hang_factor: float = 10.0  # step > factor × ewma → treat as hang
    on_straggler: Callable[[int, float, float], None] | None = None
    on_hang: Callable[[int, float, float], None] | None = None

    _ewma: float | None = None
    _last_start: float | None = None
    straggler_steps: int = 0
    hang_steps: int = 0

    def step_start(self):
        self._last_start = time.monotonic()

    def step_end(self, step: int) -> dict:
        dt = time.monotonic() - self._last_start
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> dict:
        """Feed one step duration; returns the current verdict."""
        verdict = {"step": step, "dt": dt, "ewma": self._ewma, "status": "ok"}
        if self._ewma is not None:
            if dt > self.hang_factor * self._ewma:
                self.hang_steps += 1
                verdict["status"] = "hang"
                if self.on_hang:
                    self.on_hang(step, dt, self._ewma)
            elif dt > self.outlier_factor * self._ewma:
                self.straggler_steps += 1
                verdict["status"] = "straggler"
                if self.on_straggler:
                    self.on_straggler(step, dt, self._ewma)
        # outliers don't poison the baseline
        if verdict["status"] == "ok" or self._ewma is None:
            self._ewma = dt if self._ewma is None else (
                (1 - self.ewma_alpha) * self._ewma + self.ewma_alpha * dt)
        verdict["ewma"] = self._ewma
        return verdict
