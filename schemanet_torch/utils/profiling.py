"""The training loop's throughput meter (port of ``StepTimer`` in
``schemanet_tpu/utils/profiling.py``). Host clock: a caller that wants the
device's rate synchronises before it reads one."""

from __future__ import annotations

import time
from typing import Optional


class StepTimer:
    """Rolling throughput meter: ``step(n_items)`` after every step returns
    steps/s and items/s once every ``window`` steps, else None."""

    def __init__(self, window: int = 50):
        self.window = window
        self.reset()

    def reset(self):
        self._t0: Optional[float] = None
        self._count = 0
        self._items = 0

    def step(self, n_items: int = 0):
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return None
        self._count += 1
        self._items += n_items
        if self._count >= self.window:
            dt = now - self._t0
            result = {"steps_per_sec": self._count / dt, "items_per_sec": self._items / dt}
            self.reset()
            self._t0 = now
            return result
        return None
