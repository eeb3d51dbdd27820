"""Tracing and timing helpers (port of ``schemanet_tpu/utils/profiling.py``):
a profiler trace written to a directory (``trace``), the training loop's
throughput meter (``StepTimer``) and a wait for every tensor of a nested
structure (``block_tree``). ``StepTimer`` reads the host clock: a caller that
wants the device's rate synchronises before it reads one."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed code (host activity, and the card's where one is
    present) and write a Chrome/Perfetto trace, ``trace_<pid>_<ns>.json``,
    into ``log_dir`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


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


def block_tree(tree):
    """Wait for the device work behind every CUDA tensor in ``tree`` (dicts,
    lists and tuples, nested): each CUDA device that holds one is
    synchronised once. Returns ``tree`` unchanged (accurate timing
    boundaries)."""
    devices = set()

    def walk(node):
        if torch.is_tensor(node):
            if node.is_cuda:
                devices.add(node.device)
        elif isinstance(node, dict):
            for value in node.values():
                walk(value)
        elif isinstance(node, (list, tuple)):
            for value in node:
                walk(value)

    walk(tree)
    for device in devices:
        torch.cuda.synchronize(device)
    return tree
