"""The traced run's device trace, read from ``torch.profiler``'s raw events.

A device operation (kernel, copy, fill) is attributed to the host event
that launched it: its runtime call (a kernel the port launches through
``ctypes`` has no op around it), else the op the profiler links it to.
A layer's device time is the time of the operations launched inside the
benchmark's ``record_function`` ranges of that layer (``perfbench.<layer>``,
opened and closed by forward hooks on the layer's module): attribution by
range, never by kernel name.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

RANGE_PREFIX = "perfbench."


class Trace:
    def __init__(self, device_ops: List[Tuple[str, int, int, int]],
                 ranges: Dict[str, List[Tuple[int, int]]], host_ops: List[Tuple[str, int, int]],
                 window_s: float):
        """``device_ops``: (name, start ns, end ns, launch ns on the host, or
        -1); ``ranges``: layer -> host intervals; ``host_ops``: (name, start,
        end) of the host's ops, for naming idle gaps."""
        self.device_ops = sorted(device_ops, key=lambda e: e[1])
        self.ranges = {k: sorted(v) for k, v in ranges.items()}
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        self.window_s = window_s

    # -- the device as a whole ------------------------------------------------
    def segments(self) -> List[Tuple[int, int, int]]:
        """Union of the device operations' intervals: (start, end, index of
        the op that opened the segment)."""
        out: List[list] = []
        for i, (_, s, e, _) in enumerate(self.device_ops):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e, i])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e, _ in self.segments()) * 1e-9

    def idle_share(self) -> Optional[float]:
        if not self.device_ops or self.window_s <= 0:
            return None
        return max(0.0, 1.0 - self.busy_s() / self.window_s)

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, int] = defaultdict(int)
        for name, s, e, _ in self.device_ops:
            total[name] += e - s
        return [[k, v * 1e-9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest gaps between device segments, each named by the
        host op that launched the operation ending the gap (and the layer
        range around it)."""
        segs = self.segments()
        gaps = []
        for (s0, e0, _), (s1, _, i1) in zip(segs, segs[1:]):
            gaps.append((s1 - e0, i1))
        gaps.sort(key=lambda g: -g[0])
        return [[self._host_name(self.device_ops[i][3]), g * 1e-9] for g, i in gaps[:n]]

    def _host_name(self, launch_ns: int) -> str:
        if launch_ns < 0:
            return "unlinked"
        inner = None
        for name, s, e in self.host_ops:  # innermost op around the launch
            if s > launch_ns:
                break
            if e >= launch_ns and not name.startswith(RANGE_PREFIX):
                inner = name
        layer = self.layer_at(launch_ns)
        return f"{inner or 'host'}{' in ' + layer if layer else ''}"

    def layer_at(self, t: int) -> Optional[str]:
        for layer, spans in self.ranges.items():
            i = bisect.bisect_right(spans, (t, 1 << 62)) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                return layer
        return None

    # -- one layer --------------------------------------------------------------
    def calls(self, layer: str) -> int:
        return len(self.ranges.get(layer, ()))

    def layer_device_s(self, layer: str) -> float:
        """Device time of the operations launched inside the layer's ranges."""
        spans = self.ranges.get(layer)
        if not spans:
            return 0.0
        total = 0
        for _, s, e, launch in self.device_ops:
            if launch < 0:
                continue
            i = bisect.bisect_right(spans, (launch, 1 << 62)) - 1
            if i >= 0 and spans[i][0] <= launch <= spans[i][1]:
                total += e - s
        return total * 1e-9


def from_profiler(prof, window_s: float) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile`` session."""
    events = prof.profiler.kineto_results.events()
    cpu_by_id: Dict[int, int] = {}
    runtime_by_id: Dict[int, int] = {}
    ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    host_ops, device = [], []
    for ev in events:
        name = ev.name()
        if str(ev.device_type()).endswith("CPU"):
            start, end = ev.start_ns(), ev.end_ns()
            if _runtime(ev, name):
                runtime_by_id[ev.correlation_id()] = start
                continue
            cpu_by_id[ev.correlation_id()] = start
            if name.startswith(RANGE_PREFIX):
                ranges[name[len(RANGE_PREFIX):]].append((start, end))
            host_ops.append((name, start, end))
        elif not name.startswith(RANGE_PREFIX) and not _annotation(ev):
            device.append(ev)
    ops = []
    for ev in device:
        launch = runtime_by_id.get(ev.correlation_id(),
                                   cpu_by_id.get(ev.linked_correlation_id(), -1))
        ops.append((ev.name(), ev.start_ns(), ev.end_ns(), launch))
    return Trace(ops, ranges, host_ops, window_s)


def _runtime(ev, name: str) -> bool:
    """A CUDA runtime or driver call (the launch of a device operation)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        kind = str(kind()).lower()
        return "runtime" in kind or "driver" in kind
    return name.startswith(("cuda", "cu")) and "::" not in name


def _annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False
