"""The traced run's events, read from ``torch.profiler``.

The profiler runs on the thread that drives client 0: it records that
thread's ranges (the program's ``frtt.*`` ranges and the benchmark's own
``bench.request`` around each request and ``bench.window`` around the
traced window) and every operation on the device, from every thread.

Busy time is the union of the intervals in which a kernel, a copy or a
set ran on the device, on any stream, inside the window: overlapping
streams count once.  Kernel time is the sum of the kernels' durations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Trace", "from_profiler", "union_ns", "gaps"]

DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}


@dataclass
class Trace:
    window: tuple               # (start, end) ns of bench.window
    device: list                # (name, kind, start ns, end ns), inside the window
    ranges: list                # (name, start ns, end ns) on client 0's thread
    requests: int = 0           # client 0's requests inside the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, _, s, e in self.device]) / 1e9

    def kernel_s(self) -> float:
        return sum(e - s for _, k, s, e in self.device if k == "kernel") / 1e9

    def range_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.ranges if n == name) / 1e9

    def top_device_ops(self, k: int = 10) -> list:
        total: dict = {}
        for name, _, s, e in self.device:
            total[name] = total.get(name, 0) + (e - s)
        return [[n, t / 1e9] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]

    def idle_by_range(self, k: int = 10) -> list:
        """Idle time inside the window, summed by the innermost range open
        on client 0's thread at each gap's middle ("none" outside any)."""
        spans = sorted((s, e) for _, _, s, e in self.device)
        idle: dict = {}
        marks = []
        for g0, g1 in gaps(spans, *self.window):
            marks.append(((g0 + g1) // 2, g1 - g0))
        marks.sort()
        bounds = sorted([(s, 0, i) for i, (_, s, _) in enumerate(self.ranges)]
                        + [(e, 1, i) for i, (_, _, e) in enumerate(self.ranges)])
        stack: list = []
        j = 0
        for t, dur in marks:
            while j < len(bounds) and bounds[j][0] <= t:
                _, kind, i = bounds[j]
                if kind == 0:
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                j += 1
            name = self.ranges[stack[-1]][0] if stack else "none"
            idle[name] = idle.get(name, 0) + dur
        return [[n, t / 1e9] for n, t in sorted(idle.items(), key=lambda x: -x[1])[:k]]


def union_ns(spans) -> int:
    """Length of the union of (start, end) intervals."""
    if not spans:
        return 0
    a = np.array(sorted(spans), np.int64)
    ends = np.maximum.accumulate(a[:, 1])
    starts = np.maximum(a[:, 0], np.concatenate([[a[0, 0]], ends[:-1]]))
    return int(np.clip(ends - starts, 0, None)[1:].sum() + (a[0, 1] - a[0, 0]))


def gaps(spans, lo: int, hi: int):
    """The idle intervals of [lo, hi) between sorted (start, end) spans."""
    t = lo
    for s, e in spans:
        if s > t:
            yield (t, min(s, hi))
        t = max(t, e)
        if t >= hi:
            return
    if t < hi:
        yield (t, hi)


def _kind(e, name: str) -> str:
    """An event's activity: its ``activity_type`` where the profiler gives
    one; else from its device and name (the device's copy of a range
    carries the range's name)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() if callable(kind) else kind
    ranged = name.startswith(("frtt.", "bench."))
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return "user_annotation" if ranged else "cpu_op"
    if ranged:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _span(e) -> tuple:
    start = e.start_ns()
    return start, start + e.duration_ns()


def from_profiler(prof) -> Trace | None:
    """A Trace of a stopped ``torch.profiler.profile``: the window of its
    ``bench.window`` range, the device operations inside it, and the
    ``frtt.*`` and ``bench.*`` ranges of client 0's thread."""
    events = prof.profiler.kineto_results.events()
    window = None
    ranges = []
    device = []
    for e in events:
        name = e.name()
        kind = _kind(e, name)
        if kind == "user_annotation":
            if name == "bench.window":
                window = _span(e)
            elif name.startswith(("frtt.", "bench.")):
                ranges.append((name, *_span(e)))
        elif kind in DEVICE_KINDS:
            device.append((name, kind, *_span(e)))
    if window is None:
        return None
    lo, hi = window
    device = [(n, k, max(s, lo), min(e, hi)) for n, k, s, e in device if e > lo and s < hi]
    ranges = [(n, s, e) for n, s, e in ranges if e > lo and s < hi]
    requests = sum(1 for n, _, _ in ranges if n == "bench.request")
    return Trace(window, device, ranges, requests)
