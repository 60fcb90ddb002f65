"""The device trace of a traced run: ``torch.profiler`` over a sub-window,
reduced to the device's busy time, the operations that took it, and the
idle gaps named by what the host was doing meanwhile.

Busy time is the union of the device-side intervals (kernels, copies,
memsets): two that overlap, on two streams, count once.
"""

from __future__ import annotations

import collections
import heapq
import time
from typing import Dict, List, Sequence, Tuple

import torch


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals, in their unit."""
    merged = merge(intervals)
    return float(sum(e - s for s, e in merged))


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as disjoint, sorted intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(merged: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle intervals between disjoint sorted intervals."""
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]


def name_gaps(idle: Sequence[Tuple[float, float]],
              host: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Idle time summed by the host operation running at each gap's
    midpoint, the one begun last where several are ("host: no operation"
    where none is)."""
    host = sorted(host)
    live: list = []  # heap of (-start, end, name) of operations begun
    out: Dict[str, float] = collections.Counter()
    i = 0
    for s, e in sorted(idle):
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(live, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while live and live[0][1] < mid:
            heapq.heappop(live)
        out[live[0][2] if live else "host: no operation"] += e - s
    return dict(out)


def _events(prof):
    """(device intervals with names, host intervals with names) in seconds
    on the profiler's clock."""
    dev, host = [], []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            s = e.start_ns() * 1e-9
            d = e.duration_ns() * 1e-9
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    dev.append((s, s + d, e.name()))
            elif not e.is_user_annotation() and d > 0:
                host.append((s, s + d, e.name()))
    except AttributeError:
        for e in prof.events():
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation:
                    dev.append((s, t, e.name))
            else:
                host.append((s, t, e.name))
    return dev, host


def reduce_events(dev, host, window_s: float) -> dict:
    """busy_s, window_s and the ``breakdown`` of a traced window."""
    merged = merge([(s, e) for s, e, _ in dev])
    busy = float(sum(e - s for s, e in merged))
    by_op = collections.Counter()
    for s, e, name in dev:
        by_op[name] += e - s
    idle = name_gaps(gaps(merged), host)
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy, "window_s": float(window_s),
        "device_ops": [[n[:120], float(t)] for n, t in by_op.most_common(10)],
        "idle_gaps": [[n[:120], float(t)] for n, t in top_idle],
    }


class DeviceTrace:
    """Start and stop ``torch.profiler`` around a sub-window of a run; the
    window is bounded by device syncs, so no work issued outside it runs in
    it."""

    def __init__(self):
        self.prof = None
        self.window_s = None
        self._t0 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    @property
    def done(self) -> bool:
        return self.window_s is not None

    def reduce(self) -> dict:
        dev, host = _events(self.prof)
        self.prof = None
        return reduce_events(dev, host, self.window_s)
