"""Profiling / tracing helpers (SURVEY.md section 5 tracing parity;
counterpart of ``lbm2d_tpu/utils/profiling.py``).

The port's spans live here, in one registry. ``span(name, **attrs)`` is a
context manager around one piece of work of a layer. A span records its
name, start and end (``time.perf_counter_ns``), thread, parent span (the
innermost span open on its thread) and the id of the request it serves:
``chunk=``, inherited from the parent where not given (a lockstep group's
``(group_uid, chunk index)``, a validation's chunk index). Other keyword
arguments, and ``set(**attrs)`` on the span while it is open, are kept
with it. ``took(seconds)`` on an open span gives it the length of work
timed elsewhere (a device copy, between two CUDA events), ending where the
span closes.

Recording is on while a ``torch.profiler`` is active (the profiler's own
process-wide flag, which worker threads see too) or inside
``recording()`` (``outputs.enable_profiling``). A span records if recording
was on when it was entered; while a profiler is active it also opens a
``record_function`` range of its name, so the span is on the device
trace's clock. While recording is off a span site costs one flag check and
one query of the profiler's flag: it reads no clock, makes no record and
enters no ``record_function`` (which costs microseconds even with no
profiler running, and is entered only while one runs).

The registry keeps the newest ``CAPACITY`` spans in memory and counts the
ones it drops.

Also an MLUPS counter, ``PhaseTimer`` (per-name totals over a registry of
its own that always records) and ``device_trace``, a torch.profiler context
that writes a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.autograd.profiler as _ap

CAPACITY = 1 << 16  # spans the program's registry holds


def mlups(nx: int, ny: int, steps: int, seconds: float) -> float:
    """Million lattice-site updates per second."""
    return nx * ny * steps / max(seconds, 1e-12) / 1e6


class Span:
    """One recorded span. Times are ``time.perf_counter_ns()``; ``whole``
    is False where recording had stopped before the span ended (a profiler
    stopped inside it), so part of its work went unrecorded."""

    __slots__ = ("id", "name", "t0", "t1", "thread", "parent", "chunk", "attrs", "whole",
                 "seq")

    def __init__(self, id, name, thread, parent, chunk, attrs):
        self.id, self.name, self.thread, self.parent = id, name, thread, parent
        self.chunk, self.attrs = chunk, attrs
        self.t0 = self.t1 = 0
        self.whole = False
        self.seq = -1  # its place among the registry's spans, in the order they ended

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def __repr__(self):
        return (f"Span({self.name!r}, {self.seconds * 1e6:.1f} us, chunk={self.chunk!r}, "
                f"parent={self.parent}, thread={self.thread}, {self.attrs})")


class _Off:
    """What a span site gets while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        return False

    def set(self, **attrs) -> None:
        pass

    def took(self, seconds: float) -> None:
        pass


_OFF = _Off()
_LOCAL = threading.local()  # the stack of this thread's open spans


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Open:
    """A span being recorded."""

    __slots__ = ("reg", "rec", "rf", "ns")

    def __init__(self, reg, rec, rf):
        self.reg, self.rec, self.rf = reg, rec, rf
        self.ns = None  # the length ``took`` gave, where it was called

    def set(self, **attrs) -> None:
        self.rec.attrs.update(attrs)

    def took(self, seconds: float) -> None:
        self.ns = int(seconds * 1e9)

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        _stack().append(self.rec)
        self.rec.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, typ, val, tb):
        rec = self.rec
        rec.t1 = time.perf_counter_ns()
        if self.ns is not None:
            rec.t0 = rec.t1 - self.ns
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        rec.whole = self.reg.on()
        self.reg._add(rec)
        return False


class Registry:
    """Spans of one process, kept in memory.

    ``always`` records whether or not a profiler runs (``PhaseTimer``'s
    registry); the program's registry records as the module docstring
    says."""

    def __init__(self, capacity: int = CAPACITY, always: bool = False):
        self._forced = 1 if always else 0
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._added = 0
        self._ids = 0
        self.last: Dict[str, Span] = {}  # the newest span of each name

    # -- recording ----------------------------------------------------------

    def on(self) -> bool:
        return bool(self._forced or _ap._is_profiler_enabled)

    def span(self, name: str, chunk=None, **attrs):
        prof = _ap._is_profiler_enabled
        if not (self._forced or prof):
            return _OFF
        stack = _stack()
        parent = stack[-1] if stack else None
        if chunk is None and parent is not None:
            chunk = parent.chunk
        with self._lock:
            self._ids += 1
            sid = self._ids
        rec = Span(sid, name, threading.get_ident(), parent.id if parent else None, chunk, attrs)
        return _Open(self, rec, _ap.record_function(name) if prof else None)

    @contextlib.contextmanager
    def recording(self, on: bool = True):
        """Record inside the block whether or not a profiler runs (a no-op
        for ``on`` False)."""
        if not on:
            yield
            return
        with self._lock:
            self._forced += 1
        try:
            yield
        finally:
            with self._lock:
                self._forced -= 1

    def _add(self, rec: Span) -> None:
        with self._lock:
            self._spans.append(rec)
            rec.seq = self._added
            self._added += 1
            self.last[rec.name] = rec

    # -- reading ------------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Spans recorded and no longer held (the oldest go first)."""
        with self._lock:
            return self._added - len(self._spans)

    def mark(self) -> int:
        """A position for ``since``: the count of spans recorded so far; a
        span recorded later has a ``seq`` at least this."""
        with self._lock:
            return self._added

    def since(self, mark: int) -> List[Span]:
        """The spans recorded after ``mark`` that the registry still holds."""
        with self._lock:
            k = min(self._added - mark, len(self._spans))
            return list(self._spans)[len(self._spans) - k:] if k > 0 else []

    def snapshot(self, reset: bool = False) -> List[Span]:
        """The spans held, oldest first; ``reset`` empties the registry."""
        with self._lock:
            out = list(self._spans)
            if reset:
                self._clear()
            return out

    def reset(self) -> None:
        with self._lock:
            self._clear()

    def _clear(self) -> None:
        self._spans.clear()
        self._added = 0
        self.last.clear()


def totals(spans: Iterable[Span]) -> Tuple[Dict[str, float], Dict[str, int]]:
    """(seconds, count) of spans by name."""
    tot: Dict[str, float] = {}
    n: Dict[str, int] = {}
    for s in spans:
        tot[s.name] = tot.get(s.name, 0.0) + s.seconds
        n[s.name] = n.get(s.name, 0) + 1
    return tot, n


REGISTRY = Registry()
span = REGISTRY.span
recording = REGISTRY.recording


def current_chunk():
    """The chunk of the innermost span this thread has open (None where no
    span is open or recording is off): for work a span hands to another
    thread."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1].chunk if stack else None


class PhaseTimer:
    """Accumulates wall-clock per named phase; reference timings-dict
    analog. Its phases are spans of a registry of its own that records
    whether or not a profiler runs; ``totals`` and ``counts`` are per-name
    sums over it."""

    def __init__(self):
        self.registry = Registry(always=True)

    def phase(self, name: str):
        return self.registry.span(name)

    @property
    def totals(self) -> Dict[str, float]:
        return totals(self.registry.snapshot())[0]

    @property
    def counts(self) -> Dict[str, int]:
        return totals(self.registry.snapshot())[1]

    def report(self) -> str:
        tot, counts = totals(self.registry.snapshot())
        lines = []
        for name in sorted(tot, key=tot.get, reverse=True):
            lines.append(f"{name:>14}: {tot[name]:8.3f}s total, "
                         f"{tot[name] / counts[name] * 1e3:8.2f}ms avg x{counts[name]}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler trace context; no-op when log_dir is falsy.

    Records CPU activity, and CUDA activity (the block's GPU kernels) where
    a CUDA device is available, and writes ``trace_<pid>_<n>.json`` (Chrome
    trace format) under ``log_dir`` when the block exits, as the JAX
    package's trace is written on exit. The program's spans inside the
    block appear in it as user annotations of their names."""
    if not log_dir:
        yield
        return
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
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        tag = f"trace_{os.getpid()}_"
        n = sum(f.startswith(tag) for f in os.listdir(log_dir))
        prof.export_chrome_trace(os.path.join(log_dir, f"{tag}{n}.json"))
