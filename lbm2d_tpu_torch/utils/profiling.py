"""Profiling / tracing helpers (SURVEY.md section 5 tracing parity;
counterpart of ``lbm2d_tpu/utils/profiling.py``).

The reference keeps a per-phase wall-clock dict and prints a breakdown every
10 frames (core/simulation_ops.py:84,100-209); the loop here does the same
(pipeline/sim_loop.py timings). This module adds an MLUPS counter, a simple
phase-timer aggregate, and an optional torch.profiler trace context that
writes a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


def mlups(nx: int, ny: int, steps: int, seconds: float) -> float:
    """Million lattice-site updates per second."""
    return nx * ny * steps / max(seconds, 1e-12) / 1e6


class PhaseTimer:
    """Accumulates wall-clock per named phase; reference timings-dict analog."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:>14}: {tot:8.3f}s total, {tot / n * 1e3:8.2f}ms avg x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler trace context; no-op when log_dir is falsy.

    Records CPU activity, and CUDA activity (the block's GPU kernels) where
    a CUDA device is available, and writes ``trace_<pid>_<n>.json`` (Chrome
    trace format) under ``log_dir`` when the block exits, as the JAX
    package's trace is written on exit."""
    if not log_dir:
        yield
        return
    import torch
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
