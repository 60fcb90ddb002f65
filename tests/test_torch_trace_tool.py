"""The trace tool (``python -m lbm2d_tpu_torch.tools.trace``) measures only
on a card; what it computes around the measurement is checked here: the
device's busy time as a union of intervals, the idle gaps named by the
program's spans, the spans' self times, and the lockstep report on a
profiled CPU run."""

import os
import subprocess
import sys
import tempfile

import pytest
import torch

from lbm2d_tpu_torch.tools import trace
from test_batch_datagen import make_two_case_project
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_refuses_to_run_without_a_card():
    r = subprocess.run([sys.executable, "-m", "lbm2d_tpu_torch.tools.trace"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_busy_time_is_the_union_of_intervals():
    # a copy on a second stream overlapping a kernel counts once (the
    # benchmark's rule, lbmbench/trace.py)
    iv = [(0.0, 2.0), (1.0, 3.0), (1.5, 1.7), (5.0, 6.0), (6.0, 6.5)]
    assert trace.merge(iv) == [(0.0, 3.0), (5.0, 6.5)]
    assert trace.gaps(trace.merge(iv)) == [(3.0, 5.0)]
    assert trace.clip(trace.merge(iv), 1.0, 5.5) == [(1.0, 3.0), (5.0, 5.5)]
    assert trace.merge([]) == []


def test_gaps_named_by_the_innermost_span_then_the_host():
    spans = [(0.0, 10.0, "loop.chunk"), (1.0, 4.0, "loop.write"), (2.0, 3.0, "loop.write.h5"),
             (5.0, 8.0, "loop.monitor_wait"), (12.0, 14.0, "loop.chunk")]
    host = [(10.5, 11.5, "cudaLaunchKernel"), (0.0, 20.0, "run_batch")]
    idle = [(2.2, 2.8), (3.5, 3.7), (4.2, 4.6), (6.0, 7.0), (10.8, 11.0), (11.6, 11.9),
            (12.5, 12.9)]
    named = trace.name_gaps(idle, spans, host)
    assert named == pytest.approx({
        "loop.write.h5": 0.6, "loop.write": 0.2, "loop.chunk": 0.4 + 0.4,
        "loop.monitor_wait": 1.0, "host: cudaLaunchKernel": 0.2, "host: run_batch": 0.3})
    assert trace.name_gaps([(30.0, 31.0)], spans, host) == {"host: no operation": 1.0}


def test_innermost_takes_the_span_begun_last_among_those_open():
    ivs = [(0, 10, "a"), (2, 8, "b"), (3, 4, "c"), (6, 7, "d")]
    assert trace.innermost([9, 3.5, 5, 6.5, 1, 11], ivs) == ["a", "c", "b", "d", "a", None]


def test_self_times_subtract_the_children():
    spans = [(0.0, 10.0, "loop.chunk"), (1.0, 4.0, "loop.write"), (2.0, 3.0, "loop.write.h5"),
             (5.0, 8.0, "loop.monitor_wait"), (12.0, 14.0, "loop.chunk")]
    own = trace.self_times(spans)
    assert own == {"loop.chunk": 10.0 - 3.0 - 3.0 + 2.0, "loop.write": 2.0,
                   "loop.write.h5": 1.0, "loop.monitor_wait": 3.0}
    assert sum(own.values()) == 12.0  # the union of the spans


def test_lockstep_report_on_a_profiled_cpu_group():
    from torch._C._profiler import _ExperimentalConfig

    from lbm2d_tpu_torch.pipeline.batch_run import run_batch

    with tempfile.TemporaryDirectory() as root:
        make_two_case_project(root)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        with prof:
            run_batch("LockProj", root=root, progress=False, lockstep=True, device="cpu")
    dev, host, spans = trace.profile_events(prof)
    assert dev == []
    loop = max(spans, key=lambda t: len(spans[t]))
    names = {n for _, _, n in spans[loop]}
    assert {"loop.chunk", "program.issue", "loop.monitor_wait", "loop.queue"} <= names
    assert "loop.write" not in names  # the save worker's
    workers = {n for t in spans if t != loop for _, _, n in spans[t]}
    assert workers == {"fetch.d2h", "loop.write", "loop.write.h5", "h5.append"}
    # the device "busy" during each chunk's issue: its idle time is the rest
    busy = [(s, e, "k1") for s, e, n in spans[loop] if n == "program.issue"]
    text = trace.lockstep_report(busy, host, spans)
    assert "over 6 chunks" in text and "loop.chunk outside its named children" in text
    assert "workers h5.append" in text and "workers fetch.d2h" in text
    assert "workers loop.write" in text


def test_span_cost_reads_three_costs():
    line = trace.span_cost(2000)
    assert line.startswith("[span cost] a span site: ") and line.count(" ns ") == 3
