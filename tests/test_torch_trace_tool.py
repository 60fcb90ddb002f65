"""The trace tool (``python -m lbm2d_tpu_torch.tools.trace``) measures only
on a card; what it computes around the measurement is checked here: the
main-thread sampler's attribution and the group loop's line range."""

import os
import subprocess
import sys
import threading
import time

from lbm2d_tpu_torch.pipeline.batch_datagen import run_lockstep_group
from lbm2d_tpu_torch.tools.trace import MainThreadSampler, loop_kind, loop_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_loop_lines_bracket_the_group_loop():
    import linecache

    first, last = loop_lines(run_lockstep_group)
    path = run_lockstep_group.__code__.co_filename
    assert linecache.getline(path, first).strip() == "while steps < max_steps:"
    assert "engine.run_step(chunk" in "".join(
        linecache.getline(path, n) for n in range(first, last + 1))
    after = linecache.getline(path, last + 1)
    assert after.strip() and len(after) - len(after.lstrip()) <= 4


def _anchor(stop):
    time.sleep(0.3)  # the line the sampler must charge
    stop.set()


def test_sampler_charges_the_main_thread_only():
    stop = threading.Event()

    def busy():  # another thread's work is not the main thread's
        while not stop.is_set():
            sum(range(1000))

    other = threading.Thread(target=busy)
    other.start()
    sampler = MainThreadSampler(_anchor)
    with sampler:
        _anchor(stop)
    other.join()
    sleep_line = _anchor.__code__.co_firstlineno + 1
    assert sampler.by_line[sleep_line] >= 0.2
    assert sum(sampler.by_line.values()) <= 0.5
    assert not any("busy" in name for name in sampler.by_leaf)
    report = sampler.report(sleep_line, sleep_line)
    assert "group loop" in report and "time.sleep(0.3)" in report


def test_trace_refuses_to_run_without_a_card():
    r = subprocess.run([sys.executable, "-m", "lbm2d_tpu_torch.tools.trace"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_loop_kinds_cover_the_group_loop():
    # the idle split's kinds: every line of the loop that issues the chunk,
    # waits on its monitors, writes or fetches is named so
    import linecache

    first, last = loop_lines(run_lockstep_group)
    path = run_lockstep_group.__code__.co_filename
    kinds = {}
    for n in range(first, last + 1):
        src = linecache.getline(path, n)
        kinds.setdefault(loop_kind(src), []).append(src.strip())
    assert any("engine.run_step(chunk" in s for s in kinds["issue"])
    assert any("engine.sync_monitors(" in s for s in kinds["monitors"])
    assert any("write_fetched(" in s for s in kinds["writes"])
    assert any("start_fetch()" in s for s in kinds["fetches"])
    assert loop_kind("steps += chunk") == "other"
