"""Where the time goes in the port on one GPU: the chunk runner alone, and
the lockstep production path's group loop.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 -m lbm2d_tpu_torch.tools.trace [--mode chunk|lockstep|all]
        [--out DIR] [--chunks 3]

Both modes use the production-shaped smoke case (``tools/smoke_case.py``,
2432x1152).

``chunk``: after one warm-up chunk, ``--chunks`` chunks of
``run_chunk_cuda`` (100 steps each) in f32 and in 16-bit deviation storage.
For each it prints the wall time per step (CUDA events around the chunks),
the device's busy share (the kernel and copy time that ``torch.profiler``
records over the same chunks, over their wall time), the device time by
kernel, and the host time by Python function (``cProfile`` over one chunk).

``lockstep``: the lockstep production command (``run_batch`` with the
README's flags) on the sibling project of three cases, four times in one
process: twice without profilers, cold and warm (set-up and wind-down
against the group loop, ``run_summary.transfer.group_wall_s``; the warm
run's library calls and kernel launches a chunk, ``cuda_build.CALLS`` and
``cuda_step.LAUNCHES``); under a sampler of the main thread's stack
(``MainThreadSampler``: its wall time by line of ``run_lockstep_group``
and by innermost function, and the loop's lines by kind, ``LOOP_KINDS``:
issuing the chunk, waiting on its monitors, host writes, fetches; cProfile
would mix in the fetch, writer and encoder threads, which Python 3.12's
profiler also sees); and under ``torch.profiler`` (the device's busy share
of the group loop and the device time by kernel), the idle share beside
the main thread's time by kind.

With ``--out`` the tables also go to ``DIR/trace_<mode>.txt``. Without a
CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import cProfile
import inspect
import io
import json
import linecache
import os
import pstats
import subprocess
import sys
import tempfile
import threading
import time

import torch


def device_us(prof) -> float:
    """Kernel and copy time in a torch.profiler run, in us. An operator's
    own device time repeats that of the kernels it launched, so only the
    device-side events count."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation)


def host_table(prof_host, sort: str, rows: int) -> str:
    out = io.StringIO()
    pstats.Stats(prof_host, stream=out).sort_stats(sort).print_stats(rows)
    return out.getvalue()


class MainThreadSampler:
    """Samples the main thread's Python stack from a daemon thread every
    ``interval`` seconds (or as soon as the GIL lets it) and charges the
    time since the previous sample to what the stack shows: the line of
    ``anchor`` being run (the outermost frame of that function), and the
    innermost function."""

    def __init__(self, anchor, interval: float = 1e-3):
        self.anchor = anchor.__code__
        self.interval = interval
        self.by_line = collections.Counter()
        self.by_leaf = collections.Counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def _run(self):
        main = threading.main_thread().ident
        last = time.perf_counter()
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(main)
            now = time.perf_counter()
            dt, last = now - last, now
            if frame is None:
                continue
            code = frame.f_code
            self.by_leaf[f"{os.path.basename(code.co_filename)}:{code.co_name}"] += dt
            line = None
            while frame is not None:
                if frame.f_code is self.anchor:
                    line = frame.f_lineno  # keep the outermost
                frame = frame.f_back
            self.by_line[line] += dt

    def by_kind(self, loop_start: int, loop_end: int) -> collections.Counter:
        """The time charged to the anchor's lines loop_start .. loop_end, by
        ``loop_kind``."""
        kinds = collections.Counter()
        for line, t in self.by_line.items():
            if line is not None and loop_start <= line <= loop_end:
                kinds[loop_kind(linecache.getline(self.anchor.co_filename, line))] += t
        return kinds

    def report(self, loop_start: int, loop_end: int, rows: int = 25) -> str:
        """Time by phase (set-up before ``loop_start``, the loop, wind-down
        after ``loop_end``, outside the anchor), the top lines of the
        anchor with their source, and the top innermost functions."""
        phase = collections.Counter()
        for line, t in self.by_line.items():
            phase["outside the group" if line is None else "set-up" if line < loop_start
                  else "group loop" if line <= loop_end else "wind-down"] += t
        path = self.anchor.co_filename
        out = ["main thread by phase: " + ", ".join(f"{k} {v:.3f} s" for k, v in phase.items())]
        out.append(f"main thread by line of {self.anchor.co_name}:")
        for line, t in self.by_line.most_common(rows):
            src = "(outside)" if line is None else linecache.getline(path, line).strip()
            out.append(f"  {t:8.3f} s  {line}: {src}")
        out.append("main thread in the group loop by kind: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in self.by_kind(loop_start, loop_end).most_common()))
        out.append("main thread by innermost function:")
        out += [f"  {t:8.3f} s  {name}" for name, t in self.by_leaf.most_common(rows)]
        return "\n".join(out)


# the group loop's lines by what they do, matched on their source text in
# order: issuing the chunk, waiting on its monitors, host writes of fetched
# data, queueing and fetching saves and video frames
LOOP_KINDS = (("issue", ("run_step(",)),
              ("monitors", ("sync_monitors(",)),
              ("writes", ("write_fetched(",)),
              ("fetches", ("fetch", "get_moments_device(", "get_velocity_device(", "renderer(",
                           "resizer(", "pending_moments.append", "pending_videos.append")))


def loop_kind(src: str) -> str:
    """The ``LOOP_KINDS`` kind of a source line of the group loop, or
    "other"."""
    for kind, marks in LOOP_KINDS:
        if any(m in src for m in marks):
            return kind
    return "other"


def loop_lines(fn, marker: str = "while steps < max_steps:"):
    """First and last source line of the ``while`` loop that ``marker``
    opens in ``fn`` (by indentation)."""
    src, first = inspect.getsourcelines(fn)
    i = next(k for k, l in enumerate(src) if l.strip() == marker)
    indent = len(src[i]) - len(src[i].lstrip())
    j = i + 1
    while j < len(src) and (not src[j].strip() or len(src[j]) - len(src[j].lstrip()) > indent):
        j += 1
    return first + i, first + j - 1


def trace_chunk(p, chunk: int, n_chunks: int, card: str) -> dict:
    from ..core import solver
    from ..ops import cuda_step as cs

    H, W = p.shape
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for mode, store_dev in (("f32", False), ("store_dev", True)):
        def run(st, n):
            for _ in range(n):
                st, _ = cs.run_chunk_cuda(st, p, chunk, store_dev=store_dev)
            return st

        st = run(solver.init_state(H, W, torch.float32, p.mask.device), 1)  # warm-up
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=acts) as prof:
            a.record()
            st = run(st, n_chunks)
            b.record()
            b.synchronize()
        wall_us = a.elapsed_time(b) * 1e3
        dev_us = device_us(prof)
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=15)
        prof_host = cProfile.Profile()
        prof_host.enable()
        st = run(st, 1)
        torch.cuda.synchronize()
        prof_host.disable()
        steps = n_chunks * chunk
        head = (f"[chunk {mode}] {wall_us / steps:.1f} us/step wall over {steps} steps, device "
                f"busy {dev_us / steps:.1f} us/step = {100 * dev_us / wall_us:.1f}% [{card}]")
        out[f"chunk_{mode}"] = "\n".join([head, table, host_table(prof_host, "tottime", 15)])
    return out


def trace_lockstep(config, mask, card: str) -> dict:
    from ..pipeline.batch_datagen import run_lockstep_group
    from ..pipeline.batch_run import run_batch
    from . import smoke_case

    smoke_case.use_memory_h5()
    H, W = mask.shape
    steps = int(config["simulation"]["max_steps"])
    cells = len(smoke_case.SIBLING_NUS) * steps * H * W
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def run(tag, profiler=None):
        """(wall s, group loop s) of one run of the production command."""
        with tempfile.TemporaryDirectory(prefix=f"trace_{tag}_") as root:
            names = smoke_case.write_sibling_project(root, config, mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profiler or contextlib.nullcontext():
                stats = run_batch("Smoke4", root=root, progress=False, device="cuda",
                                  **smoke_case.PRODUCTION_FLAGS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(os.path.join(root, "outputs", "Smoke4", "plots", "sim_results.json")) as fh:
                entry = {e["config_filename"]: e for e in json.load(fh)}[names[0][0]]
        if stats.get("success") != len(names):
            raise RuntimeError(f"lockstep run {tag} did not succeed: {stats}")
        return wall, float(entry["run_summary"]["transfer"]["group_wall_s"])

    from ..ops import cuda_build
    from ..ops import cuda_step as cs

    chunks = steps // int(config["simulation"]["compute_step_size"])
    lines = []
    for tag in ("cold", "warm"):
        cuda_build.CALLS.clear()
        cs.reset_launch_counts()
        wall, loop = run(tag)
        lines.append(
            f"[lockstep {tag}] wall {wall:.3f} s = {cells / wall / 1e6:.1f} MLUPS aggregate; "
            f"group loop {loop:.2f} s = {cells / loop / 1e6:.1f} MLUPS = "
            f"{loop / (cells / (H * W)) * 1e6:.1f} us per case-step; set-up and wind-down "
            f"{wall - loop:.3f} s [{card}]")
    calls = {k: v / chunks for k, v in cuda_build.CALLS.items()}
    launches = {k: v / chunks for k, v in cs.LAUNCHES.items() if v}
    lines.append(f"[lockstep warm] a chunk of the group: {sum(calls.values()):g} library calls "
                 f"{calls}, {sum(launches.values()):g} kernel launches {launches}")
    sampler = MainThreadSampler(run_lockstep_group)
    wall, loop_s = run("sampled", sampler)
    lines.append(f"[lockstep sampled] wall {wall:.3f} s, group loop {loop_s:.2f} s [{card}]")
    bounds = loop_lines(run_lockstep_group)
    lines.append(sampler.report(*bounds))
    prof = torch.profiler.profile(activities=acts)
    wall, loop = run("torch_profiler", prof)
    dev_us = device_us(prof)
    idle = 1.0 - dev_us / 1e6 / loop
    lines.append(
        f"[lockstep torch.profiler] wall {wall:.3f} s, group loop {loop:.2f} s; device busy "
        f"{dev_us / 1e6:.3f} s = {100 * dev_us / 1e6 / loop:.1f}% of the group loop, "
        f"{dev_us / (cells / (H * W)):.1f} us per case-step [{card}]")
    lines.append(
        f"[lockstep] device idle {100 * idle:.1f}% of the group loop; the main thread's share "
        f"of its loop (sampled run, {loop_s:.2f} s) by kind: " + ", ".join(
            f"{k} {100 * v / loop_s:.1f}%" for k, v in sorted(sampler.by_kind(*bounds).items())))
    text = "\n".join(lines + [
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=20),
    ])
    return {"lockstep": text}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("chunk", "lockstep", "all"), default="all")
    ap.add_argument("--out", default=None, help="also write the tables here")
    ap.add_argument("--chunks", type=int, default=3, help="traced chunks per storage (chunk)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace: no CUDA device", file=sys.stderr)
        return 1
    from ..core import solver
    from ..ops import cuda_build
    from . import smoke_case

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    cuda_build.build_all()
    config, mask = smoke_case.load_smoke_case()
    tables = {}
    if args.mode in ("chunk", "all"):
        p = solver.make_params(config, mask, dtype=torch.float32, device=torch.device("cuda", 0))
        chunk = int(config["simulation"]["compute_step_size"])
        tables.update(trace_chunk(p, chunk, args.chunks, card))
    if args.mode in ("lockstep", "all"):
        tables.update(trace_lockstep(config, mask, card))
    for name, text in tables.items():
        print(text, flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"trace_{name}.txt"), "w") as fh:
                fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
