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
the device's busy share (the union of the kernel and copy intervals that
``torch.profiler`` records over the same chunks, over their wall time), the
device time by kernel, and the host time by Python function (``cProfile``
over one chunk).

``lockstep``: the lockstep production command (``run_batch`` with the
README's flags) on the sibling project of three cases, three times in one
process: twice without a profiler, cold and warm (set-up and wind-down
against the group loop, ``run_summary.transfer.group_wall_s``; the warm
run's library calls and kernel launches a chunk, ``cuda_build.CALLS`` and
``cuda_step.LAUNCHES``); and under ``torch.profiler`` on every thread,
where the program's spans (``utils/profiling.span``) are user annotations:
the group loop's device idle time, each gap named by the innermost span
open on the loop's thread at its midpoint (the host operation where none
is), and each span's self time on the loop's, the save worker's and the
HDF5 writers' threads.

Every mode first prints what a span site costs on this host, with
recording off, on, and under a profiler.

With ``--out`` the tables also go to ``DIR/trace_<mode>.txt``. Without a
CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import cProfile
import heapq
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time
import timeit
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def host_table(prof_host, sort: str, rows: int) -> str:
    out = io.StringIO()
    pstats.Stats(prof_host, stream=out).sort_stats(sort).print_stats(rows)
    return out.getvalue()


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint, sorted intervals
    (the benchmark's rule, ``lbmbench/trace.py``: two that overlap, on two
    streams, count once)."""
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


def clip(merged, lo: float, hi: float) -> List[Tuple[float, float]]:
    """Disjoint sorted intervals cut to [lo, hi]."""
    return [(max(s, lo), min(e, hi)) for s, e in merged if e > lo and s < hi]


def innermost(points: Sequence[float], intervals: Sequence[Tuple[float, float, str]]):
    """For each point (in any order), the name of the interval begun last
    among those open at it (the innermost, where they nest), or None."""
    order = sorted(range(len(points)), key=points.__getitem__)
    ivs = sorted(intervals)
    live: list = []  # heap of (-start, end, name) of intervals begun
    out: List[Optional[str]] = [None] * len(points)
    i = 0
    for k in order:
        p = points[k]
        while i < len(ivs) and ivs[i][0] <= p:
            heapq.heappush(live, (-ivs[i][0], ivs[i][1], ivs[i][2]))
            i += 1
        # an interval begun later than one still open ends before it where
        # they nest, so the heap's top is open or can be dropped
        while live and live[0][1] < p:
            heapq.heappop(live)
        out[k] = live[0][2] if live else None
    return out


def name_gaps(idle, spans, host) -> Dict[str, float]:
    """Idle time summed by the innermost program span open on the loop's
    thread at each gap's midpoint; where none is, by the host operation
    begun last among those running then ("host: <op>"), else "host: no
    operation"."""
    mids = [0.5 * (s + e) for s, e in idle]
    by_span = innermost(mids, spans)
    by_op = innermost(mids, host)
    out: Dict[str, float] = collections.Counter()
    for (s, e), sp, op in zip(idle, by_span, by_op):
        out[sp if sp is not None else f"host: {op or 'no operation'}"] += e - s
    return dict(out)


def self_times(spans: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Each name's self time over one thread's spans: their time less the
    part their child spans (the spans nested in them) cover."""
    out: Dict[str, float] = collections.Counter()
    stack: list = []  # [end, name, children's time]
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, n, kids, start = stack.pop()
            out[n] += end - start - kids
        if stack:
            stack[-1][2] += e - s
        stack.append([e, name, 0.0, s])
    while stack:
        end, n, kids, start = stack.pop()
        out[n] += end - start - kids
    return dict(out)


def profile_events(prof):
    """(device intervals, host operations by thread, program spans by
    thread) of a torch.profiler run, in seconds on the profiler's clock:
    device kernels, copies and memsets; host operations that are not user
    annotations; and the user annotations, which in the program are its
    spans (``utils/profiling.span``)."""
    dev = []
    host: Dict[int, list] = collections.defaultdict(list)
    spans: Dict[int, list] = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((s, t, e.name()))
        elif e.is_user_annotation():
            spans[e.start_thread_id()].append((s, t, e.name()))
        elif t > s:
            host[e.start_thread_id()].append((s, t, e.name()))
    return dev, host, spans


def lockstep_report(dev, host, spans) -> str:
    """The group loop's device idle time named by the program's spans, and
    each span's self time by thread, from ``profile_events``."""
    loop_thread = max(spans, key=lambda t: sum(n == "loop.chunk" for _, _, n in spans[t]))
    chunks = [(s, e) for s, e, n in spans[loop_thread] if n == "loop.chunk"]
    lo, hi = min(s for s, _ in chunks), max(e for _, e in chunks)
    busy = clip(merge([(s, e) for s, e, _ in dev]), lo, hi)
    idle = gaps([(lo, lo)] + busy + [(hi, hi)])
    wall = hi - lo
    idle_s = sum(e - s for s, e in idle)
    named = name_gaps(idle, spans[loop_thread], host[loop_thread])
    outside = sum(t for n, t in named.items() if n.startswith("host: "))
    lines = [
        f"[lockstep spans] group loop {wall:.3f} s over {len(chunks)} chunks: device busy "
        f"{wall - idle_s:.3f} s (union of intervals), idle {idle_s:.3f} s = "
        f"{100 * idle_s / wall:.1f}%; idle outside every program span {outside:.3f} s = "
        f"{100 * outside / max(idle_s, 1e-12):.1f}% of the idle time",
        "device idle in the group loop by the loop thread's innermost span:",
    ]
    lines += [f"  {t:8.3f} s  {100 * t / max(idle_s, 1e-12):5.1f}%  {n}"
              for n, t in sorted(named.items(), key=lambda kv: -kv[1])]
    lines.append("self time by span, on the loop's thread and on the worker threads:")
    for tag, tids in (("loop", [loop_thread]), ("workers", [t for t in spans if t != loop_thread])):
        own: Dict[str, float] = collections.Counter()
        n_spans: Dict[str, int] = collections.Counter()
        for tid in tids:
            own.update(self_times(spans[tid]))
            n_spans.update(n for _, _, n in spans[tid])
        lines += [f"  {tag:>7} {n:<18} {t:8.4f} s  x{n_spans[n]}"
                  for n, t in sorted(own.items(), key=lambda kv: -kv[1])]
    own = self_times(spans[loop_thread]).get("loop.chunk", 0.0)
    total = sum(e - s for s, e in chunks)
    lines.append(f"loop.chunk outside its named children: {own:.4f} s = "
                 f"{100 * own / total:.1f}% of loop.chunk")
    return "\n".join(lines)


def span_cost(n: int = 200_000) -> str:
    """ns a span site costs with recording off, on (``recording()``, no
    profiler) and under a CPU profiler."""
    from ..utils import profiling

    reg = profiling.Registry(capacity=1024)

    def site():
        with reg.span("site"):
            pass

    def ns(k):
        return min(timeit.repeat(site, number=k, repeat=5)) / k * 1e9

    off = ns(n)
    with reg.recording():
        on = ns(n // 20)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        prof = ns(n // 200)
    return (f"[span cost] a span site: {off:.0f} ns off, {on:.0f} ns recording, "
            f"{prof:.0f} ns under torch.profiler (record_function included)")


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
        dev_us = 1e6 * sum(e - s for s, e in merge([(s, e) for s, e, _ in profile_events(prof)[0]]))
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
    from ..pipeline.batch_run import run_batch
    from . import smoke_case

    smoke_case.use_memory_h5()
    H, W = mask.shape
    steps = int(config["simulation"]["max_steps"])
    cells = len(smoke_case.SIBLING_NUS) * steps * H * W

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
    # every thread's spans: the save worker's and the HDF5 writers' too
    from torch._C._profiler import _ExperimentalConfig

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    wall, loop = run("torch_profiler", prof)
    lines.append(f"[lockstep torch.profiler] wall {wall:.3f} s, group loop {loop:.2f} s [{card}]")
    lines.append(lockstep_report(*profile_events(prof)))
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
    tables = {"spans": span_cost()}
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
