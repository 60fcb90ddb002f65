"""Device timing shared by ``chip_smoke.py`` and the tools that time
kernels on the card: the card's name and power limit, and a kernel's
device time replayed from a CUDA graph."""

from __future__ import annotations

import statistics
import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, per_graph: int = 20, replays: int = 7) -> float:
    """Median device time of one call without the host launch path: the
    calls are captured once in a CUDA graph, and the graph is replayed
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    return statistics.median(times)
