"""The device trace of a traced run over several cards: ``torch.profiler``
over a sub-window, its device intervals split by the card that ran them
(each kineto event's ``device_index()``).

Each card's busy time is the union of its own intervals (kernels, copies,
memsets), and its idle gaps are named by what the host was doing
meanwhile. The run's ``busy_s`` is the mean card's, so ``1 - busy_s /
window_s`` is the mean card's idle share and never passes the window;
``cards`` keeps each card's own busy time.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Sequence, Tuple

from lbmbench.trace import gaps, merge, name_gaps

Interval = Tuple[float, float, str]


def card_events(prof) -> Tuple[Dict[int, List[Interval]], List[Interval]]:
    """({card index: device intervals with names}, host intervals with
    names), in seconds on the profiler's clock."""
    import torch

    dev: Dict[int, List[Interval]] = collections.defaultdict(list)
    host: List[Interval] = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        d = e.duration_ns() * 1e-9
        if e.is_user_annotation():
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev[int(e.device_index())].append((s, s + d, e.name()))
        elif d > 0:
            host.append((s, s + d, e.name()))
    return dict(dev), host


def reduce_cards(dev: Dict[int, Sequence[Interval]], host: Sequence[Interval], window_s: float,
                 cards: Sequence[int]) -> dict:
    """busy_s (the mean over ``cards`` of each card's union), window_s,
    ``cards`` ([{"device", "busy_s"}]), and the breakdown: ``device_ops``
    (the ten largest operations summed over the cards, and every copy kind,
    "Memcpy ...", whatever its size) and ``idle_gaps`` (the mean card's idle
    time by the host operation running meanwhile)."""
    per_card, by_op = [], collections.Counter()
    idle = collections.Counter()
    for c in cards:
        iv = dev.get(c, [])
        merged = merge([(s, e) for s, e, _ in iv])
        per_card.append({"device": int(c), "busy_s": float(sum(e - s for s, e in merged))})
        for s, e, name in iv:
            by_op[name] += e - s
        for name, t in name_gaps(gaps(merged), host).items():
            idle[name] += t / len(cards)
    ops = by_op.most_common(10)
    ops += [(n, t) for n, t in by_op.items() if n.startswith("Memcpy") and (n, t) not in ops]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(c["busy_s"] for c in per_card) / len(per_card),
        "window_s": float(window_s),
        "cards": per_card,
        "device_ops": [[n[:120], float(t)] for n, t in ops],
        "idle_gaps": [[n[:120], float(t)] for n, t in top_idle],
    }


class CardsTrace:
    """Start and stop ``torch.profiler`` around a sub-window of a run on
    ``devices`` (card indices); the window is bounded by a sync of every
    card, so no work issued outside it runs in it."""

    def __init__(self, devices: Sequence[int]):
        self.devices = list(devices)
        self.prof = None
        self.window_s = None
        self._t0 = None

    def _sync(self) -> None:
        import torch

        for d in self.devices:
            torch.cuda.synchronize(d)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    @property
    def done(self) -> bool:
        return self.window_s is not None

    def reduce(self) -> dict:
        dev, host = card_events(self.prof)
        self.prof = None
        return reduce_cards(dev, host, self.window_s, self.devices)
