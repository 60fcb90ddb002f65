"""Adaptive device-to-host fetch pacing for transfer-bound links.

Counterpart of ``lbm2d_tpu/pipeline/fetch_pacer.py``. The lockstep datagen
loop (pipeline/batch_datagen.run_lockstep_group) overlaps each save/video
fetch with the next chunk's compute on a worker thread. On a healthy link
the transfer finishes under the compute and the join wait ("stall") is ~0.
When the link cannot keep up, the solver silently binds on transfer.

This pacer makes that degradation graceful: it watches the measured stall
fraction stall/(stall+compute) over a rolling window and grows the *fetch
group size* -- how many save events accumulate on the device before one
coalesced fetch -- when the link can't keep up, shrinking it back when the
link recovers. Artifacts are byte-identical: frames are only coalesced in
transit, never dropped, reordered or re-encoded.

Deliberately not automatic: switching --f16_transfer/--yuv_video on at
runtime would change artifact bytes; the pacer only recommends them via
``lean_recommended`` when even max batching can't keep utilization up.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Optional, Tuple

import torch


def probe_d2h_mbps(
    nbytes: int = 8 * 1024 * 1024, repeats: int = 2, device="cuda"
) -> float:
    """Measured device-to-host bandwidth in MB/s (best of ``repeats``).

    Stamped as ``link_d2h_mbps_pre/post`` into run stats so throughput
    numbers are link-normalized. On a CUDA device each repeat copies a
    freshly computed tensor into a pinned host buffer, timed between CUDA
    events. On the CPU there is no link: it times a host copy of a freshly
    computed tensor, which is what the JAX package's probe measures there.
    """
    dev = torch.device(device)
    n = nbytes // 4
    best = 0.0
    if dev.type == "cuda":
        host = torch.empty(n, dtype=torch.float32, pin_memory=True)
        for i in range(max(1, repeats)):
            # a fresh computed tensor per repeat, so no cached copy serves it
            x = torch.sqrt(torch.arange(n, dtype=torch.float32, device=dev) + float(i + 1))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            host.copy_(x, non_blocking=True)
            end.record()
            end.synchronize()
            best = max(best, nbytes / (start.elapsed_time(end) / 1e3) / 1e6)
        return round(best, 2)
    for i in range(max(1, repeats)):
        x = torch.sqrt(torch.arange(n, dtype=torch.float32, device=dev) + float(i + 1))
        t0 = time.perf_counter()
        x.numpy().copy()
        dt = max(time.perf_counter() - t0, 1e-9)
        best = max(best, nbytes / dt / 1e6)
    return round(best, 2)


class FetchPacer:
    """Rolling-window stall controller for the deferred-fetch scheduler.

    Parameters
    ----------
    stall_hi : grow the group when the windowed stall fraction exceeds this
        (default 0.20: >20% of wall lost to un-hidden transfer).
    stall_lo : shrink the group back when it falls below this (hysteresis
        band keeps the controller from oscillating on a borderline link).
    max_group : hard cap on accumulated save events (device-memory bound).
    window : chunks per decision window; one adaptation step per window.
    """

    def __init__(
        self,
        stall_hi: float = 0.20,
        stall_lo: float = 0.05,
        max_group: int = 8,
        window: int = 8,
    ):
        if not 0.0 <= stall_lo < stall_hi <= 1.0:
            raise ValueError(f"need 0 <= stall_lo < stall_hi <= 1, got "
                             f"{stall_lo}, {stall_hi}")
        self.stall_hi = stall_hi
        self.stall_lo = stall_lo
        self.max_group = max(1, int(max_group))
        self.window = max(1, int(window))
        self.group_size = 1
        self._samples: Deque[Tuple[float, float]] = deque(maxlen=self.window)
        self._since_adapt = 0
        # cumulative accounting (stamped into run stats)
        self.total_compute_s = 0.0
        self.total_stall_s = 0.0
        self.adaptations = 0
        # the chunk wall without a transfer stall (record_wall) and the
        # number of chunks that calibrated it
        self.chunk_wall_est: Optional[float] = None
        self.calibrating_chunks = 0

    # ------------------------------------------------------------- telemetry

    def record_chunk(self, compute_s: float, stall_s: float) -> None:
        """Feed one chunk's wall breakdown; may adapt once per window."""
        compute_s = max(0.0, float(compute_s))
        stall_s = max(0.0, float(stall_s))
        self._samples.append((compute_s, stall_s))
        self.total_compute_s += compute_s
        self.total_stall_s += stall_s
        self._since_adapt += 1
        if self._since_adapt >= self.window:
            self._adapt()
            self._since_adapt = 0

    # monitor waits below this are the bare sync floor
    M_EPS = 0.05

    def record_wall(self, chunk_wall: float, monitor_wait: float, join_wait: float,
                    fetching: bool = True) -> float:
        """Feed one chunk's walls (the lockstep loop's): the chunk without
        its host writes, its monitor wait and its wait to join the fetch
        thread; ``fetching`` says whether a fetch was in flight. Returns the
        true stall charged to ``record_chunk``.

        The join wait is the full transfer duration, not the un-hidden
        residual, so a chunk only truly lost wall time when its total wall
        exceeds the chunk wall without a transfer. Chunks whose monitor wait
        is non-trivial are device-bound (transfers hidden -> stall 0), and
        chunks with no fetch in flight lose nothing to one: both calibrate
        ``chunk_wall_est``. The others charge the excess over it, or the raw
        join wait while there is no estimate. (The JAX package calibrates
        from the device-bound chunks alone; a host-paced loop, as on the
        H100, never waits M_EPS for its monitors, so the estimate never
        formed there and every join wait counted as stall.)"""
        if monitor_wait > self.M_EPS or not fetching:
            true_stall = 0.0  # device-bound or no transfer: nothing to hide
            self.calibrating_chunks += 1
            self.chunk_wall_est = (
                chunk_wall if self.chunk_wall_est is None
                else 0.7 * self.chunk_wall_est + 0.3 * chunk_wall
            )
        elif self.chunk_wall_est is not None:
            true_stall = max(0.0, chunk_wall - self.chunk_wall_est)
        else:
            true_stall = join_wait  # no estimate yet: conservative
        self.record_chunk(chunk_wall - true_stall, true_stall)
        return true_stall

    def stall_fraction(self) -> float:
        """Windowed stall fraction (0 = transfers fully hidden)."""
        c = sum(s[0] for s in self._samples)
        st = sum(s[1] for s in self._samples)
        tot = c + st
        return st / tot if tot > 0 else 0.0

    def utilization(self) -> float:
        """Windowed compute utilization = 1 - stall fraction."""
        return 1.0 - self.stall_fraction()

    # ------------------------------------------------------------- decisions

    def _adapt(self) -> None:
        frac = self.stall_fraction()
        if frac > self.stall_hi and self.group_size < self.max_group:
            self.group_size = min(self.max_group, self.group_size * 2)
            self.adaptations += 1
        elif frac < self.stall_lo and self.group_size > 1:
            self.group_size = max(1, self.group_size // 2)
            self.adaptations += 1

    def should_fetch(self, n_pending: int) -> bool:
        """Kick the coalesced transfer once a full group is accumulated."""
        return n_pending >= self.group_size

    @property
    def lean_recommended(self) -> bool:
        """True when the link is stalling even at max batching -- the
        operator should consider --f16_transfer/--yuv_video."""
        return (
            self.group_size >= self.max_group
            and len(self._samples) == self.window
            and self.stall_fraction() > self.stall_hi
        )

    def stats(self) -> dict:
        """Cumulative accounting for run records (structured, not prose)."""
        tot = self.total_compute_s + self.total_stall_s
        return {
            "fetch_group_size_final": self.group_size,
            "fetch_adaptations": self.adaptations,
            "fetch_stall_s": round(self.total_stall_s, 3),
            "fetch_stall_fraction": round(
                self.total_stall_s / tot if tot > 0 else 0.0, 4
            ),
            "lean_recommended": self.lean_recommended,
        }
