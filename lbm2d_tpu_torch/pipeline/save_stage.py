"""The lockstep loop's save stage: device-to-host copies and writes beside
the chunks that follow them.

``run_lockstep_group`` (pipeline/batch_datagen.py) queues a chunk's save
producers (moments, resize, f16 cast, render) behind the chunk on the
compute stream and hands them to the stage with ``submit``. The stage

1. records an event on each producing device's current stream and, on a
   copy stream of its own for that device, waits on it and copies every
   tensor into pinned host memory from PyTorch's caching host allocator
   (``record_stream`` keeps the device blocks from reuse until the copy has
   read them). The copy depends only on its producers, so it runs on the
   copy engine while the next chunk computes;
2. puts the copies, their events and the failed cases as they stand at the
   hand-off on a queue of ``HELD`` places, read by the save worker, one
   persistent thread, which in hand-off order waits on the copies (span
   ``fetch.d2h``, carrying their ``bytes`` and, on the card, the copies'
   own time, between two events on the copy stream) and calls
   ``write(out, failed)`` under ``loop.write``, both with the chunk id that
   queued them.

``submit`` returns ``behind``, the hand-offs not yet written (0 where the
previous save was written under the chunk), and the seconds it waited for a
place in the queue: it waits, under ``loop.fetch_join``, only while ``HELD``
hand-offs wait for the worker, which bounds the copies in flight (device
and pinned memory) at a few saves a group. ``close`` drains the stage and
stops the worker.

``overlap=False`` runs each hand-off at once on the caller's thread (the
loop's ``--fetch_at_idle``). On the CPU the stage copies nothing: the host
arrays are the producers' own tensors, which are fresh.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..utils.profiling import span

HELD = 3  # hand-offs that wait for the worker before a hand-off waits


class SaveStage:
    """Copies and writes of a lockstep group's saves (module docstring).

    ``write(out, failed)`` runs on the save worker: ``out`` holds
    ``"moments"`` ([(array, pre_resized)], in save order) and ``"frames"``
    (RGB u8 arrays) or ``"frames_yuv"`` ([(Y, UV)]), host arrays in the
    dtypes the producers gave; ``failed`` the case indices failed at the
    hand-off."""

    def __init__(self, write: Callable[[Dict[str, Any], frozenset], None], overlap: bool = True,
                 yuv: bool = False):
        self._write = write
        self.overlap = overlap
        self.yuv = yuv
        self.bytes_fetched = 0
        self._streams: Dict[torch.device, Any] = {}
        self._jobs: queue.Queue = queue.Queue(maxsize=HELD)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    @property
    def held(self) -> int:
        """Hand-offs not yet written."""
        return self._jobs.unfinished_tasks

    def submit(self, moments: List[Tuple[torch.Tensor, bool]], videos: List[Any],
               failed: frozenset, chunk=None) -> Tuple[int, float]:
        """Start the copies of one hand-off and give it to the worker;
        returns (``behind``, seconds waited for a place in the queue)."""
        self._raise()
        tensors = [t for t, _ in moments]
        for v in videos:
            tensors += list(v) if self.yuv else [v]
        job = (*self._copy(tensors), [pre for _, pre in moments], len(videos), failed, chunk)
        if not self.overlap:
            self._run(job)
            return 0, 0.0
        if self._thread is None:
            self._thread = threading.Thread(target=self._work, name="save-worker", daemon=True)
            self._thread.start()
        behind = self.held
        if not self._jobs.full():  # only this thread puts: no wait
            self._jobs.put(job)
            return behind, 0.0
        t = time.perf_counter()
        with span("loop.fetch_join"):
            self._jobs.put(job)
        return behind, time.perf_counter() - t

    def close(self) -> None:
        """Drain the stage and stop the worker; raises the worker's error."""
        self._stop()
        self._raise()

    def __enter__(self):
        return self

    def __exit__(self, typ, val, tb):
        self._stop()
        if typ is None:
            self._raise()
        return False

    def _copy(self, tensors: List[torch.Tensor]):
        """(host tensors, [(start, done)] a device): pinned copies on each
        device's copy stream, behind an event on its current stream and
        between two timing events (``start`` once the producers are done
        and the host has issued the copies); on the CPU the tensors
        themselves and no event."""
        host = list(tensors)
        events = []
        by_device: Dict[torch.device, List[int]] = collections.defaultdict(list)
        for i, t in enumerate(tensors):
            if t.is_cuda:
                by_device[t.device].append(i)
        for dev, idx in by_device.items():
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = torch.cuda.Stream(device=dev)
            for i in idx:
                host[i] = torch.empty(tensors[i].shape, dtype=tensors[i].dtype, pin_memory=True)
            start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                stream.wait_event(ready)
                start.record(stream)
                for i in idx:
                    host[i].copy_(tensors[i], non_blocking=True)
                    tensors[i].record_stream(stream)
                done.record(stream)
            events.append((start, done))
        return host, events

    def _run(self, job) -> None:
        host, events, pres, n_videos, failed, chunk = job
        with span("fetch.d2h", chunk=chunk) as sp:
            for _, done in events:
                done.synchronize()
            arrays = [t.numpy() for t in host]
            nb = sum(a.nbytes for a in arrays)
            sp.set(bytes=nb)
            if events:
                # the copies' own time, not the worker's wait for them
                sp.took(max(a.elapsed_time(b) for a, b in events) * 1e-3)
        self.bytes_fetched += nb
        out: Dict[str, Any] = {}
        if pres:
            out["moments"] = list(zip(arrays[:len(pres)], pres))
        frames = arrays[len(pres):]
        if n_videos:
            out["frames_yuv" if self.yuv else "frames"] = (
                list(zip(frames[0::2], frames[1::2])) if self.yuv else frames)
        with span("loop.write", chunk=chunk):
            self._write(out, failed)

    def _work(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                if self._error is None:  # after an error, drain without writing
                    self._run(job)
            except Exception as exc:  # surfaced on the loop's next call
                self._error = exc
            finally:
                self._jobs.task_done()

    def _stop(self) -> None:
        if self._thread is not None:
            self._jobs.put(None)
            self._thread.join()
            self._thread = None

    def _raise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the save worker failed") from err
