"""The lockstep loop's save stage: device-to-host copies and writes beside
the chunks that follow them.

``run_lockstep_group`` (pipeline/batch_datagen.py) queues a chunk's save
producers (moments, resize, f16 cast, render) behind the chunk on the
compute stream. Each save event is a ``Save``: its device tensors and the
``write`` that puts their host arrays into its sinks. The loop hands the
stage its pending events with ``hold``, which

1. records an event on each producing device's current stream and, on a
   copy stream of its own for that device, waits on it and copies every
   tensor into pinned host memory from PyTorch's caching host allocator
   (``record_stream`` keeps the device blocks from reuse until the copy has
   read them). The copy depends only on its producers, so it runs on the
   copy engine while the next chunk computes;
2. keeps the copies, their events and the failed cases as they stand at
   the hand-off until ``release`` puts them on a queue of ``HELD`` places,
   read by the save worker, one persistent thread, which in hand-off order
   waits on the copies (span ``fetch.d2h``, carrying their ``bytes`` and,
   on the card, the copies' own time, between two events on the copy
   stream) and calls each event's ``write(rows, failed)`` in turn under
   ``loop.write``, both with the chunk id that queued them.

So the loop can start a save's copies behind its chunk and let the worker
write it only once the next chunk is issued. ``hold`` returns ``behind``,
the hand-offs not yet written (0 where the previous save was written under
the chunk); ``release`` the seconds it waited for a place in the queue: it
waits, under ``loop.fetch_join``, only while ``HELD`` hand-offs wait for
the worker, which bounds the copies in flight (device and pinned memory) at
a few saves a group. ``close`` releases the held hand-off, drains the stage
and stops the worker.

``overlap=False`` runs each hand-off at once on the caller's thread (the
loop's ``--fetch_at_idle``). On the CPU the stage copies nothing: the host
arrays are the producers' own tensors, which are fresh.

A case mesh's engine (``parallel/batch.BatchEngine(runner="sharded")``)
produces each save on every device, for that device's cases: a ``Save``
then holds one tensor a part, each copied on its own device's copy stream,
and ``write`` reads case ``b``'s row from its part's host array through
``CaseRows``.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import span

HELD = 3  # hand-offs that wait for the worker before a hand-off waits


class CaseRows:
    """A save's host arrays of a case mesh, one a part: ``rows[b]`` is case
    ``b``'s row, read from the part that holds it (``where[b]``, its part
    and its row there)."""

    def __init__(self, parts: List[Any], where: List[Tuple[int, int]]):
        self.parts, self.where = parts, where

    def __getitem__(self, b: int):
        p, r = self.where[b]
        return self.parts[p][r]

    def __len__(self) -> int:
        return len(self.where)


class Save(NamedTuple):
    """One save event. ``tensors``: one entry a part, in part order, each a
    tensor or a tuple of tensors (an I420 frame's Y and UV planes).
    ``write(rows, failed)`` runs on the save worker with their host arrays
    in case order (``rows[b]`` is case ``b``'s row; a tuple of such rows,
    one a plane, for tuple entries) and the case indices failed at the
    hand-off."""

    tensors: List[Any]
    write: Callable[[Any, frozenset], None]


def _flat(saves: List[Save]) -> list:
    return [t for ev in saves for part in ev.tensors
            for t in (part if isinstance(part, tuple) else (part,))]


def _refill(saves: List[Save], flat: list) -> List[Save]:
    """``saves`` with their tensors replaced, in ``_flat`` order, by ``flat``."""
    it = iter(flat)
    return [ev._replace(tensors=[tuple(next(it) for _ in part) if isinstance(part, tuple)
                                 else next(it) for part in ev.tensors]) for ev in saves]


class SaveStage:
    """Copies and writes of a lockstep group's saves (module docstring).
    ``parts`` (each part's case indices, in part order) says which cases
    each part of a ``Save`` holds."""

    def __init__(self, overlap: bool = True, parts: Optional[List[List[int]]] = None):
        self.overlap = overlap
        self._where: List[Tuple[int, int]] = [(0, 0)] * sum(len(idx) for idx in parts or [])
        for p, idx in enumerate(parts or []):
            for r, b in enumerate(idx):
                self._where[b] = (p, r)
        self.bytes_fetched = 0
        self._streams: Dict[torch.device, Any] = {}
        self._jobs: queue.Queue = queue.Queue(maxsize=HELD)
        self._thread: Optional[threading.Thread] = None
        self._held_job: Optional[tuple] = None
        self._error: Optional[Exception] = None

    @property
    def held(self) -> int:
        """Hand-offs not yet written."""
        return self._jobs.unfinished_tasks

    def hold(self, saves: List[Save], failed: frozenset, chunk=None) -> int:
        """Start the copies of one hand-off and keep it for ``release``
        (a hand-off still held is released first); returns ``behind``.
        Without overlap the hand-off runs at once."""
        self._raise()
        self.release()
        host, events = self._copy(_flat(saves))
        job = (_refill(saves, host), events, failed, chunk)
        if not self.overlap:
            self._run(job)
            return 0
        self._held_job = job
        return self.held

    def release(self) -> float:
        """Give the held hand-off, if any, to the worker; returns the
        seconds waited for a place in the queue."""
        job, self._held_job = self._held_job, None
        if job is None:
            return 0.0
        if self._thread is None:
            self._thread = threading.Thread(target=self._work, name="save-worker", daemon=True)
            self._thread.start()
        if not self._jobs.full():  # only this thread puts: no wait
            self._jobs.put(job)
            return 0.0
        t = time.perf_counter()
        with span("loop.fetch_join"):
            self._jobs.put(job)
        return time.perf_counter() - t

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

    def _rows(self, parts: list):
        """An event's host arrays, from its host tensors (one a part), in
        case order."""
        if isinstance(parts[0], tuple):
            return tuple(self._rows(list(plane)) for plane in zip(*parts))
        arrays = [t.numpy() for t in parts]
        return arrays[0] if len(arrays) == 1 else CaseRows(arrays, self._where)

    def _run(self, job) -> None:
        saves, events, failed, chunk = job
        with span("fetch.d2h", chunk=chunk) as sp:
            for _, done in events:
                done.synchronize()
            nb = sum(t.numel() * t.element_size() for t in _flat(saves))
            sp.set(bytes=nb)
            if events:
                # the copies' own time, not the worker's wait for them
                sp.took(max(a.elapsed_time(b) for a, b in events) * 1e-3)
        self.bytes_fetched += nb
        with span("loop.write", chunk=chunk):
            for ev in saves:
                ev.write(self._rows(ev.tensors), failed)

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
        self.release()
        if self._thread is not None:
            self._jobs.put(None)
            self._thread.join()
            self._thread = None

    def _raise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the save worker failed") from err
