"""The per-layer metrics read from the program's own spans.

The program keeps its spans in a registry in memory
(``lbm2d_tpu_torch.utils.profiling.REGISTRY``), recording while a
``torch.profiler`` runs: in a ``--trace 1`` run that is the traced
sub-window of the cell's driver (``drivers/``), read here in the harness's
process after the run. A program without that registry gives nothing to
read.

Only whole chunks count: the cell's driver starts the profiler inside the
first traced chunk and stops it inside the last, so those two are cut. A chunk is
its outer span (``loop.chunk`` of the lockstep loop, ``serial.chunk`` of
the validation) recorded from start to end; the other spans are given to it
by the chunk id they carry.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple


def registry_spans() -> Optional[list]:
    """The spans the program's registry holds, or None where the program
    keeps none."""
    try:
        from lbm2d_tpu_torch.utils import profiling
    except ImportError:
        return None
    reg = getattr(profiling, "REGISTRY", None)
    return None if reg is None else reg.snapshot()


def whole_chunks(spans, outer: str) -> Dict[object, object]:
    """The whole ``outer`` spans by chunk id."""
    return {s.chunk: s for s in spans if s.name == outer and s.whole and s.chunk is not None}


def index(spans, ids) -> Dict[Tuple[str, object], List[object]]:
    """The spans of the chunks ``ids`` by (name, chunk id), each list in the
    order its spans started."""
    out = collections.defaultdict(list)
    for s in sorted((s for s in spans if s.chunk in ids), key=lambda s: s.t0):
        out[(s.name, s.chunk)].append(s)
    return out


def seconds(group) -> float:
    return sum(s.seconds for s in group)


def per_chunk(record, kind: str, outer: str, value: Callable, spans=None) -> Optional[float]:
    """The mean over the whole chunks of ``value(chunk span, index)``, or
    None where the record is another kind's or no chunk is whole."""
    if record.get("kind") != kind:
        return None
    spans = registry_spans() if spans is None else spans
    if not spans:
        return None
    whole = whole_chunks(spans, outer)
    if not whole:
        return None
    idx = index(spans, whole)
    return sum(value(c, idx) for c in whole.values()) / len(whole)


def loop_host_ms(record, spans=None):
    """The lockstep loop's own work a chunk on its thread: a whole
    ``loop.chunk`` less its ``loop.monitor_wait`` and ``loop.fetch_join``
    (waits on the device and on the fetch worker), in ms."""
    def value(c, idx):
        waits = idx[("loop.monitor_wait", c.chunk)] + idx[("loop.fetch_join", c.chunk)]
        return (c.seconds - seconds(waits)) * 1e3
    return per_chunk(record, "dataset", "loop.chunk", value, spans)


def loop_write_ms(record, spans=None):
    """``loop.write`` a chunk (the encoder feed and the HDF5 enqueue of the
    frames fetched before it), in ms; None where no chunk wrote."""
    spans = registry_spans() if spans is None else spans
    if not spans or not any(s.name == "loop.write" for s in spans):
        return None
    return per_chunk(record, "dataset", "loop.chunk",
                     lambda c, idx: seconds(idx[("loop.write", c.chunk)]) * 1e3, spans)


def loop_fetch_mbps(record, spans=None):
    """The bytes of the ``fetch.d2h`` spans the whole chunks started over
    their time, in MB/s. The copies share the compute stream, so a span also
    holds their wait on the kernels queued before them (the next chunk's,
    often): this is the fetch's latency in MB/s, not the link's rate."""
    if record.get("kind") != "dataset":
        return None
    spans = registry_spans() if spans is None else spans
    if not spans:
        return None
    ids = whole_chunks(spans, "loop.chunk")
    fetches = [s for s in spans if s.name == "fetch.d2h" and s.chunk in ids
               and s.attrs.get("bytes")]
    t = seconds(fetches)
    if not t:
        return None
    return sum(s.attrs["bytes"] for s in fetches) / t / 1e6


def program_issue_ms(record, spans=None):
    """``program.issue`` a chunk: the host's issue of the group's chunk, in
    ms."""
    return per_chunk(record, "dataset", "loop.chunk",
                     lambda c, idx: seconds(idx[("program.issue", c.chunk)]) * 1e3, spans)


def serial_issue_us(record, spans=None):
    """``serial.issue`` a chunk: the host's issue of the serial engine's
    chunk, in us."""
    return per_chunk(record, "dfg", "serial.chunk",
                     lambda c, idx: seconds(idx[("serial.issue", c.chunk)]) * 1e6, spans)


def serial_host_us(record, spans=None):
    """The host's time a validation chunk with the device drained: a whole
    ``serial.chunk`` less its ``serial.issue`` and its first
    ``serial.readback`` (which waits for the chunk's kernels), in us."""
    def value(c, idx):
        issue = idx[("serial.issue", c.chunk)]
        first = idx[("serial.readback", c.chunk)][:1]
        return (c.seconds - seconds(issue) - seconds(first)) * 1e6
    return per_chunk(record, "dfg", "serial.chunk", value, spans)
