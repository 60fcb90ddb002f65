"""The six readers of the program's spans (``lbmbench/spans.py``): a
synthetic registry gives each its value, an empty one or another cell's
kind gives None, and the cut first and last chunks do not count."""

import pytest

from lbmbench import spans as sp

MS = 1_000_000  # ns


class S:
    """A span as the program's registry holds one."""

    def __init__(self, name, t0_ms, t1_ms, chunk, whole=True, **attrs):
        self.name, self.t0, self.t1 = name, int(t0_ms * MS), int(t1_ms * MS)
        self.chunk, self.whole, self.attrs = chunk, whole, attrs

    @property
    def seconds(self):
        return (self.t1 - self.t0) * 1e-9


def lockstep():
    """Three chunks of a group: the first cut (its children alone
    recorded), then two whole ones, the last cut (not whole)."""
    g = "g1"
    out = [S("program.issue", 0, 2, None)]  # the cut first chunk's: no chunk id
    for k, t in ((2, 100), (3, 200)):
        c = (g, k)
        out += [S("loop.chunk", t, t + 80, c),
                S("program.issue", t, t + 3, c),
                S("loop.fetch_join", t + 3, t + 8, c),
                S("loop.monitor_wait", t + 40, t + 70, c),
                S("loop.queue", t + 70, t + 72, c),
                S("loop.fetch_start", t + 72, t + 74, c),
                S("fetch.d2h", t + 74, t + 78, c, bytes=8_000_000)]
    out += [S("loop.write", 208, 228, (g, 3)), S("loop.write.h5", 210, 228, (g, 3))]
    c = (g, 4)
    out += [S("loop.chunk", 300, 400, c, whole=False), S("program.issue", 300, 350, c),
            S("loop.write", 360, 390, c), S("fetch.d2h", 380, 381, c, bytes=1_000_000)]
    return out


def validation():
    out = [S("serial.issue", 0, 1, None)]
    for k, t in ((2, 10), (3, 20)):
        out += [S("serial.chunk", t, t + 6, k), S("serial.issue", t, t + 2, k),
                S("serial.readback", t + 2, t + 5, k), S("serial.readback", t + 5, t + 5.5, k)]
    out += [S("serial.chunk", 30, 40, 4, whole=False), S("serial.issue", 30, 35, 4)]
    return out


DATASET, DFG = {"kind": "dataset"}, {"kind": "dfg"}


def test_loop_host_ms():
    # 80 ms a chunk less 5 ms of fetch join and 30 of monitor wait
    assert sp.loop_host_ms(DATASET, lockstep()) == pytest.approx(45.0)


def test_loop_write_ms():
    # one of the two whole chunks wrote for 20 ms
    assert sp.loop_write_ms(DATASET, lockstep()) == pytest.approx(10.0)
    no_write = [s for s in lockstep() if not s.name.startswith("loop.write")]
    assert sp.loop_write_ms(DATASET, no_write) is None


def test_loop_fetch_mbps():
    # 16 MB in 8 ms; the cut chunk's fetch is left out
    assert sp.loop_fetch_mbps(DATASET, lockstep()) == pytest.approx(2000.0)


def test_program_issue_ms():
    assert sp.program_issue_ms(DATASET, lockstep()) == pytest.approx(3.0)


def test_serial_issue_us():
    assert sp.serial_issue_us(DFG, validation()) == pytest.approx(2000.0)


def test_serial_host_us():
    # 6 ms less 2 of issue and 3 of the first read-back
    assert sp.serial_host_us(DFG, validation()) == pytest.approx(1000.0)


READERS = [sp.loop_host_ms, sp.loop_write_ms, sp.loop_fetch_mbps, sp.program_issue_ms,
           sp.serial_issue_us, sp.serial_host_us]


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_none_without_spans_or_for_another_kind(reader):
    kind = DFG if reader.__name__.startswith("serial") else DATASET
    other = DATASET if kind is DFG else DFG
    spans = validation() if kind is DFG else lockstep()
    assert reader(kind, spans) is not None
    assert reader(kind, []) is None
    assert reader(other, spans) is None
    # only cut chunks: nothing whole to read
    assert reader(kind, [s for s in spans if s.whole and s.name not in
                         ("loop.chunk", "serial.chunk")]) is None


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_read_from_the_programs_registry(reader, monkeypatch):
    from lbm2d_tpu_torch.utils import profiling

    kind = DFG if reader.__name__.startswith("serial") else DATASET
    spans = validation() if kind is DFG else lockstep()
    monkeypatch.setattr(profiling.REGISTRY, "snapshot", lambda reset=False: spans)
    assert reader(kind) == reader(kind, spans) is not None
    # a program without the registry (the parent of the spans) reads None
    monkeypatch.delattr(profiling, "REGISTRY")
    assert sp.registry_spans() is None and reader(kind) is None
