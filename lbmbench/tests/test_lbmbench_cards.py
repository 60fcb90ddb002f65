"""The four-card cell's pieces on the CPU: its driver at a tiny size on a
case mesh of the CPU named four times (a sound run comes out correct, a
fault in a case on a card other than the first does not, nor does the
control, the reference one precision below the configuration's), the per-card
trace reduction on synthetic intervals, and its four metric readers on
synthetic records (None where the record holds nothing to read)."""

import os

import pytest

from lbmbench import harness, trace_cards
from lbmbench.tests import tiny, tiny_cards
from lbmbench.tests.test_lbmbench_drivers import check, correct, patched
from lbmbench.tests.test_lbmbench_spans import S


def run_cards():
    cfg, wl = tiny_cards.urban_cards()
    return tiny.run("lockstep_cards", cfg, wl)


def test_cards_sound_run_is_correct():
    out = run_cards()
    assert correct(out), [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted == 20 and out.failed == 0
    assert out.e2e["dataset_mlups"] > 0 and out.setup_s > 0
    assert out.record["kind"] == "cards" and out.record["groups"][0]["cases"] == 20


def _every_fourth(make, third):
    """A maker whose product alters the output of its third call of every
    four (the parts are produced in part order: the third card's)."""
    def wrapped_make(*a, **kw):
        fn, calls = make(*a, **kw), [0]

        def call(*args):
            calls[0] += 1
            out = fn(*args)
            return third(out) if calls[0] % 4 == 3 else out
        return call
    return wrapped_make


def fault(kind):
    import torch

    from lbm2d_tpu_torch.ops import render, resize
    from lbm2d_tpu_torch.parallel.batch import BatchEngine

    if kind == "state":
        def wrap(orig):
            def run_group(self, g, n):
                out = orig(self, g, n)
                if g.idx[0] == 10:  # the third card's cases, 10-14
                    g.state.f_post.add_(0.01)
                return out
            return run_group
        return patched(BatchEngine, "_run_group", wrap)
    if kind == "frame":
        return patched(resize, "make_device_resizer",
                       lambda make: _every_fourth(make, lambda x: x * 1.01))

    def brighter(out):
        y, uv = out
        return torch.clamp(y.int() + 3, 0, 255).to(torch.uint8), uv
    return patched(render, "make_device_frame_renderer",
                   lambda make: _every_fourth(make, brighter))


@pytest.mark.parametrize("kind,name", [("state", "chunk_f_post"), ("frame", "frame_rel"),
                                       ("render", "render_off")])
def test_cards_fault_on_a_later_card_is_not_correct(kind, name):
    with fault(kind):
        out = run_cards()
    assert not correct(out) and not check(out, name).ok


def test_cards_control_fails_and_program_passes():
    from lbmbench import control

    (line,) = control.readings("urban5.case4", [2**31 + 5], 0.1, device="cpu",
                               overrides=lambda config, wl: tiny_cards.urban_cards())
    assert line["program_correct"], line
    assert not line["control_correct"], line


def test_cards_trace_splits_by_card():
    dev = {0: [(0.0, 1.0, "k1"), (0.5, 1.5, "Memcpy DtoH"), (3.0, 4.0, "k1")],
           1: [(0.0, 4.0, "k1")]}
    out = trace_cards.reduce_cards(dev, [(1.5, 3.0, "wait")], window_s=5.0, cards=[0, 1, 2])
    assert [c["busy_s"] for c in out["cards"]] == [2.5, 4.0, 0.0]
    assert out["busy_s"] == pytest.approx(6.5 / 3) and out["busy_s"] <= out["window_s"]
    assert dict((n, t) for n, t in out["device_ops"]) == {"k1": 6.0, "Memcpy DtoH": 1.0}
    # card 0's gap, 1.5 s under "wait", over three cards
    assert out["idle_gaps"] == [["wait", pytest.approx(0.5)]]
    # every card busy the whole window: the mean never passes it
    full = trace_cards.reduce_cards({0: [(0.0, 5.0, "k")], 1: [(0.0, 2.0, "k"), (1.0, 5.0, "k")]},
                                    [], window_s=5.0, cards=[0, 1])
    assert full["busy_s"] == 5.0


def reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics", f"{name}.py"),
                               "test_metric_" + name.replace(".", "_"))


CARDS = {"kind": "cards", "device_kind": "NVIDIA H100 80GB HBM3",
         "trace_lattice_bytes_cards": {0: 3.35e9, 1: 1.675e9}}
TRACE = {"busy_s": 1.5, "window_s": 4.0, "cards": [{"device": 0, "busy_s": 2.0},
                                                  {"device": 1, "busy_s": 1.0}]}


def test_card_trace_readers():
    # card 0: 1 ms of bytes in 2 s busy, card 1: 0.5 ms in 1 s
    assert reader("lattice_roofline.cards").read(CARDS, TRACE) == pytest.approx(0.05)
    assert reader("device.idle_max.cards").read(CARDS, TRACE) == pytest.approx(75.0)
    for name in ("lattice_roofline.cards", "device.idle_max.cards"):
        assert reader(name).read(CARDS, None) is None
        assert reader(name).read({"kind": "dataset"}, TRACE) is None
        assert reader(name).read(CARDS, {"busy_s": 1.0, "window_s": 4.0}) is None


def cards_chunks():
    """Two whole chunks of two cards, the second saving, then a cut one."""
    out = []
    for k, t, saves in ((2, 100, False), (3, 200, True)):
        c = ("g", k)
        out += [S("loop.chunk", t, t + 80, c), S("program.issue", t, t + 4, c),
                S("program.card", t, t + 1.5, c, device="cuda:0", cases=5),
                S("program.card", t + 1.5, t + 4, c, device="cuda:1", cases=5)]
        if saves:
            out += [S("loop.produce", t + 5, t + 7, c, device="cuda:0", bytes=10),
                    S("loop.produce", t + 7, t + 8, c, device="cuda:1", bytes=10),
                    S("loop.produce", t + 50, t + 60, c, device="cuda:0", bytes=4),
                    S("loop.produce", t + 60, t + 70, c, device="cuda:1", bytes=4)]
    c = ("g", 4)
    out += [S("loop.chunk", 300, 400, c, whole=False), S("program.card", 300, 350, c),
            S("loop.produce", 360, 390, c)]
    return out


def test_card_span_readers():
    issue, produce = reader("program.card_issue_ms"), reader("loop.produce_ms")
    assert issue.read(CARDS, None, cards_chunks()) == pytest.approx(4.0)
    # only the saving whole chunk: 2 + 1 + 10 + 10 ms
    assert produce.read(CARDS, None, cards_chunks()) == pytest.approx(23.0)
    # a program with no such span, or another cell's record: nothing to read
    parent = [s for s in cards_chunks() if s.name not in ("program.card", "loop.produce")]
    assert issue.read(CARDS, None, parent) is None and produce.read(CARDS, None, parent) is None
    assert issue.read({"kind": "dataset"}, None, cards_chunks()) is None
    assert produce.read({"kind": "dataset"}, None, cards_chunks()) is None
    assert issue.read(CARDS, None, []) is None and produce.read(CARDS, None, []) is None
