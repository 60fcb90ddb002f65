"""The device trace's reduction: busy time as the union of intervals."""

from lbmbench import trace


def test_union_counts_overlaps_once():
    # two streams overlapping, one nested, one apart
    iv = [(0.0, 2.0), (1.0, 3.0), (1.5, 1.7), (5.0, 6.0)]
    assert trace.union_seconds(iv) == 4.0
    assert sum(e - s for s, e in iv) > 4.0
    assert trace.merge(iv) == [(0.0, 3.0), (5.0, 6.0)]
    assert trace.gaps(trace.merge(iv)) == [(3.0, 5.0)]


def test_touching_and_unsorted():
    assert trace.union_seconds([(4, 5), (0, 1), (1, 2)]) == 3
    assert trace.union_seconds([]) == 0.0


def test_gaps_named_by_the_host():
    host = [(0.0, 10.0, "run_batch"), (3.2, 4.8, "aten::copy_"), (7.0, 7.5, "late")]
    named = trace.name_gaps([(3.0, 5.0), (6.0, 6.5), (11.0, 12.0)], host)
    assert named == {"aten::copy_": 2.0, "run_batch": 0.5, "host: no operation": 1.0}


def test_reduce_events():
    dev = [(0.0, 1.0, "k1"), (0.5, 1.5, "copy"), (3.0, 4.0, "k1")]
    out = trace.reduce_events(dev, [(1.5, 3.0, "wait")], window_s=5.0)
    assert out["busy_s"] == 2.5 and out["window_s"] == 5.0
    assert out["device_ops"][0] == ["k1", 2.0]
    assert out["idle_gaps"] == [["wait", 1.5]]
