"""``loop.produce_ms`` of urban5.case4: the ``loop.produce`` spans of a
whole saving chunk (each card's issue of its save producers and its
render), summed over the cards, in ms, the mean over the whole chunks that
save; None where the program records no such span."""

from lbmbench import spans as sp


def read(record, trace, spans=None):
    if record.get("kind") != "cards":
        return None
    spans = sp.registry_spans() if spans is None else spans
    if not spans:
        return None
    idx = sp.index(spans, sp.whole_chunks(spans, "loop.chunk"))
    saving = [group for (name, _), group in idx.items() if name == "loop.produce"]
    if not saving:
        return None
    return sum(sp.seconds(group) for group in saving) / len(saving) * 1e3
