"""``program.card_issue_ms`` of urban5.case4: the ``program.card`` spans of
a whole chunk (each card's issue of its group program, inside
``program.issue``), summed over the cards, in ms; None where the program
records no such span."""

from lbmbench import spans as sp


def read(record, trace, spans=None):
    spans = sp.registry_spans() if spans is None else spans
    if not spans or not any(s.name == "program.card" for s in spans):
        return None
    return sp.per_chunk(record, "cards", "loop.chunk",
                        lambda c, idx: sp.seconds(idx[("program.card", c.chunk)]) * 1e3, spans)
