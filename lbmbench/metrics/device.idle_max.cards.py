"""``device.idle_max.cards`` of urban5.case4: the idlest card's idle share
of the traced window, 1 - its own busy time (``trace_cards``) over the
window, in percent."""


def read(record, trace):
    if trace is None or record.get("kind") != "cards" or not trace.get("cards") \
            or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - min(c["busy_s"] for c in trace["cards"]) / trace["window_s"])
