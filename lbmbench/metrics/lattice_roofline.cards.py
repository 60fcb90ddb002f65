"""``lattice_roofline.cards`` of urban5.case4: on each card, the least time
for that card's traced lattice work (its cases' ``yardstick.chunk_bytes``
a traced chunk, at the chip's HBM peak) over that card's own busy time
(``trace_cards``), the mean over the cards, in percent."""

from lbmbench import yardstick


def read(record, trace):
    if trace is None or record.get("kind") != "cards" or not trace.get("cards"):
        return None
    lattice = record.get("trace_lattice_bytes_cards") or {}
    shares = []
    for card in trace["cards"]:
        least = yardstick.bound_seconds(lattice.get(card["device"], 0), record["device_kind"])
        if not least or not card["busy_s"]:
            return None
        shares.append(100.0 * least / card["busy_s"])
    return sum(shares) / len(shares)
