"""``device.idle.dfg`` of dfg.re100: ``readers.idle_share``."""

from lbmbench import readers


def read(record, trace):
    return readers.idle_share(record, trace, "dfg")
