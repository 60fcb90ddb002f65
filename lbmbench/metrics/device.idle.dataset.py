"""``device.idle.dataset`` of the urban cells: ``readers.idle_share``."""

from lbmbench import readers


def read(record, trace):
    return readers.idle_share(record, trace, "dataset")
