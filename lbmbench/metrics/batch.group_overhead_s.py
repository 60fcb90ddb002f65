"""``batch.group_overhead_s`` of the urban cells: ``readers.group_overhead_s``."""

from lbmbench import readers


def read(record, trace):
    return readers.group_overhead_s(record)
